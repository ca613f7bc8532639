"""Dataset and DataLoader (reference: ``heat_tpu/utils/data/datatools.py``).

A ``Dataset`` holds arrays aligned on the sample axis, split along it over
the ranks.  A ``DataLoader`` iterates global batches: ``batch_size`` is
global, and batch b is rows [b·B, (b+1)·B) of the (shuffled) global sample
axis, spread over the ranks in ``chunk``'s proportions.  The loader lays
the dataset out so that each rank holds its share of every batch, in batch
order; a batch is then a slice of each rank's local rows and needs no
collective.

The shuffle draws one permutation of the sample axis from ``seed`` (a CPU
``torch.Generator``; never from the rank, so every rank draws the same)
and moves the rows with one ``Alltoall`` an epoch: every array's row
bytes travel together.  ``ishuffle`` starts that exchange asynchronously
and the next epoch finishes it.  The permutation is the port's own draw,
not the JAX package's: at one seed the batches are the same at any world
size, and differ from the reference's.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

from ...core import random as ht_random
from ...core.dndarray import DNDarray

__all__ = ["Dataset", "DataLoader", "dataset_shuffle", "dataset_ishuffle"]


class Dataset:
    """One or more DNDarrays aligned on the sample axis (split 0, or
    replicated), and the order and layout of their rows.

    ``order[g]`` is the original row at position g of the current global
    order; ``batch_size`` None lays the rows out in ``chunk``'s blocks (the
    arrays as given), else each rank holds its share of every batch of
    that size.  ``arrays`` gives the arrays in the current order, split 0."""

    def __init__(self, array: Union[DNDarray, Sequence[DNDarray]], labels: Optional[DNDarray] = None,
                 ishuffle: bool = False, test_set: bool = False):
        arrays = [array] if isinstance(array, DNDarray) else list(array)
        if labels is not None:
            arrays.append(labels)
        n = arrays[0].shape[0]
        for a in arrays[1:]:
            if a.shape[0] != n:
                raise ValueError("all arrays must share the sample axis length")
        self.comm = arrays[0].comm
        self._like = arrays
        counts = self.comm.counts_displs_shape((n,), 0)[0]
        self._local = []
        for a in arrays:
            if a.split not in (0, None):
                raise ValueError(f"a Dataset's arrays are split along the sample axis (0) or not at all, got {a.split}")
            if a.split is None:
                self._local.append(a.larray[self.comm.chunk((n,), 0)[2]])
            else:  # into chunk's blocks, where the array is not balanced
                self._local.append(self.comm.redistribute(a.larray, 0, [int(c) for c in a.lshape_map()[:, 0]],
                                                          counts))
        self.has_labels = labels is not None
        self.ishuffle = ishuffle
        self.test_set = test_set
        self.order = np.arange(n)
        self.batch_size: Optional[int] = None
        self._pending = None  # an exchange in flight: (request, order, batch_size, receive plan)

    def __len__(self) -> int:
        return self._like[0].shape[0]

    # -- layout --------------------------------------------------------- #
    def _counts(self, batch_size: Optional[int]) -> np.ndarray:
        """(ranks, batches) rows each rank holds of each batch (one column,
        the whole axis, without a batch size)."""
        n, p = len(self), self.comm.size
        sizes = [n] if batch_size is None else [min(batch_size, n - lo) for lo in range(0, n, batch_size)]
        return np.array([[self.comm.chunk((s,), 0, r)[1][0] for s in sizes] for r in range(p)], dtype=np.int64)

    def _ranks_of(self, batch_size: Optional[int]) -> np.ndarray:
        """The rank holding each global position, and its index there, under a layout."""
        counts = self._counts(batch_size)
        n, p = len(self), self.comm.size
        rank, index = np.empty(n, dtype=np.int64), np.empty(n, dtype=np.int64)
        local = np.zeros(p, dtype=np.int64)
        pos = 0
        for b in range(counts.shape[1]):
            for r in range(p):
                c = counts[r, b]
                rank[pos: pos + c] = r
                index[pos: pos + c] = np.arange(local[r], local[r] + c)
                local[r] += c
                pos += c
        return rank, index

    def _start(self, order: np.ndarray, batch_size: Optional[int]):
        """Begin moving the rows to ``order`` laid out for ``batch_size``:
        one exchange of every array's row bytes (asynchronous)."""
        comm = self.comm
        if comm.size == 1:
            return None, order, batch_size, None
        src_rank, src_index = self._ranks_of(self.batch_size)
        dst_rank, _ = self._ranks_of(batch_size)
        # where the original row at each current position sits now
        where = np.empty(len(self), dtype=np.int64)
        where[self.order] = np.arange(len(self))
        holder = where[order]  # current position of the row that new position g takes
        me = comm.rank
        mine = np.flatnonzero(src_rank[holder] == me)  # new positions this rank sends
        send = mine[np.argsort(dst_rank[mine], kind="stable")]
        send_counts = np.bincount(dst_rank[send], minlength=comm.size)
        take = torch.from_numpy(src_index[holder[send]])
        widths = [x.element_size() * int(np.prod(x.shape[1:], dtype=np.int64)) for x in self._local]
        rows = torch.cat([x.index_select(0, take.to(x.device)).contiguous().view(torch.uint8).reshape(len(send), w)
                          for x, w in zip(self._local, widths)], dim=1)
        row_bytes = sum(widths)
        arrive = np.flatnonzero(dst_rank == me)  # new positions this rank receives, in order
        srcs = src_rank[holder[arrive]]
        recv_counts = np.bincount(srcs, minlength=comm.size)
        # arrivals come grouped by source rank, each group in position order
        place = torch.from_numpy(np.argsort(np.argsort(srcs, kind="stable"), kind="stable"))
        recv = rows.new_empty((int(recv_counts.sum()), row_bytes))
        req = comm._ialltoall_rows(rows, recv, send_counts.tolist(), recv_counts.tolist())
        return req, order, batch_size, (place, widths)

    def _finish(self, pending) -> None:
        req, order, batch_size, plan = pending
        if req is not None:
            recv = req.wait()
            place, widths = plan
            recv = recv.index_select(0, place.to(recv.device))
            parts = torch.split(recv, widths, dim=1)
            self._local = [part.contiguous().view(x.dtype).reshape((-1,) + tuple(x.shape[1:]))
                           for part, x in zip(parts, self._local)]
        else:
            # one rank: the new order is a gather of the old rows
            where = np.empty(len(self), dtype=np.int64)
            where[self.order] = np.arange(len(self))
            take = torch.from_numpy(where[order])
            self._local = [x.index_select(0, take.to(x.device)) for x in self._local]
        self.order, self.batch_size = order, batch_size

    def _relayout(self, order: np.ndarray, batch_size: Optional[int]) -> None:
        self.ishuffle_finish()
        if batch_size == self.batch_size and np.array_equal(order, self.order):
            return
        self._finish(self._start(order, batch_size))

    # -- the reference's surface ---------------------------------------- #
    @property
    def arrays(self):
        """The arrays in the current global order, split 0 in ``chunk``'s blocks."""
        self._relayout(self.order, None)
        n = len(self)
        return [DNDarray(x, (n,) + tuple(x.shape[1:]), x.dtype, 0, a.device, self.comm, True)
                for x, a in zip(self._local, self._like)]

    def __getitem__(self, idx):
        items = [a[idx] for a in self.arrays]
        return items[0] if len(items) == 1 else tuple(items)

    def _permutation(self, seed: Optional[int]) -> np.ndarray:
        """One permutation of the sample axis from ``seed``: the same on every rank."""
        if seed is None:
            seed = ht_random.get_state()[1]  # rank 0's seed on every rank after bring-up
        g = torch.Generator().manual_seed(int(seed))
        return torch.randperm(len(self), generator=g).numpy()

    def shuffle(self, seed: Optional[int] = None) -> None:
        """Permute the global sample axis (one Alltoall), keeping the layout."""
        self.ishuffle_finish()
        self._finish(self._start(self.order[self._permutation(seed)], self.batch_size))

    def ishuffle_start(self, seed: Optional[int] = None) -> None:
        """Start :meth:`shuffle`'s exchange without waiting."""
        self.ishuffle_finish()
        self._pending = self._start(self.order[self._permutation(seed)], self.batch_size)

    def ishuffle_finish(self) -> None:
        if self._pending is not None:
            pending, self._pending = self._pending, None
            self._finish(pending)

    def _batch(self, b: int):
        """Batch b of the batch layout: DNDarrays split 0 over this rank's rows of it."""
        counts = self._counts(self.batch_size)
        r = self.comm.rank
        lo, c = int(counts[r, :b].sum()), int(counts[r, b])
        rows = int(counts[:, b].sum())
        items = [DNDarray(x[lo: lo + c], (rows,) + tuple(x.shape[1:]), x.dtype, 0, a.device, self.comm, True)
                 for x, a in zip(self._local, self._like)]
        return items[0] if len(items) == 1 else tuple(items)


def dataset_shuffle(dataset: Dataset, attrs=None) -> None:
    """The reference's free function: :meth:`Dataset.shuffle`."""
    dataset.shuffle()


def dataset_ishuffle(dataset: Dataset, attrs=None) -> None:
    dataset.ishuffle_start()


class DataLoader:
    """Iterate the global batches of a Dataset (or a DNDarray): each a
    DNDarray (a tuple with labels) split 0, this rank holding its
    ``chunk`` of the batch.  ``shuffle=True`` permutes the dataset each
    epoch from seed = the epoch; ``ishuffle`` (or the dataset's flag)
    starts the next epoch's exchange during the last batch."""

    def __init__(self, dataset=None, batch_size: int = 1, shuffle: bool = False, drop_last: bool = False,
                 ishuffle: bool = False, lcl_dataset=None):
        if dataset is None:
            dataset = lcl_dataset
        if isinstance(dataset, DNDarray):
            dataset = Dataset(dataset)
        if dataset is None:
            raise ValueError("DataLoader requires a dataset")
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.ishuffle = ishuffle or getattr(dataset, "ishuffle", False)
        self.drop_last = drop_last
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self):
        ds = self.dataset
        if self.shuffle and self.ishuffle and ds._pending is not None and ds._pending[2] == self.batch_size:
            ds.ishuffle_finish()
        else:
            ds.ishuffle_finish()
            order = ds.order[ds._permutation(self._epoch)] if self.shuffle else ds.order
            ds._relayout(order, self.batch_size)
        nb = len(self)
        for b in range(nb):
            if self.ishuffle and self.shuffle and b == nb - 1:
                # the next epoch's exchange overlaps the last batch
                ds._pending = ds._start(ds.order[ds._permutation(self._epoch + 1)], self.batch_size)
            yield ds._batch(b)
        self._epoch += 1
