"""The distributed N-D array (reference: ``heat/core/dndarray.py``).

A :class:`DNDarray` holds this process's LOCAL ``torch.Tensor`` together
with the global shape, the split axis, the device and the communicator.
With ``split=None`` every process holds the whole array; with ``split=k``
process ``r`` holds the ``comm.chunk(gshape, k, r)`` slice of axis ``k``.
An array made by slicing a split array may be unbalanced
(``balanced=False``): its ranks' extents then come from the ranks, not from
``chunk``.  ``redistribute_`` moves rows to any chunk map, ``balance_`` to
``chunk``'s, and ``resplit_`` to another split axis (by the communicator's
Alltoall), in place.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from . import types
from .communication import Communication
from .devices import Device
from .stride_tricks import sanitize_axis

__all__ = ["DNDarray"]


class DNDarray:
    """Distributed N-D array: a local tensor plus its global metadata."""

    def __init__(
        self,
        array: torch.Tensor,
        gshape: Tuple[int, ...],
        dtype,
        split: Optional[int],
        device: Device,
        comm: Communication,
        balanced: bool = True,
    ):
        self.__array = array
        self.__gshape = tuple(int(s) for s in gshape)
        self.__dtype = types.canonical_heat_type(dtype)
        self.__split = split
        self.__device = device
        self.__comm = comm
        self.__balanced = balanced

    # ------------------------------------------------------------------ #
    # metadata
    # ------------------------------------------------------------------ #
    @property
    def larray(self) -> torch.Tensor:
        """This process's local tensor."""
        return self.__array

    @property
    def gshape(self) -> Tuple[int, ...]:
        return self.__gshape

    @property
    def shape(self) -> Tuple[int, ...]:
        return self.__gshape

    @property
    def lshape(self) -> Tuple[int, ...]:
        return tuple(self.__array.shape)

    @property
    def ndim(self) -> int:
        return len(self.__gshape)

    @property
    def size(self) -> int:
        return int(np.prod(self.__gshape, dtype=np.int64))

    @property
    def split(self) -> Optional[int]:
        return self.__split

    @property
    def dtype(self):
        return self.__dtype

    @property
    def device(self) -> Device:
        return self.__device

    @property
    def comm(self) -> Communication:
        return self.__comm

    @property
    def balanced(self) -> bool:
        return self.__balanced

    def is_distributed(self) -> bool:
        return self.__split is not None and self.__comm.is_distributed()

    def counts_displs(self) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
        """Every rank's extent and offset along the split axis."""
        if self.__split is None:
            raise ValueError("a non-split array has no counts/displacements")
        if self.__balanced:
            return self.__comm.counts_displs_shape(self.__gshape, self.__split)
        local = torch.tensor([self.lshape[self.__split]], dtype=torch.int64, device=self.__array.device)
        counts = tuple(int(c.item()) for c in self.__comm.Allgather(local))
        displs = tuple(int(d) for d in np.concatenate([[0], np.cumsum(counts)[:-1]]))
        return counts, displs

    @property
    def lshape_map(self) -> np.ndarray:
        """(size, ndim) array of every rank's local shape."""
        if self.__split is None or self.__balanced:
            return self.__comm.lshape_map(self.__gshape, self.__split)
        counts, _ = self.counts_displs()
        out = np.tile(np.asarray(self.__gshape, dtype=np.int64), (len(counts), 1))
        out[:, self.__split] = counts
        return out

    # ------------------------------------------------------------------ #
    # conversion
    # ------------------------------------------------------------------ #
    def numpy(self) -> np.ndarray:
        """The GLOBAL array as numpy, gathered to every process.

        bfloat16 is returned as float32 (numpy has no bfloat16)."""
        t = self.__array
        if self.is_distributed():
            t = self.__comm.Allgatherv(t, self.__split)
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()

    def __array__(self, dtype=None, copy=None) -> np.ndarray:
        a = self.numpy()
        return a.astype(dtype) if dtype is not None else a

    def astype(self, dtype, copy: bool = True) -> "DNDarray":
        """This array cast to ``dtype`` (same split, device and communicator):
        a copy, or with ``copy=False`` this array, its local tensor replaced."""
        dtype = types.canonical_heat_type(dtype)
        t = self.__array.to(dtype.torch_type(), copy=copy)
        if copy:
            return DNDarray(t, self.__gshape, dtype, self.__split, self.__device, self.__comm, self.__balanced)
        self.__array, self.__dtype = t, dtype
        return self

    def tolist(self, keepsplit: bool = False) -> List:
        """The global array as nested Python lists."""
        return self.numpy().tolist()

    def item(self):
        """The one element of a one-element array, as a Python scalar."""
        if self.size != 1:
            raise ValueError("only one-element DNDarrays can be converted to scalars")
        t = self.__array if not self.is_distributed() else torch.from_numpy(self.numpy())
        return t.reshape(()).item()

    def __bool__(self) -> bool:
        return bool(self.item())

    def __int__(self) -> int:
        return int(self.item())

    def __float__(self) -> float:
        return float(self.item())

    def __complex__(self) -> complex:
        return complex(self.item())

    def __index__(self) -> int:
        if not issubclass(self.__dtype, (types.integer, types.bool)):
            raise TypeError("only integer scalar arrays can be used as an index")
        return int(self.item())

    @property
    def T(self) -> "DNDarray":
        """The transpose (all axes reversed)."""
        from ..linalg import basics

        return basics.transpose(self)

    def __len__(self) -> int:
        if self.ndim == 0:
            raise TypeError("len() of unsized object")
        return self.__gshape[0]

    def __repr__(self) -> str:
        return (
            f"DNDarray(gshape={self.__gshape}, dtype=ht.{self.__dtype.__name__}, "
            f"split={self.__split}, device={self.__device}, lshape={self.lshape})"
        )

    # ------------------------------------------------------------------ #
    # distribution
    # ------------------------------------------------------------------ #
    def is_balanced(self, force_check: bool = False) -> bool:
        """HeAT's criterion: the ranks' extents along the split axis differ by
        at most 1.  A ``chunk`` layout always passes; otherwise (or with
        ``force_check``) the ranks' extents are gathered."""
        if not self.is_distributed():
            return True
        if self.__balanced and not force_check:
            return True
        counts = self.__comm._extents(self.__array, self.__split)
        return max(counts) - min(counts) <= 1

    def balance_(self) -> None:
        """Redistribute in place to ``chunk``'s layout (the first n % size
        ranks one row more), which every factory makes."""
        if self.is_distributed() and not self.__balanced:
            self.redistribute_(target_map=self.__comm.lshape_map(self.__gshape, self.__split))

    def redistribute_(self, lshape_map=None, target_map=None) -> None:
        """Move rows along the split axis, in place, from the layout
        ``lshape_map`` (every rank's local shape; gathered when not given) to
        ``target_map`` (``chunk``'s when not given): each rank sends the rows
        of its range that fall in another rank's target range."""
        if self.__split is None:
            return
        split = self.__split
        counts = self.counts_displs()[0] if lshape_map is None else [int(c) for c in np.asarray(lshape_map)[:, split]]
        chunk = self.__comm.lshape_map(self.__gshape, split)
        target = chunk if target_map is None else np.asarray(target_map)
        target = [int(c) for c in target[:, split]]
        self.__array = self.__comm.redistribute(self.__array, split, counts, target)
        self.__balanced = target == [int(c) for c in chunk[:, split]]

    def _resplit_tensor(self, axis: Optional[int]) -> torch.Tensor:
        counts = None if self.__balanced or self.__split is None else self.counts_displs()[0]
        return self.__comm.resplit(self.__array, self.__gshape, self.__split, axis, counts)

    def resplit_(self, axis: Optional[int] = None) -> "DNDarray":
        """Redistribute in place to split axis ``axis`` (None: every rank the
        whole array): split to split by one Alltoall, split to None by an
        Allgatherv, None to split by a local slice.  The result takes
        ``chunk``'s layout."""
        axis = sanitize_axis(self.__gshape, axis)
        if axis == self.__split:
            return self
        self.__array = self._resplit_tensor(axis)
        self.__split, self.__balanced = axis, True
        return self

    def resplit(self, axis: Optional[int] = None) -> "DNDarray":
        """A copy of this array split along ``axis`` (see :meth:`resplit_`)."""
        axis = sanitize_axis(self.__gshape, axis)
        if axis == self.__split:
            return DNDarray(self.__array.clone(), self.__gshape, self.__dtype, axis, self.__device, self.__comm,
                            self.__balanced)
        t = self._resplit_tensor(axis)
        if t is self.__array:
            t = t.clone()
        return DNDarray(t, self.__gshape, self.__dtype, axis, self.__device, self.__comm, True)

    # ------------------------------------------------------------------ #
    # indexing along axis 0
    # ------------------------------------------------------------------ #
    def _gather_rows(self, idx: torch.Tensor) -> torch.Tensor:
        """Global rows ``idx`` (int64, on this array's torch device) on every rank."""
        t = self.__array
        if not self.is_distributed() or self.__split != 0:
            return t[idx]
        counts, displs = self.counts_displs()
        off, cnt = displs[self.__comm.rank], counts[self.__comm.rank]
        mine = (idx >= off) & (idx < off + cnt)
        # every row has exactly one owner: the others add zeros
        out = t.new_zeros((idx.shape[0],) + tuple(t.shape[1:]))
        out[mine] = t[idx[mine] - off]
        return self.__comm.Allreduce(out)

    def _bool_mask(self, key) -> Optional[torch.Tensor]:
        """This rank's part of the boolean index ``key`` (a numpy array, list,
        ``torch.Tensor`` or DNDarray of bools) over the leading axes: the
        rows of this rank's chunk along a split axis 0, else the whole mask;
        None where ``key`` is not boolean."""
        key = np.asarray(key) if isinstance(key, list) else key
        if isinstance(key, DNDarray):
            boolean = key.dtype is types.bool
        elif isinstance(key, torch.Tensor):
            boolean = key.dtype == torch.bool
        else:
            boolean = isinstance(key, np.ndarray) and key.dtype == np.bool_
        if not boolean:
            return None
        shape = tuple(key.shape)
        if len(shape) == 0 or shape != self.__gshape[: len(shape)]:
            raise IndexError(f"boolean index of shape {shape} does not match the indexed array's {self.__gshape}")
        tdev = self.__array.device
        local = self.is_distributed() and self.__split == 0
        if isinstance(key, DNDarray):
            if local:
                mask = key if key.split == 0 else key.resplit(0)
                counts, mine = mask.counts_displs()[0], self.counts_displs()[0]
                return self.__comm.redistribute(mask.larray, 0, counts, mine).to(tdev)
            return (key.resplit(None) if key.is_distributed() else key).larray.to(tdev)
        mask = torch.as_tensor(key, device=tdev)
        if local:
            counts, displs = self.counts_displs()
            rank = self.__comm.rank
            mask = mask[displs[rank] : displs[rank] + counts[rank]]
        return mask

    def _masked(self, mask: torch.Tensor, rest) -> "DNDarray":
        """The elements where ``mask`` (from :meth:`_bool_mask`) is True, as
        the JAX package selects them (``_result_split_of_key``): split 0 stays
        split 0, its ranks selecting from their own rows (an unbalanced
        result whose length is the sum of the ranks' counts); a split axis
        behind the mask's axes shifts to follow them; a split axis under the
        mask is gathered first."""
        nd, split = mask.ndim, self.__split
        if split is not None and 0 < split < nd and self.is_distributed():
            return self.resplit(None)._masked(mask, rest)
        t = self.__array[mask]
        t = t[(slice(None),) + rest] if rest else t
        tail = tuple(t.shape[1:])
        if split is None or (0 < split < nd):
            return DNDarray(t, (t.shape[0],) + tail, self.__dtype, None, self.__device, self.__comm, True)
        if split > 0:  # behind the mask: the rows are local, the split axis moves
            gshape = (t.shape[0],) + self.__gshape[nd:]
            return DNDarray(t, gshape, self.__dtype, split - nd + 1, self.__device, self.__comm, self.__balanced)
        if not self.is_distributed():
            return DNDarray(t, (t.shape[0],) + tail, self.__dtype, 0, self.__device, self.__comm, True)
        counts = self.__comm._extents(t, 0)
        gshape = (sum(counts),) + tail
        chunk = self.__comm.counts_displs_shape(gshape, 0)[0]
        return DNDarray(t, gshape, self.__dtype, 0, self.__device, self.__comm, list(counts) == list(chunk))

    def __getitem__(self, key) -> "DNDarray":
        """Rows along axis 0: an int, a slice, a 1-D sequence of indices or a
        boolean mask over the leading axes (numpy, list, ``torch.Tensor`` or
        DNDarray), optionally followed by indices of the trailing axes."""
        rest = ()
        if isinstance(key, tuple):
            key, rest = key[0], key[1:]
            if self.__split not in (None, 0) and rest:
                raise NotImplementedError("indexing trailing axes of an array split along axis > 0 is not ported yet")
        mask = self._bool_mask(key)
        if mask is not None:
            return self._masked(mask, rest)
        n = self.__gshape[0]
        tdev = self.__array.device
        if isinstance(key, slice):
            start, stop, step = key.indices(n)
            if step != 1:
                raise NotImplementedError("strided row slices are not ported yet")
            stop = max(stop, start)
            if self.is_distributed() and self.__split == 0:
                counts, displs = self.counts_displs()
                off, cnt = displs[self.__comm.rank], counts[self.__comm.rank]
                lo, hi = min(max(start - off, 0), cnt), min(max(stop - off, 0), cnt)
                local = self.__array[lo:hi]
                balanced = False
            else:
                local = self.__array[start:stop]
                balanced = self.__balanced
            local = local[(slice(None),) + rest] if rest else local
            gshape = (stop - start,) + tuple(local.shape[1:])
            if self.__split not in (None, 0):
                gshape = gshape[: self.__split] + (self.__gshape[self.__split],) + gshape[self.__split + 1 :]
            return DNDarray(local, gshape, self.__dtype, self.__split, self.__device, self.__comm, balanced)
        scalar = isinstance(key, (int, np.integer))
        idx = torch.as_tensor(np.atleast_1d(np.asarray(key, dtype=np.int64)), device=tdev)
        if idx.ndim != 1:
            raise NotImplementedError("only 1-D row index sequences are ported")
        if bool(((idx < -n) | (idx >= n)).any()):
            raise IndexError(f"row index out of range for axis 0 of size {n}")
        idx = torch.where(idx < 0, idx + n, idx)
        rows = self._gather_rows(idx)
        rows = rows[(slice(None),) + rest] if rest else rows
        if scalar:
            rows = rows[0]
        if self.__split in (None, 0):
            return DNDarray(rows, tuple(rows.shape), self.__dtype, None, self.__device, self.__comm, True)
        # split along a trailing axis: the rows are local, the columns stay split
        gshape = (() if scalar else (idx.shape[0],)) + self.__gshape[1:]
        split = self.__split - 1 if scalar else self.__split
        return DNDarray(rows, gshape, self.__dtype, split, self.__device, self.__comm, self.__balanced)
