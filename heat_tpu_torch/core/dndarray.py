"""The distributed N-D array (reference: ``heat/core/dndarray.py``).

A :class:`DNDarray` holds this process's LOCAL ``torch.Tensor`` together
with the global shape, the split axis, the device and the communicator.
With ``split=None`` every process holds the whole array; with ``split=k``
process ``r`` holds the ``comm.chunk(gshape, k, r)`` slice of axis ``k``.
An array made by slicing a split array may be unbalanced
(``balanced=False``): its ranks' extents then come from the ranks, not from
``chunk``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from . import types
from .communication import Communication
from .devices import Device

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

    def astype(self, dtype) -> "DNDarray":
        """A copy of this array cast to ``dtype`` (same split, device and communicator)."""
        dtype = types.canonical_heat_type(dtype)
        t = self.__array.to(dtype.torch_type(), copy=True)
        return DNDarray(t, self.__gshape, dtype, self.__split, self.__device, self.__comm, self.__balanced)

    def __len__(self) -> int:
        return self.__gshape[0]

    def __repr__(self) -> str:
        return (
            f"DNDarray(gshape={self.__gshape}, dtype=ht.{self.__dtype.__name__}, "
            f"split={self.__split}, device={self.__device}, lshape={self.lshape})"
        )

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

    def __getitem__(self, key) -> "DNDarray":
        """Rows along axis 0: an int, a slice, or a 1-D sequence of indices,
        optionally followed by indices of the trailing axes."""
        rest = ()
        if isinstance(key, tuple):
            key, rest = key[0], key[1:]
            if self.__split not in (None, 0) and rest:
                raise NotImplementedError("indexing trailing axes of an array split along axis > 0 is not ported yet")
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
