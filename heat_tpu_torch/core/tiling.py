"""Tile views over distributed arrays (reference: ``heat_tpu/core/tiling.py``).

``SplitTiles`` and ``SquareDiagTiles`` are index algebra over the ranks'
counts and displacements: a tile is a block of rows and columns of the
global array.  Reading a tile gives the block whole on every rank (each rank
contributes the part of it that it holds along the split axis, by one
``Allgatherv``); writing one writes each rank's part into its local tensor.
``SquareDiagTiles`` drives the blocked triangular substitution of
``linalg.solve_triangular``.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from .dndarray import DNDarray

__all__ = ["SplitTiles", "SquareDiagTiles"]


def _overlaps(lo: int, hi: int, counts, displs) -> List[int]:
    """Each rank's share of the range [lo, hi) of the split axis."""
    return [max(0, min(hi, d + c) - max(lo, d)) for c, d in zip(counts, displs)]


def _local_slices(arr: DNDarray, slices: Tuple[slice, ...]):
    """This rank's part of the global block ``slices``: its local slices, the
    offset of its part within the block along the split axis, and every
    rank's share of the block there (None where ``arr`` is not distributed)."""
    if not arr.is_distributed():
        return slices, 0, None
    s = arr.split
    counts, displs = arr.counts_displs()
    r = arr.comm.rank
    lo, hi = slices[s].start, slices[s].stop
    shares = _overlaps(lo, hi, counts, displs)
    start = max(lo, displs[r]) - displs[r] if shares[r] else 0
    local = list(slices)
    local[s] = slice(start, start + shares[r])
    return tuple(local), max(lo, displs[r]) - lo if shares[r] else 0, shares


def _read_block(arr: DNDarray, slices: Tuple[slice, ...]) -> torch.Tensor:
    """The global block ``arr[slices]`` on every rank."""
    local, _, shares = _local_slices(arr, slices)
    piece = arr.larray[local]
    if shares is None:
        return piece
    return arr.comm.Allgatherv(piece.contiguous(), arr.split, counts=shares)


def _write_block(arr: DNDarray, slices: Tuple[slice, ...], value) -> None:
    """Write the global block ``value`` (broadcast to the block's shape) into
    ``arr[slices]``: each rank its own part, in place."""
    t = arr.larray
    if isinstance(value, DNDarray):
        value = (value.resplit(None) if value.is_distributed() else value).larray
    shape = tuple(s.stop - s.start for s in slices)
    v = torch.as_tensor(value, device=t.device).to(t.dtype).broadcast_to(shape)
    local, offset, shares = _local_slices(arr, slices)
    if shares is not None:
        v = v.narrow(arr.split, offset, shares[arr.comm.rank])
    t[local] = v


class SplitTiles:
    """One tile per rank along every axis (reference semantics): along each
    axis HeAT's chunks of its extent, along a distributed split axis the
    ranks' own extents, so that tile ``r`` there is rank ``r``'s chunk."""

    def __init__(self, arr: DNDarray):
        self.__arr = arr
        comm = arr.comm
        sizes = []
        for dim in range(arr.ndim):
            if dim == arr.split and arr.is_distributed():
                counts = arr.counts_displs()[0]
            else:
                counts = comm.counts_displs_shape(arr.gshape, dim)[0]
            sizes.append(np.asarray(counts, dtype=np.int64))
        self.__tile_dims = sizes
        self.__tile_ends = [np.cumsum(s) for s in sizes]

    @property
    def arr(self) -> DNDarray:
        return self.__arr

    @property
    def tile_dimensions(self):
        """Per-axis tile edge lengths (a list of per-rank sizes)."""
        return self.__tile_dims

    @property
    def tile_locations(self) -> np.ndarray:
        """Which rank holds each tile (0 everywhere for a replicated array)."""
        comm = self.__arr.comm
        split = self.__arr.split
        shape = tuple(comm.size for _ in self.__arr.gshape)
        locs = np.zeros(shape, dtype=np.int64)
        if split is not None:
            expand = [1] * len(shape)
            expand[split] = comm.size
            locs[...] = np.arange(comm.size).reshape(expand)
        return locs

    def _slices(self, key) -> Tuple[slice, ...]:
        key_t = key if isinstance(key, tuple) else (key,)
        slices = []
        for dim in range(self.__arr.ndim):
            ends = self.__tile_ends[dim]
            starts = np.concatenate([[0], ends[:-1]])
            k = key_t[dim] if dim < len(key_t) else None
            if k is None or (isinstance(k, slice) and k == slice(None)):
                slices.append(slice(0, int(ends[-1])))
            elif isinstance(k, slice):
                slices.append(slice(int(starts[k.start or 0]), int(ends[(k.stop or len(ends)) - 1])))
            else:
                slices.append(slice(int(starts[int(k)]), int(ends[int(k)])))
        return tuple(slices)

    def __getitem__(self, key) -> torch.Tensor:
        return _read_block(self.__arr, self._slices(key))

    def __setitem__(self, key, value) -> None:
        _write_block(self.__arr, self._slices(key), value)


class SquareDiagTiles:
    """Square tiles along the diagonal (reference: blocked QR infrastructure).

    ``tiles_per_proc`` square blocks per rank along the diagonal (at most
    min(m, n)); rows past the square part form one more tile row, columns
    past it one more tile column.  Exposes the row and column decomposition
    indices and tile get/set by (row, col)."""

    def __init__(self, arr: DNDarray, tiles_per_proc: int = 2):
        if arr.ndim != 2:
            raise ValueError("SquareDiagTiles requires a 2-D array")
        if tiles_per_proc < 1:
            raise ValueError("tiles_per_proc must be >= 1")
        self.__arr = arr
        m, n = arr.gshape
        ntiles = max(1, min(arr.comm.size * tiles_per_proc, min(m, n)))
        base = min(m, n) // ntiles
        row_per = np.full(ntiles, base, dtype=np.int64)
        row_per[: min(m, n) - base * ntiles] += 1
        rows = list(row_per)
        if m > n:
            rows = [r for r in rows + [m - int(np.sum(row_per))] if r > 0]
        cols = list(row_per)
        if n > m:
            cols = [c for c in cols + [n - int(np.sum(row_per))] if c > 0]
        self.__row_per_proc_list = rows
        self.__col_per_proc_list = cols
        self.__row_ends = np.cumsum(rows)
        self.__col_ends = np.cumsum(cols)

    @property
    def arr(self) -> DNDarray:
        return self.__arr

    @property
    def tile_rows(self) -> int:
        return len(self.__row_per_proc_list)

    @property
    def tile_columns(self) -> int:
        return len(self.__col_per_proc_list)

    @property
    def row_indices(self):
        return [0] + [int(e) for e in self.__row_ends[:-1]]

    @property
    def col_indices(self):
        return [0] + [int(e) for e in self.__col_ends[:-1]]

    def _slice(self, row: int, col: int) -> Tuple[slice, slice]:
        rs = 0 if row == 0 else int(self.__row_ends[row - 1])
        cs = 0 if col == 0 else int(self.__col_ends[col - 1])
        return slice(rs, int(self.__row_ends[row])), slice(cs, int(self.__col_ends[col]))

    def __getitem__(self, key) -> torch.Tensor:
        return _read_block(self.__arr, self._slice(*key))

    def __setitem__(self, key, value) -> None:
        _write_block(self.__arr, self._slice(*key), value)
