"""Indexing ops (reference: ``heat/core/indexing.py``).

``nonzero`` gives global indices: each rank's local indices plus its offset
along axis 0 (an array split along a later axis is resplit to 0 first).  Indices are int32, the reference's dtype, wherever
every index fits; an index that could pass 2**31 - 1 makes them int64, so
none wraps.
"""

from __future__ import annotations

import numpy as np
import torch

from . import types
from ._operations import _localize, _narrow, _operand
from .dndarray import DNDarray

__all__ = ["flatnonzero", "mask_indices", "nonzero", "tril_indices", "triu_indices", "where"]

_INT32_MAX = 2**31 - 1


def _index_dtype(largest: int) -> torch.dtype:
    """int32 where every index up to ``largest`` fits, else int64."""
    return torch.int32 if largest <= _INT32_MAX else torch.int64


def _coords(x: DNDarray) -> torch.Tensor:
    """(nnz, ndim) int64 global coordinates of the non-zero elements of
    ``x``, in row-major order; where ``x`` is distributed, this rank's part
    of them: its local ones plus its offset along axis 0 (an ``x`` split
    along a later axis is resplit to 0 first, one Alltoall, so that the
    ranks' parts follow one another in row-major order)."""
    if x.is_distributed() and x.split != 0:
        x = x.resplit(0)
    local = torch.nonzero(x.larray)
    if x.is_distributed():
        local[:, 0] += x.counts_displs()[1][x.comm.rank]
    return local


def _wrap_indices(x: DNDarray, t: torch.Tensor, largest: int) -> DNDarray:
    """Global indices ``t`` of ``x`` (this rank's part where ``x`` is
    distributed) as a DNDarray: split 0 where ``x`` is split, the ranks'
    parts as they are; replicated otherwise."""
    t = t.to(_index_dtype(largest))
    gshape = tuple(t.shape)
    dtype = types.canonical_heat_type(t.dtype)
    if x.split is None:
        return DNDarray(t, gshape, dtype, None, x.device, x.comm, True)
    comm = x.comm
    if not x.is_distributed():
        return DNDarray(t, gshape, dtype, 0, x.device, comm, True)
    counts = comm._extents(t, 0)
    gshape = (sum(counts),) + gshape[1:]
    balanced = list(counts) == list(comm.counts_displs_shape(gshape, 0)[0])
    return DNDarray(t, gshape, dtype, 0, x.device, comm, balanced)


def nonzero(x: DNDarray) -> DNDarray:
    """Global indices of the non-zero elements of ``x``: (nnz, ndim), or
    (nnz,) for a 1-D ``x``; split 0 where ``x`` is split."""
    coords = _coords(x)
    coords = coords if x.ndim > 1 else coords.reshape(-1)
    return _wrap_indices(x, coords, max(x.gshape, default=0) - 1)


def flatnonzero(x: DNDarray) -> DNDarray:
    """Global flat (row-major) indices of the non-zero elements of ``x``."""
    coords = _coords(x)
    flat = torch.zeros(coords.shape[0], dtype=torch.int64, device=coords.device)
    for d, n in enumerate(x.gshape):
        flat = flat * n + coords[:, d]
    return _wrap_indices(x, flat, x.size - 1)


def where(cond, x=None, y=None) -> DNDarray:
    """``x`` where ``cond`` holds, else ``y`` (broadcast); with ``cond`` alone,
    :func:`nonzero`.  The result is split along the first split operand's
    axis (aligned to the result's axes), as in the reference; each rank
    selects from its chunk."""
    if x is None and y is None:
        return nonzero(cond)
    if x is None or y is None:
        raise TypeError("either both or neither of x and y should be given")
    proto = next(a for a in (cond, x, y) if isinstance(a, DNDarray))
    ops = [_operand(a, proto) for a in (cond, x, y)]
    shapes = [a.gshape if isinstance(a, DNDarray) else () for a in ops]
    gshape = tuple(np.broadcast_shapes(*shapes))
    nd = len(gshape)
    src = next((a for a in ops if isinstance(a, DNDarray) and a.split is not None), None)
    split = None if src is None else src.split + nd - src.ndim
    layout = src
    if src is not None and (src.ndim != nd or src.gshape[src.split] != gshape[split]):
        # the result's chunks along the split: the operands are moved to them
        lshape = src.comm.chunk(gshape, split)[1]
        layout = DNDarray(torch.empty(lshape, device="meta"), gshape, src.dtype, split, src.device, src.comm, True)
    c, a, b = (_localize(o, split, nd, layout) for o in ops)
    if not isinstance(c, torch.Tensor):
        c = torch.tensor(bool(c), device=proto.larray.device)
    t = _narrow(torch.where(c.to(torch.bool), a, b), a, b)
    if split is not None:
        lshape = list(gshape)
        lshape[split] = layout.lshape[split]
        t = t.broadcast_to(lshape).contiguous()
        return DNDarray(t, gshape, types.canonical_heat_type(t.dtype), split, proto.device, proto.comm,
                        layout.balanced)
    t = t.broadcast_to(gshape).contiguous()
    return DNDarray(t, gshape, types.canonical_heat_type(t.dtype), None, proto.device, proto.comm, True)


def _replicated(a: np.ndarray) -> DNDarray:
    from . import factories

    return factories.array(a.astype(np.int32))


def triu_indices(n: int, k: int = 0, m=None):
    """Row and column indices of the upper triangle of an (n, m) matrix."""
    rows, cols = np.triu_indices(n, k=k, m=n if m is None else m)
    return _replicated(rows), _replicated(cols)


def tril_indices(n: int, k: int = 0, m=None):
    """Row and column indices of the lower triangle of an (n, m) matrix."""
    rows, cols = np.tril_indices(n, k=k, m=n if m is None else m)
    return _replicated(rows), _replicated(cols)


def mask_indices(n: int, mask_func, k: int = 0):
    """Indices that ``mask_func`` (numpy's, e.g. ``np.triu``) selects over an
    (n, n) grid."""
    rows, cols = np.mask_indices(n, mask_func, k)
    return _replicated(rows), _replicated(cols)


DNDarray.nonzero = nonzero
