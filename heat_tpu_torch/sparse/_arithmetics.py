"""Sparse element-wise operations (reference: ``heat/sparse/arithmetics.py``).

Each rank combines its own rows: a sum of two matrices has the union of
their patterns (an entry that cancels stays stored, as in the reference's
duplicate sum), a product the intersection.
"""

from __future__ import annotations

import torch

from ..core import types
from .dcsr_matrix import DCSR_matrix

__all__ = ["add", "mul", "sub", "negative"]


def _rows_like(t2: DCSR_matrix, t1: DCSR_matrix) -> torch.Tensor:
    """t2's rows that go with t1's local rows."""
    if t1.is_distributed() == t2.is_distributed():
        return t2.larray
    from .factories import _csr_rows
    from .manipulations import _gather_csr

    whole = _gather_csr(t2) if t2.is_distributed() else t2.larray
    if not t1.is_distributed():
        return whole
    from .manipulations import _row_range

    lo, hi = _row_range(t1)
    return _csr_rows(whole, lo, hi)


def _combine(t1: DCSR_matrix, t2: DCSR_matrix, op) -> DCSR_matrix:
    if not isinstance(t1, DCSR_matrix) or not isinstance(t2, DCSR_matrix):
        raise TypeError("sparse binary ops require DCSR_matrix operands")
    if t1.shape != t2.shape:
        raise ValueError(f"shapes {t1.shape} and {t2.shape} do not match")
    dt = types.promote_types(t1.dtype, t2.dtype).torch_type()
    a = t1.larray.to(dt).to_sparse_coo().coalesce()
    b = _rows_like(t2, t1).to(dt).to_sparse_coo().coalesce()
    res = op(a, b).coalesce().to_sparse_csr()
    return _finish(res, t1)


def _finish(res: torch.Tensor, proto: DCSR_matrix) -> DCSR_matrix:
    lnnz = torch.tensor([res.values().numel()], dtype=torch.int64)
    gnnz = lnnz
    if proto.is_distributed():
        gnnz = proto.comm.Allreduce(lnnz.to(proto.comm._scratch_device())).cpu()
    return DCSR_matrix(res, int(gnnz.item()), proto.shape, types.canonical_heat_type(res.dtype), proto.split,
                       proto.device, proto.comm, proto.balanced)


def add(t1: DCSR_matrix, t2: DCSR_matrix) -> DCSR_matrix:
    """Element-wise sparse + sparse."""
    return _combine(t1, t2, torch.add)


def _scale(t: DCSR_matrix, s) -> DCSR_matrix:
    """A scalar multiple: the stored values scaled, the pattern kept."""
    if isinstance(s, torch.Tensor) and s.ndim != 0 or not isinstance(s, (int, float, complex, bool, torch.Tensor)):
        raise TypeError(f"sparse ops accept DCSR_matrix or scalar operands, got {type(s).__name__}")
    a = t.larray
    vals = a.values() * s
    res = torch.sparse_csr_tensor(a.crow_indices(), a.col_indices(), vals, size=a.shape)
    return DCSR_matrix(res, t.gnnz, t.shape, types.canonical_heat_type(vals.dtype), t.split, t.device, t.comm,
                       t.balanced)


def mul(t1: DCSR_matrix, t2) -> DCSR_matrix:
    """Element-wise sparse * sparse (the intersection of the patterns) or sparse * scalar."""
    if not isinstance(t2, DCSR_matrix):
        return _scale(t1, t2)
    return _combine(t1, t2, torch.mul)


def negative(t: DCSR_matrix) -> DCSR_matrix:
    return _scale(t, -1)


def sub(t1: DCSR_matrix, t2: DCSR_matrix) -> DCSR_matrix:
    """Element-wise sparse - sparse (the union of the patterns)."""
    if not isinstance(t2, DCSR_matrix):
        raise TypeError("sparse binary ops require DCSR_matrix operands")
    return add(t1, negative(t2))


DCSR_matrix.__add__ = add
DCSR_matrix.__mul__ = mul
DCSR_matrix.__rmul__ = mul
DCSR_matrix.__sub__ = sub
DCSR_matrix.__neg__ = negative
DCSR_matrix.__truediv__ = lambda t, s: _scale(t, 1.0 / s)
