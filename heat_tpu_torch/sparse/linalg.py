"""Distributed sparse products (reference: ``heat/sparse/linalg.py``).

``DCSR (split 0) @ dense`` is row-parallel: the dense operand is made
whole on every rank, and each rank multiplies its CSR rows by it locally
(``torch.sparse.mm``: cuSPARSE's SpMM on the card), so its rows of the
result are its own and no collective touches the sparse data.  cuSPARSE
has no integer SpMM, so integer and bool operands multiply exactly in
float64 where every row's sum stays below 2^53, and raise past it.
"""

from __future__ import annotations

import torch

from ..core import types
from ..core.dndarray import DNDarray
from .dcsr_matrix import DCSR_matrix

__all__ = ["matmul"]

_EXACT = float(2**53)


def _exact_bound(csr: torch.Tensor, dense: torch.Tensor) -> float:
    """The largest |sum| a row of the integer product could reach."""
    crow = csr.crow_indices()
    rows = torch.repeat_interleave(torch.arange(csr.shape[0], device=crow.device), crow[1:] - crow[:-1])
    sums = torch.zeros(csr.shape[0], dtype=torch.float64, device=crow.device)
    sums.index_add_(0, rows, csr.values().abs().to(torch.float64))
    dmax = dense.abs().max().to(torch.float64) if dense.numel() else torch.zeros((), dtype=torch.float64)
    return float((sums.max() if sums.numel() else sums.new_zeros(())) * dmax)


def _spmm(csr: torch.Tensor, dense: torch.Tensor, out_dt) -> torch.Tensor:
    if types.heat_type_is_exact(out_dt):
        bound = _exact_bound(csr, dense)
        if bound >= _EXACT:
            raise ValueError(f"integer sparse product could reach {bound:.3g}, past the 2^53 of its exact "
                             "float64 route")
        res = torch.sparse.mm(csr.to(torch.float64), dense.to(torch.float64))
        return torch.round(res).to(out_dt.torch_type())
    from ..linalg.basics import _full_float32

    with _full_float32():
        return torch.sparse.mm(csr.to(out_dt.torch_type()), dense.to(out_dt.torch_type()))


def matmul(s: DCSR_matrix, other):
    """``s @ other`` for a distributed CSR left operand.

    - ``other`` dense (a 1-D or 2-D DNDarray): a dense DNDarray split as
      ``s`` (a split dense operand is made whole first);
    - ``other`` sparse: the sparse product, each rank its rows of ``s``
      times the whole of ``other``, split as ``s``."""
    from ..core import manipulations as core_manip
    from .manipulations import _gather_csr
    from ._arithmetics import _finish

    if isinstance(other, DCSR_matrix):
        if s.shape[1] != other.shape[0]:
            raise ValueError(f"shape mismatch: {s.shape} @ {other.shape}")
        dt = types.promote_types(s.dtype, other.dtype).torch_type()
        b = _gather_csr(other) if other.is_distributed() else other.larray
        res = torch.sparse.mm(s.larray.to(dt).to_sparse_coo(), b.to(dt).to_sparse_coo()).coalesce().to_sparse_csr()
        out = _finish(res, s)
        return DCSR_matrix(out.larray, out.gnnz, (s.shape[0], other.shape[1]), out.dtype, s.split, s.device, s.comm,
                           s.balanced)
    if not isinstance(other, DNDarray):
        raise TypeError(f"unsupported matmul operand {type(other)}")
    if other.ndim not in (1, 2):
        raise ValueError(f"dense operand must be 1-D or 2-D, got {other.ndim}-D")
    if s.shape[1] != other.shape[0]:
        raise ValueError(f"shape mismatch: {s.shape} @ {other.shape}")
    vec = other.ndim == 1
    if vec:
        other = core_manip.expand_dims(other, 1)
    dense = (other.resplit(None) if other.is_distributed() else other).larray
    out_dt = types.promote_types(s.dtype, other.dtype)
    res = _spmm(s.larray, dense.to(s.larray.device), out_dt)
    out = DNDarray(res, (s.shape[0], other.shape[1]), out_dt, s.split, s.device, s.comm, s.balanced)
    return core_manip.squeeze(out, 1) if vec else out
