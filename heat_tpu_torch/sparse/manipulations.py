"""Sparse manipulations (reference: ``heat/sparse/manipulations.py``):
conversions between dense DNDarrays and distributed CSR, and the
transpose.  ``to_sparse`` and ``todense`` keep the split; a transposed
matrix is split None, the reference's rule (CSR is split along rows)."""

from __future__ import annotations

from typing import Tuple

import torch

from ..core.dndarray import DNDarray
from .dcsr_matrix import DCSR_matrix

__all__ = ["todense", "to_dense", "to_sparse", "transpose"]


def _row_range(s: DCSR_matrix) -> Tuple[int, int]:
    """The global rows [lo, hi) of this rank's part."""
    if not s.is_distributed():
        return 0, s.shape[0]
    comm = s.comm
    if s.balanced:
        off, lshape, _ = comm.chunk(s.shape, 0)
        return off, off + lshape[0]
    counts = comm._extents(s.larray.crow_indices()[1:], 0)
    lo = sum(counts[:comm.rank])
    return lo, lo + counts[comm.rank]


def _gather_csr(s: DCSR_matrix) -> torch.Tensor:
    """The whole matrix on every rank, as one CSR tensor (collective)."""
    comm = s.comm
    a = s.larray
    crow, col, val = a.crow_indices(), a.col_indices(), a.values()
    rows = comm._extents(crow[1:], 0)
    nnz = comm._extents(col, 0)
    col = comm.Allgatherv(col.contiguous(), 0, nnz)
    val = comm.Allgatherv(val.contiguous(), 0, nnz)
    steps = comm.Allgatherv((crow[1:] - crow[:-1]).contiguous(), 0, rows)
    crow = torch.cat([steps.new_zeros(1), torch.cumsum(steps, 0)])
    return torch.sparse_csr_tensor(crow, col, val, size=s.shape)


def todense(sparse_matrix: DCSR_matrix) -> DNDarray:
    """The dense DNDarray of a DCSR_matrix, split as it."""
    t = sparse_matrix.larray.to_dense()
    return DNDarray(t, sparse_matrix.shape, sparse_matrix.dtype, sparse_matrix.split, sparse_matrix.device,
                    sparse_matrix.comm, sparse_matrix.balanced)


def to_dense(sparse_matrix: DCSR_matrix) -> DNDarray:
    return todense(sparse_matrix)


def to_sparse(x: DNDarray) -> DCSR_matrix:
    """The DCSR_matrix of a dense 2-D DNDarray split 0 or None; the split carries over."""
    if not isinstance(x, DNDarray):
        raise TypeError(f"to_sparse expects a DNDarray, got {type(x)}")
    if x.ndim != 2:
        raise ValueError("to_sparse requires a 2-D DNDarray")
    if x.split not in (None, 0):
        raise ValueError("DCSR is row-split only (split 0 or None, the reference's CSR constraint); resplit the "
                         f"dense array first (got split={x.split})")
    t = x.larray.to_sparse_csr()
    lnnz = torch.tensor([t.values().numel()], dtype=torch.int64)
    if x.is_distributed():
        lnnz = x.comm.Allreduce(lnnz.to(x.comm._scratch_device())).cpu()
    return DCSR_matrix(t, int(lnnz.item()), x.shape, x.dtype, x.split, x.device, x.comm, x.balanced)


def transpose(sparse_matrix: DCSR_matrix) -> DCSR_matrix:
    """The transposed matrix, split None (a row split cannot carry over)."""
    s = sparse_matrix
    whole = _gather_csr(s) if s.is_distributed() else s.larray
    t = whole.to_sparse_coo().coalesce()
    i = t.indices()
    tt = torch.sparse_coo_tensor(torch.stack([i[1], i[0]]), t.values(), size=(s.shape[1], s.shape[0]))
    res = tt.coalesce().to_sparse_csr()
    return DCSR_matrix(res, s.gnnz, (s.shape[1], s.shape[0]), s.dtype, None, s.device, s.comm, True)
