"""Sparse factories (reference: ``heat/sparse/factories.py``)."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core import devices as ht_devices
from ..core import types
from ..core.communication import sanitize_comm
from .dcsr_matrix import DCSR_matrix

__all__ = ["sparse_csr_matrix", "sparse_csc_matrix"]


_NARROW = {np.dtype(np.float64): np.float32, np.dtype(np.int64): np.int32, np.dtype(np.complex128): np.complex64}


def _narrowed(a: np.ndarray) -> np.ndarray:
    """numpy data of 64 bits narrowed as ``ht.array`` ingests it (the reference's dtypes)."""
    return a.astype(_NARROW[a.dtype]) if a.dtype in _NARROW else a


def _csr_rows(t: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """Rows [lo, hi) of a CSR tensor, as a CSR tensor."""
    crow = t.crow_indices()
    a, b = int(crow[lo]), int(crow[hi])
    return torch.sparse_csr_tensor(crow[lo:hi + 1] - a, t.col_indices()[a:b], t.values()[a:b],
                                   size=(hi - lo, t.shape[1]), device=t.device)


def _from_local(t: torch.Tensor, split: Optional[int], is_split: Optional[int], dtype, device, comm) -> DCSR_matrix:
    """A DCSR_matrix of the CSR tensor ``t``: the whole matrix (``split``
    keeps this rank's rows of it) or, with ``is_split=0``, this rank's rows."""
    if dtype is not None:
        t = t.to(types.canonical_heat_type(dtype).torch_type())
    dt = types.canonical_heat_type(t.dtype)
    if is_split is not None:
        if is_split != 0:
            raise ValueError(f"DCSR is split along its rows only (is_split 0 or None), got {is_split}")
        n = torch.tensor([t.shape[0], t.values().numel()], dtype=torch.int64)
        if comm.is_distributed():
            n = comm.Allreduce(n.to(comm._scratch_device())).cpu()
        counts = comm._extents(t.crow_indices()[1:], 0) if comm.is_distributed() else [t.shape[0]]
        rows = int(n[0])
        balanced = list(counts) == [comm.chunk((rows,), 0, q)[1][0] for q in range(comm.size)]
        return DCSR_matrix(t, int(n[1]), (rows, t.shape[1]), dt, 0, device, comm, balanced)
    gshape = tuple(t.shape)
    gnnz = t.values().numel()
    if split is not None:
        if split != 0:
            raise ValueError(f"DCSR is split along its rows only (split 0 or None), got {split}")
        _, _, sl = comm.chunk(gshape, 0)
        t = _csr_rows(t, sl[0].start, sl[0].stop)
    return DCSR_matrix(t, gnnz, gshape, dt, split, device, comm, True)


def sparse_csr_matrix(obj, dtype=None, split: Optional[int] = None, is_split: Optional[int] = None, device=None,
                      comm=None) -> DCSR_matrix:
    """A DCSR_matrix from a scipy sparse matrix (any format), a torch sparse
    (CSR or COO) tensor, a dense DNDarray (its split carried over), or dense
    data (numpy, torch, lists).  ``split=0`` takes the given matrix as the
    whole and keeps this rank's rows; ``is_split=0`` takes it as this rank's
    rows."""
    from ..core.dndarray import DNDarray

    if split is not None and is_split is not None:
        raise ValueError("split and is_split are mutually exclusive")
    if isinstance(obj, DNDarray):
        from .manipulations import to_sparse

        want = split if split is not None else is_split
        if want is not None and want != obj.split:
            raise ValueError(f"sparse_csr_matrix cannot re-split a DNDarray input (array split={obj.split}, "
                             f"requested {want}); resplit the dense array first")
        if comm is not None and comm != obj.comm:
            raise ValueError("sparse_csr_matrix cannot rebind a DNDarray to a different comm")
        if device is not None and ht_devices.sanitize_device(device) != obj.device:
            raise ValueError("sparse_csr_matrix cannot move a DNDarray to a different device")
        return to_sparse(obj if dtype is None else obj.astype(dtype))
    comm = sanitize_comm(comm)
    device = ht_devices.sanitize_device(device)
    tdev = device.torch_device
    if isinstance(obj, torch.Tensor):
        t = obj.to(tdev)
        t = t.to_sparse_csr() if t.layout != torch.sparse_csr else t
        return _from_local(t, split, is_split, dtype, device, comm)
    try:
        import scipy.sparse as sp
    except ImportError:
        sp = None
    if sp is not None and sp.issparse(obj):
        csr = obj.tocsr()
        csr.sort_indices()
        t = torch.sparse_csr_tensor(torch.from_numpy(csr.indptr.astype(np.int64)),
                                    torch.from_numpy(csr.indices.astype(np.int64)),
                                    torch.from_numpy(_narrowed(csr.data) if dtype is None else csr.data),
                                    size=csr.shape).to(tdev)
        return _from_local(t, split, is_split, dtype, device, comm)
    dense = np.asarray(obj)
    if dense.ndim != 2:
        raise ValueError("sparse_csr_matrix requires a 2-D input")
    if dtype is None:
        dense = _narrowed(dense)
    t = torch.from_numpy(np.ascontiguousarray(dense)).to(tdev).to_sparse_csr()
    return _from_local(t, split, is_split, dtype, device, comm)


def sparse_csc_matrix(obj, dtype=None, split: Optional[int] = None, device=None, comm=None):
    raise NotImplementedError("CSC is not supported (reference supports CSR only)")
