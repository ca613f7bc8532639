"""Distributed SVD (reference: ``heat_tpu/linalg/svdtools.py``).

- ``svd``: exact SVD.  A tall matrix split along its rows goes through TSQR
  (:func:`.qr.tsqr`), the SVD of the small replicated R, and U = Q U_R, one
  local GEMM (TS-SVD); a wide matrix split along its columns through its
  transpose; every other case is gathered.
- ``hsvd_rank`` / ``hsvd_rtol``: the hierarchical approximate SVD, the JAX
  package's algorithm: truncated SVDs of column blocks, merged pairwise up a
  binary tree.  Each leaf and merge runs :func:`svd` on a block that keeps
  a's row split, so a split-0 matrix's blocks take TS-SVD.
- ``rsvd``: randomized SVD (Halko-Martinsson-Tropp sketch, TSQR of the sketch).

Products run in full float32 whatever the caller's matmul precision.
"""

from __future__ import annotations

import collections
from typing import Optional

import numpy as np
import torch

from ..core import types
from ..core.dndarray import DNDarray
from ..core.sanitation import sanitize_in
from .basics import _full_float32, matmul, transpose
from .qr import _SOLVER_DTYPES, _chunk, _wrap, qr, tsqr

__all__ = ["hsvd", "hsvd_rank", "hsvd_rtol", "rsvd", "svd"]

SVDTuple = collections.namedtuple("SVD", "U, S, V")


def _solver_dtype(t: torch.Tensor) -> torch.Tensor:
    return t if t.dtype in _SOLVER_DTYPES else t.to(torch.float32)


def _local_svd(t: torch.Tensor, small: bool = False):
    """(U, S, V^H) of a local matrix, reduced, in full float32.  A ``small``
    one (TS-SVD's n x n R) is decomposed in float64 and rounded back: with
    the card's float32 SVD of R, TS-SVD's U was orthogonal only to 1.2e-4
    at 1e6 x 256 on an H100, past the 1e-4 of the reference's tests; in
    float64 to float32's rounding, for ~8 of TS-SVD's 26.4 ms there."""
    t = _solver_dtype(t)
    if small and t.dtype in (torch.float32, torch.complex64):
        u, s, vh = torch.linalg.svd(t.to(torch.complex128 if t.is_complex() else torch.float64), full_matrices=False)
        return u.to(t.dtype), s.to(t.real.dtype if t.is_complex() else t.dtype), vh.to(t.dtype)
    with _full_float32():
        return torch.linalg.svd(t, full_matrices=False)


def svd(a: DNDarray, full_matrices: bool = False, compute_uv: bool = True, qr_procs_to_merge: int = 2):
    """Exact SVD: ``(U, S, V)`` with a = U diag(S) V^T, or S alone.

    A tall (m >= n) matrix split along rows: TSQR, the SVD of R on every
    rank, and U = Q U_R (split 0, in a's row layout); V and S replicated;
    without ``compute_uv`` TSQR forms no Q.  A wide (n > m) matrix split
    along columns: the SVD of its transpose, U and V swapped.  Otherwise
    the gathered matrix on every rank, U keeping a's split."""
    sanitize_in(a)
    if a.ndim != 2:
        raise ValueError("svd requires a 2-D array")
    if full_matrices:
        raise NotImplementedError("full_matrices=True is not supported (reference parity)")
    m, n = a.shape
    if a.split == 0 and m >= n:
        q, r = tsqr(a, mode="reduced" if compute_uv else "r")
        ur, s, vh = _local_svd(r.larray, small=True)
        if not compute_uv:
            return _wrap(s, s.shape, None, a)
        with _full_float32():
            u = q.larray @ ur
        return SVDTuple(_wrap(u, (m, u.shape[1]), 0, a, q.balanced), _wrap(s, s.shape, None, a),
                        _wrap(vh.mH.contiguous(), (n, vh.shape[0]), None, a))
    if a.split == 1 and n > m:
        ut, s, vt = svd(transpose(a), compute_uv=True)
        if not compute_uv:
            return s
        return SVDTuple(vt, s, ut)
    u, s, vh = _local_svd((a.resplit(None) if a.is_distributed() else a).larray)
    if not compute_uv:
        return _wrap(s, s.shape, None, a)
    split = a.split
    ul = u if split is None else _chunk(u, split, a)
    return SVDTuple(_wrap(ul, u.shape, split, a), _wrap(s, s.shape, None, a),
                    _wrap(vh.mH.contiguous(), (n, vh.shape[0]), None, a))


def _truncate(u: torch.Tensor, s: torch.Tensor, rank: Optional[int] = None, rtol: Optional[float] = None,
              safetyshift: int = 0):
    """The leading columns of ``u`` and entries of ``s``: ``rank`` (plus
    ``safetyshift``) of them, or as many as keep the discarded tail's energy
    above ``rtol`` * ||s|| (plus ``safetyshift``).  The rtol rank reads one
    scalar on the host; every rank holds the same ``s``, so every rank reads
    the same rank."""
    if rank is not None:
        k = min(rank + safetyshift, s.shape[0])
        return u[:, :k], s[:k]
    s2 = s.double() ** 2
    err2 = torch.flip(torch.cumsum(torch.flip(s2, (0,)), 0), (0,))
    keep = max(int((err2 > (rtol**2) * s2.sum()).sum().item()), 1)
    keep = min(keep + safetyshift, s.shape[0])
    return u[:, :keep], s[:keep]


def _rows_like(t: torch.Tensor, a: DNDarray) -> DNDarray:
    """A DNDarray of the local tensor ``t`` whose rows follow a's row layout
    (split 0 where a is, else replicated)."""
    split = 0 if a.split == 0 else None
    return DNDarray(t, (a.shape[0],) + tuple(t.shape[1:]), types.canonical_heat_type(t.dtype), split, a.device,
                    a.comm, a.balanced if split is not None else True)


def hsvd(
    a: DNDarray,
    maxrank: Optional[int] = None,
    maxmergedim: Optional[int] = None,
    rtol: Optional[float] = None,
    safetyshift: int = 0,
    no_of_merges: Optional[int] = None,
    compute_sv: bool = False,
    silent: bool = True,
):
    """Hierarchical SVD core: truncated SVDs of column blocks (``min(p, n)``
    blocks on p > 1 ranks, ``min(4, n)`` on one), merged pairwise up a
    binary tree, each level halving the factors; every leaf and merge is
    :func:`svd` of a block in a's row layout (TS-SVD where a is split 0; a
    matrix split along its columns is gathered first).  Returns ``(U, S)``,
    with ``compute_sv`` ``(U, S, V, relative error)``."""
    sanitize_in(a)
    if a.ndim != 2:
        raise ValueError("hsvd requires a 2-D array")
    m, n = a.shape
    comm = a.comm
    nblocks = min(comm.size, n) if comm.size > 1 else min(4, n)
    rows = a.resplit(None) if a.split == 1 and a.is_distributed() else a
    t = _solver_dtype(rows.larray)

    def svd_of(block: torch.Tensor, shift: int):
        u, s, _ = svd(_rows_like(block, rows))
        return _truncate(u.larray, s.larray, rank=maxrank, rtol=rtol, safetyshift=shift)

    factors = []
    bounds = np.linspace(0, n, nblocks + 1, dtype=np.int64)
    for i in range(nblocks):
        lo, hi = int(bounds[i]), int(bounds[i + 1])
        if hi > lo:
            u, s = svd_of(t[:, lo:hi], safetyshift)
            factors.append(u * s)
    while len(factors) > 1:
        merged = []
        for i in range(0, len(factors) - 1, 2):
            u, s = svd_of(torch.cat([factors[i], factors[i + 1]], dim=1), safetyshift)
            merged.append(u * s)
        if len(factors) % 2 == 1:
            merged.append(factors[-1])
        factors = merged
    u, s = svd_of(factors[0], 0)
    s = s.abs()  # a singular value is never negative: an exact zero must not come out as -0.0
    U = _rows_like(u.contiguous(), rows)
    S = _wrap(s.contiguous(), s.shape, None, a)
    if not compute_sv:
        return U, S
    # V = A^T U diag(1/s): a K-split product over the rows, summed over the ranks.
    # A column whose s is at most eps * max(s) (a rank-deficient input, e.g.
    # a constant column after centring) gets a zero V column: 1/s would make
    # it inf or NaN, and the reference's tiny s leaves it finite but of no norm
    # in particular.
    with _full_float32():
        vt = u.mH @ t
        if rows.is_distributed():
            vt = comm.Allreduce(vt.contiguous())
        live = s > torch.finfo(s.dtype).eps * s.max().clamp_min(torch.finfo(s.dtype).tiny) if s.numel() else s > 0
        vt = torch.where(live.unsqueeze(1), vt / torch.where(live, s, torch.ones_like(s)).unsqueeze(1),
                         torch.zeros_like(vt))
        sums = torch.stack([(t - (u * s) @ vt).abs().square().sum(), t.abs().square().sum()]).double()
    if rows.is_distributed():
        sums = comm.Allreduce(sums)
    err = float(sums[0].sqrt() / sums[1].sqrt().clamp_min(1e-30))
    v = vt.mH.contiguous()
    V = _wrap(_chunk(v, 0, a), v.shape, 0, a) if a.split == 1 else _wrap(v, v.shape, None, a)
    return U, S, V, err


def hsvd_rank(
    a: DNDarray,
    maxrank: int,
    compute_sv: bool = False,
    maxmergedim: Optional[int] = None,
    safetyshift: int = 5,
    silent: bool = True,
):
    """Hierarchical SVD truncated to ``maxrank`` (reference API)."""
    res = hsvd(a, maxrank=maxrank, maxmergedim=maxmergedim, safetyshift=safetyshift, compute_sv=compute_sv,
               silent=silent)
    if compute_sv:
        U, s, V, err = res
        k = min(maxrank, s.shape[0])
        return U[:, :k], s[:k], V[:, :k], err
    U, s = res
    return U[:, : min(maxrank, s.shape[0])]


def hsvd_rtol(
    a: DNDarray,
    rtol: float,
    compute_sv: bool = False,
    maxrank: Optional[int] = None,
    maxmergedim: Optional[int] = None,
    safetyshift: int = 5,
    no_of_merges: Optional[int] = None,
    silent: bool = True,
):
    """Hierarchical SVD truncated to relative tolerance ``rtol`` (reference API)."""
    res = hsvd(a, maxrank=maxrank, rtol=rtol, maxmergedim=maxmergedim, safetyshift=safetyshift,
               compute_sv=compute_sv, silent=silent)
    return res if compute_sv else res[0]


def rsvd(a: DNDarray, rank: int, n_oversamples: int = 10, power_iter: int = 0, qr_procs_to_merge: int = 2):
    """Randomized SVD: a Gaussian sketch Y = A Omega (k = rank + oversamples
    columns), ``power_iter`` rounds of Y = A (A^T Y), TSQR of Y, the SVD of
    the small B = Q^T A, and U = Q U_B.  U is split 0 where a is, else
    replicated; S and V replicated."""
    sanitize_in(a)
    from ..core import random as ht_random

    m, n = a.shape
    k = min(rank + n_oversamples, min(m, n))
    dtype = a.dtype if issubclass(a.dtype, types.floating) else types.float32
    af = a if a.dtype is dtype else a.astype(dtype)
    omega = ht_random.randn(n, k, dtype=dtype, device=a.device, comm=a.comm)
    y = matmul(af, omega)
    for _ in range(power_iter):
        y = matmul(af, matmul(transpose(af), y))
    q = qr(y).Q  # TSQR where y is split, else local
    b = matmul(transpose(q), af)  # (k, n), replicated
    ub, s, vh = _local_svd((b.resplit(None) if b.is_distributed() else b).larray)
    with _full_float32():
        u = q.larray @ ub
    r = min(rank, s.shape[0])
    U = DNDarray(u[:, :r].contiguous(), (m, r), types.canonical_heat_type(u.dtype), q.split, a.device, a.comm,
                 q.balanced)
    if a.split != 0 and U.split is not None:
        U = U.resplit(None)
    return U, _wrap(s[:r].contiguous(), (r,), None, a), _wrap(vh[:r].mH.contiguous(), (n, r), None, a)
