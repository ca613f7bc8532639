"""Distributed QR decomposition (reference: ``heat_tpu/linalg/qr.py``).

A row-split tall-skinny matrix takes TSQR: each rank factors its rows
(:func:`_tall_qr`), one ``Allgather`` brings every rank the (n, n) R
factors, every rank takes the QR of their (p*n, n) stack, and this rank's
n-row block of that Q times its own Q is its rows of the result: one GEMM
on the card.  One rank skips the merge: its own factors are the result.  Where a rank holds fewer than n rows, the matrix is gathered
and factored on every rank instead, each keeping its chunk of Q.  Products
run in full float32 whatever the caller's matmul precision; the
factorizations are cuSOLVER's through ``torch.linalg``.
"""

from __future__ import annotations

import collections
from typing import Tuple

import torch

from ..core import types
from ..core.dndarray import DNDarray
from ..core.sanitation import sanitize_in
from .basics import _full_float32

__all__ = ["qr", "tsqr"]

QR = collections.namedtuple("QR", "Q, R")

_METHODS = ("auto", "cholqr2", "householder")


_SOLVER_DTYPES = (torch.float32, torch.float64, torch.complex64, torch.complex128)


def _householder(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reduced Householder QR in full float32 (integers, bools and 16-bit
    floats promoted to float32)."""
    if t.dtype not in _SOLVER_DTYPES:
        t = t.to(torch.float32)
    with _full_float32():
        return torch.linalg.qr(t, mode="reduced")


def _chol_round(x: torch.Tensor, eye: torch.Tensor, want_q: bool = True):
    """One CholeskyQR round: the Gram x^T x, its Cholesky factor L (G = L L^T),
    L's inverse by a triangular solve, and x L^-T; returns (x L^-T or None
    without ``want_q``, L^T, info), ``info`` nonzero where the Gram was not
    positive definite."""
    g = x.T @ x
    lower, info = torch.linalg.cholesky_ex(g)
    if not want_q:
        return None, lower.T, info
    linv = torch.linalg.solve_triangular(lower, eye, upper=False)
    return x @ linv.T, lower.T, info


def _tall_qr(t: torch.Tensor, method: str = "auto", want_q: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reduced QR of one local block, as the JAX package's ``_tall_qr``.

    ``method='auto'`` takes CholeskyQR2 where the block is tall (m >= 4n)
    and n <= 2048, ``'cholqr2'`` wherever m >= n, each only for floating
    data; everything else is Householder.  CholeskyQR2 runs the round twice
    (Q = Q2, R = R2 R1), all products in full float32; without ``want_q``
    the second round forms no Q (Q is then None).  Where either round's Gram
    is not positive definite (``cholesky_ex``'s info; or a non-finite R),
    the block takes Householder instead: the JAX package's own runtime
    choice, on the card.  The check reads one flag on the host."""
    m, n = t.shape
    if (
        method == "householder"
        or m < n
        or not t.is_floating_point()
        or (method == "auto" and (m < 4 * n or n > 2048))
    ):
        return _householder(t)
    b = t if t.dtype in (torch.float32, torch.float64) else t.to(torch.float32)
    eye = torch.eye(n, dtype=b.dtype, device=b.device)
    with _full_float32():
        q1, r1, info1 = _chol_round(b, eye)
        q2, r2, info2 = _chol_round(q1, eye, want_q)
        ok = bool(((info1 == 0) & (info2 == 0) & torch.isfinite(r2).all()).item())
        if not ok:
            q, r = _householder(b)
        else:
            q, r = q2, r2 @ r1
    return None if q is None else q.to(t.dtype), r.to(t.dtype)


def _wrap(t: torch.Tensor, gshape, split, proto: DNDarray, balanced: bool = True) -> DNDarray:
    return DNDarray(t, tuple(gshape), types.canonical_heat_type(t.dtype), split, proto.device, proto.comm, balanced)


def _chunk(t: torch.Tensor, axis: int, proto: DNDarray) -> torch.Tensor:
    """This rank's HeAT chunk of the replicated ``t`` along ``axis``."""
    return t[proto.comm.chunk(t.shape, axis)[2]].contiguous()


def tsqr(a: DNDarray, mode: str = "reduced", method: str = "auto") -> QR:
    """Tall-skinny QR of a matrix split along its rows (other splits are
    resplit to 0): a local :func:`_tall_qr` of each rank's rows, one
    ``Allgather`` of the (n, n) R factors, Householder QR of their (p*n, n)
    stack, and Q = Q1 times this rank's n-row block of that stack's Q, one
    local GEMM; on one rank the merge would only flip signs, so Q1 and R1
    are the result.  Q is (m, n) and split 0 in a's row layout; R is
    replicated.
    ``mode='r'`` forms no Q.  Where a rank holds fewer than n rows, every
    rank factors the gathered matrix and keeps its chunk of Q."""
    if method not in _METHODS:
        raise ValueError(f"method must be one of {_METHODS}, got {method!r}")
    if mode not in ("reduced", "r"):
        raise ValueError(f"mode must be 'reduced' or 'r', got {mode!r}")
    m, n = a.shape
    a0 = a if a.split == 0 else a.resplit(0)
    comm = a.comm
    counts = a0.counts_displs()[0] if a0.is_distributed() else (m,)
    if min(counts) < n:
        q, r = _tall_qr((a0.resplit(None) if a0.is_distributed() else a0).larray, method)
        rq = _wrap(r, r.shape, None, a)
        return QR(None if mode == "r" else _wrap(_chunk(q, 0, a), q.shape, 0, a), rq)
    q1, r1 = _tall_qr(a0.larray, method, want_q=mode != "r")
    if comm.size == 1:
        return QR(None if mode == "r" else _wrap(q1, (m, q1.shape[1]), 0, a, a0.balanced), _wrap(r1, r1.shape, None, a))
    stack = torch.cat(comm.Allgather(r1.contiguous()))
    q2, r = _householder(stack)
    if mode == "r":
        return QR(None, _wrap(r, r.shape, None, a))
    k = r1.shape[0]
    with _full_float32():
        q = q1 @ q2[comm.rank * k : (comm.rank + 1) * k]
    return QR(_wrap(q, (m, q.shape[1]), 0, a, a0.balanced), _wrap(r, r.shape, None, a))


def qr(a: DNDarray, mode: str = "reduced", procs_to_merge: int = 2, method: str = "auto") -> QR:
    """QR decomposition with the JAX package's split dispatch: split None
    factors locally (:func:`_tall_qr`); a wide (m < n) matrix split along
    its columns is gathered, factored by Householder, and R keeps the column
    split; everything else is resplit to rows and takes :func:`tsqr`.

    ``method``: 'auto' (CholeskyQR2 for tall blocks, Householder otherwise),
    'cholqr2' or 'householder'.  ``procs_to_merge`` is accepted and ignored,
    as in the JAX package (the merge is one Allgather)."""
    sanitize_in(a)
    if a.ndim != 2:
        raise ValueError(f"qr requires a 2-D array, got {a.ndim}-D")
    if mode not in ("reduced", "r"):
        raise ValueError(f"mode must be 'reduced' or 'r', got {mode!r}")
    if method not in _METHODS:
        raise ValueError(f"method must be one of {_METHODS}, got {method!r}")
    if a.split is None:
        q, r = _tall_qr(a.larray, method, want_q=mode != "r")
        return QR(None if mode == "r" else _wrap(q, q.shape, None, a), _wrap(r, r.shape, None, a))
    m, n = a.shape
    if a.split == 1 and m < n:
        q, r = _householder((a.resplit(None) if a.is_distributed() else a).larray)
        rq = _wrap(_chunk(r, 1, a), r.shape, 1, a)
        return QR(None if mode == "r" else _wrap(q, q.shape, None, a), rq)
    return tsqr(a, mode=mode, method=method)


DNDarray.qr = lambda self, mode="reduced", method="auto": qr(self, mode=mode, method=method)
