"""Iterative and triangular solvers (reference: ``heat_tpu/linalg/solver.py``).

``cg`` and ``lanczos`` are written against the array API (``ht.matmul``,
``vdot``, ``norm``), so that the dispatch core supplies the collectives of
each matrix-vector product and dot, as in HeAT.  ``solve_triangular``
substitutes block by block over ``SquareDiagTiles``: each diagonal tile's
right-hand side is updated by the solved blocks on the ranks that hold
them, and the tile with its right-hand side is brought to every rank by one
collective before the small triangular solve.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core import arithmetics, types
from ..core.dndarray import DNDarray
from ..core.sanitation import sanitize_in
from ..core.tiling import SquareDiagTiles, _overlaps
from .basics import _full_float32, matmul, norm, transpose, vdot
from .qr import _chunk, _wrap

__all__ = ["cg", "lanczos", "solve_triangular"]


def cg(A: DNDarray, b: DNDarray, x0: Optional[DNDarray] = None, out: Optional[DNDarray] = None,
       maxit: Optional[int] = None, tol: float = 1e-8) -> DNDarray:
    """Conjugate gradients for a symmetric positive definite ``A``: iterates
    until sqrt(r.r) <= ``tol`` or ``maxit`` steps (default: b's length), the
    JAX package's test, reading one scalar on the host a step.  The result
    is split as ``b``."""
    sanitize_in(A)
    sanitize_in(b)
    maxit = b.shape[0] if maxit is None else maxit
    with _full_float32():
        x = x0 if x0 is not None else arithmetics.mul(b, 0)
        r = arithmetics.sub(b, matmul(A, x))
        p = r
        rs = vdot(r, r)
        it = 0
        while it < maxit and float(rs.item()) ** 0.5 > tol:
            Ap = matmul(A, p)
            alpha = arithmetics.div(rs, vdot(p, Ap))
            x = arithmetics.add(x, arithmetics.mul(alpha, p))
            r = arithmetics.sub(r, arithmetics.mul(alpha, Ap))
            rs_new = vdot(r, r)
            p = arithmetics.add(r, arithmetics.mul(arithmetics.div(rs_new, rs), p))
            rs = rs_new
            it += 1
    if x.split != b.split:
        x = x.resplit(b.split)
    if out is not None:
        out.larray.copy_(x.larray)
        return out
    return x


def _column(V: torch.Tensor, proto: DNDarray, cols: int) -> DNDarray:
    """The first ``cols`` columns of the local basis ``V`` as a DNDarray in
    ``proto``'s row layout."""
    return DNDarray(V[:, :cols], (proto.shape[0], cols), proto.dtype, proto.split, proto.device, proto.comm,
                    proto.balanced)


def lanczos(
    A: DNDarray,
    m: int,
    v0: Optional[DNDarray] = None,
    V_out: Optional[DNDarray] = None,
    T_out: Optional[DNDarray] = None,
) -> Tuple[DNDarray, DNDarray]:
    """Lanczos tridiagonalization with full reorthogonalization, as the JAX
    package's: returns V (n x m basis, split 0 where A is, else replicated)
    and the tridiagonal T (m x m, replicated).  ``v0`` (default: a random
    unit vector) is taken as given.  The scalars stay on the card: a
    vanishing step is masked there, never read on the host."""
    sanitize_in(A)
    n = A.shape[0]
    split = 0 if A.split == 0 else None
    if v0 is None:
        from ..core import random as ht_random

        v = ht_random.randn(n, dtype=A.dtype, device=A.device, comm=A.comm, split=split)
        v = arithmetics.div(v, norm(v))
    else:
        v = v0
    v = v if v.split == split else v.resplit(split)
    if split is not None and v.is_distributed():  # into A's row layout
        counts, rows = v.counts_displs()[0], A.counts_displs()[0]
        if list(counts) != list(rows):
            v = DNDarray(v.comm.redistribute(v.larray, 0, counts, rows), v.gshape, v.dtype, 0, v.device, v.comm,
                         A.balanced)
    with _full_float32():
        V = torch.zeros((v.lshape[0], m), dtype=v.larray.dtype, device=v.larray.device)
        V[:, 0] = v.larray
        alphas = torch.zeros(m, dtype=V.dtype, device=V.device)
        betas = torch.zeros(m, dtype=V.dtype, device=V.device)
        w = matmul(A, v)
        a0 = vdot(w, v).larray
        w = arithmetics.sub(w, arithmetics.mul(v, a0))
        alphas[0] = a0
        for i in range(1, m):
            beta = norm(w).larray
            vi = torch.where(beta > 1e-12, w.larray / beta.clamp_min(1e-30), torch.zeros_like(w.larray))
            vi_d = DNDarray(vi, (n,), v.dtype, split, v.device, v.comm, v.balanced)
            basis = _column(V, v, m)
            vi_d = arithmetics.sub(vi_d, matmul(basis, matmul(transpose(basis), vi_d)))
            nrm = norm(vi_d).larray
            vi = torch.where(nrm > 1e-12, vi_d.larray / nrm.clamp_min(1e-30), vi_d.larray)
            V[:, i] = vi
            vi_d = DNDarray(vi, (n,), v.dtype, split, v.device, v.comm, v.balanced)
            w = matmul(A, vi_d)
            ai = vdot(w, vi_d).larray
            prev = DNDarray(V[:, i - 1], (n,), v.dtype, split, v.device, v.comm, v.balanced)
            w = arithmetics.sub(arithmetics.sub(w, arithmetics.mul(vi_d, ai)), arithmetics.mul(prev, beta))
            alphas[i], betas[i] = ai, beta
    T = torch.diag(alphas) + torch.diag(betas[1:], 1) + torch.diag(betas[1:], -1)
    Vd = _column(V, v, m)
    Td = _wrap(T, T.shape, None, A)
    if V_out is not None:
        V_out.larray.copy_(Vd.larray)
        T_out.larray.copy_(Td.larray)
        return V_out, T_out
    return Vd, Td


def _native(A: DNDarray, rhs: torch.Tensor, lower: bool) -> torch.Tensor:
    a = (A.resplit(None) if A.is_distributed() else A).larray
    return torch.linalg.solve_triangular(a.to(rhs.dtype), rhs, upper=not lower)


def _blocked(A: DNDarray, rhs: torch.Tensor, lower: bool) -> torch.Tensor:
    """The blocked substitution over ``SquareDiagTiles(A, 2)``: for each
    diagonal tile in order, its rows of the right-hand side less the solved
    blocks' products, then the tile's triangular solve, on every rank.  A
    split along rows: each rank updates the tile's rows it holds, and one
    ``Allgatherv`` brings every rank the tile with its right-hand side.  A
    split along columns: each rank's product over the solved columns it
    holds, summed by one ``Allreduce``, and one ``Allgatherv`` of the tile's
    columns.  ``rhs`` (n, k) is replicated; so is the solution."""
    n = A.shape[0]
    tiles = SquareDiagTiles(A, tiles_per_proc=2)
    starts = tiles.row_indices
    ends = starts[1:] + [n]
    x = torch.zeros_like(rhs)
    t, comm = A.larray, A.comm
    split = A.split if A.is_distributed() else None
    counts, displs = A.counts_displs() if split is not None else ((n,), (0,))
    off, cnt = displs[comm.rank], counts[comm.rank]
    order = range(len(ends)) if lower else range(len(ends) - 1, -1, -1)
    for i in order:
        lo, hi = starts[i], ends[i]
        slo, shi = (0, lo) if lower else (hi, n)  # the solved columns
        if split == 0:
            shares = _overlaps(lo, hi, counts, displs)
            r0 = max(lo, off) - off if shares[comm.rank] else 0
            rows = t[r0 : r0 + shares[comm.rank]]
            acc = rhs[off + r0 : off + r0 + shares[comm.rank]] - rows[:, slo:shi] @ x[slo:shi]
            both = comm.Allgatherv(torch.cat([rows[:, lo:hi], acc], dim=1).contiguous(), 0, counts=shares)
            tile, acc = both[:, : hi - lo], both[:, hi - lo :]
        elif split == 1:
            c0, c1 = max(slo, off), min(shi, off + cnt)
            part = t[lo:hi, c0 - off : c1 - off] @ x[c0:c1] if c1 > c0 else rhs.new_zeros((hi - lo, rhs.shape[1]))
            acc = rhs[lo:hi] - comm.Allreduce(part.contiguous())
            shares = _overlaps(lo, hi, counts, displs)
            c0 = max(lo, off) - off if shares[comm.rank] else 0
            tile = comm.Allgatherv(t[lo:hi, c0 : c0 + shares[comm.rank]].contiguous(), 1, counts=shares)
        else:
            acc = rhs[lo:hi] - t[lo:hi, slo:shi] @ x[slo:shi]
            tile = t[lo:hi, lo:hi]
        x[lo:hi] = torch.linalg.solve_triangular(tile, acc, upper=not lower)
    return x


def solve_triangular(A: DNDarray, b: DNDarray, lower: bool = False, blocked=None) -> DNDarray:
    """Solve A x = b for a triangular ``A`` (upper unless ``lower``).

    ``blocked=None`` takes the blocked substitution (:func:`_blocked`)
    where A is distributed along a split axis and n >= 2p, as the JAX
    package chooses, else one native triangular solve of the gathered A.
    The result is split as ``b``."""
    sanitize_in(A)
    sanitize_in(b)
    m, n = A.shape
    if m != n:
        raise ValueError(f"A must be square, got {A.shape}")
    if blocked is None:
        blocked = A.split is not None and A.comm.is_distributed() and n >= 2 * A.comm.size
    rhs = (b.resplit(None) if b.is_distributed() else b).larray
    rhs2 = rhs if b.ndim == 2 else rhs[:, None]
    dt = torch.promote_types(A.larray.dtype, rhs2.dtype)
    if not (dt.is_floating_point or dt.is_complex):
        dt = torch.float32
    with _full_float32():
        if blocked:
            x = _blocked(A if A.larray.dtype == dt else A.astype(types.canonical_heat_type(dt)), rhs2.to(dt), lower)
        else:
            x = _native(A, rhs2.to(dt), lower)
    x = x if b.ndim == 2 else x[:, 0]
    if b.split is not None and b.comm.is_distributed():
        return _wrap(_chunk(x, b.split, b), x.shape, b.split, b)
    return _wrap(x, x.shape, b.split, b)
