"""Dynamic Mode Decomposition (reference: ``heat_tpu/decomposition/dmd.py``).

Exact DMD of a snapshot matrix X (features × time) split along its
features (rows): the distributed SVD of X₀ = X[:, :-1] (the solvers of
PCA), truncated by ``svd_rank``, ``svd_tol`` or 1e-10·s₀; the reduced
operator Ã = Uᵣᵀ X₁ Vᵣ Σᵣ⁻¹ (one local product and one Allreduce of the
(r, time) contraction over the rows); its complex64 eigendecomposition,
r x r on the data's device (``torch.linalg.eig``); and the modes
X₁ Vᵣ Σᵣ⁻¹ W, in X's row layout.  A matrix split along time is gathered
first.
"""

from __future__ import annotations

import numbers
from typing import Optional

import numpy as np
import torch

from ..core import types
from ..core.base import BaseEstimator
from ..core.dndarray import DNDarray
from ..linalg import svdtools
from ..linalg.basics import _full_float32

__all__ = ["DMD"]


class DMD(BaseEstimator):
    """Exact DMD of a snapshot matrix X (features × time); ``svd_solver``
    'full' | 'hierarchical' | 'randomized', ``svd_rank``/``svd_tol`` select
    the truncation, as the reference's."""

    def __init__(self, svd_solver: str = "full", svd_rank: Optional[int] = None, svd_tol: Optional[float] = None):
        if svd_solver not in ("full", "hierarchical", "randomized"):
            raise ValueError(f"Unknown svd_solver {svd_solver!r}")
        self.svd_solver = svd_solver
        self.svd_rank = svd_rank
        self.svd_tol = svd_tol
        self.rom_basis_ = None
        self.rom_transfer_matrix_ = None
        self.rom_eigenvalues_ = None
        self.rom_eigenmodes_ = None
        self.dmdmodes_ = None
        self.n_modes_ = None

    def _sum_rows(self, t: torch.Tensor) -> torch.Tensor:
        """A contraction over the basis' rows, summed over the ranks."""
        if self.rom_basis_.is_distributed():
            self.rom_basis_.comm.Allreduce(t)
        return t

    def fit(self, x: DNDarray) -> "DMD":
        if x.ndim != 2 or x.shape[1] < 2:
            raise ValueError("DMD requires a 2-D snapshot matrix with >= 2 time steps")
        if x.is_distributed() and x.split != 0:
            x = x.resplit(None)
        X0d, X1d = x[:, :-1], x[:, 1:]
        if self.svd_solver == "hierarchical":
            rank = self.svd_rank or min(X0d.shape)
            U, S, V, _ = svdtools.hsvd_rank(X0d, maxrank=rank, compute_sv=True)
            s = S.larray
            r = min(rank, s.shape[0])
        elif self.svd_solver == "randomized":
            rank = self.svd_rank or min(X0d.shape)
            U, S, V = svdtools.rsvd(X0d, rank=rank)
            s = S.larray
            r = min(rank, s.shape[0])
        else:
            U, S, V = svdtools.svd(X0d)
            s = S.larray
            if self.svd_rank is not None:
                r = min(self.svd_rank, s.shape[0])
            else:
                tol = self.svd_tol if self.svd_tol is not None else 1e-10
                r = int((s > tol * s[0]).sum().item())
        r = max(r, 1)
        u_r = U.larray[:, :r].contiguous()
        s_r, v_r = s[:r], V.larray[:, :r]
        x1 = X1d.larray
        basis_split = 0 if x.split == 0 else None
        self.rom_basis_ = DNDarray(u_r, (x.shape[0], r), types.canonical_heat_type(u_r.dtype), basis_split, x.device,
                                   x.comm, U.balanced if basis_split is not None else True)
        with _full_float32():
            ux1 = self._sum_rows(u_r.T @ x1)
            atilde = (ux1 @ v_r) / s_r[None, :]
            evals, evecs = torch.linalg.eig(atilde.to(torch.complex64))
            modes = ((x1 @ v_r) / s_r[None, :]).to(torch.complex64) @ evecs

        def rep(t):
            return DNDarray(t, tuple(t.shape), types.canonical_heat_type(t.dtype), None, x.device, x.comm, True)

        self.rom_transfer_matrix_ = rep(atilde)
        self.rom_eigenvalues_ = rep(evals)
        self.rom_eigenmodes_ = rep(evecs)
        self.dmdmodes_ = DNDarray(modes, (x.shape[0], r), types.canonical_heat_type(modes.dtype), basis_split,
                                  x.device, x.comm, self.rom_basis_.balanced)
        self.n_modes_ = r
        return self

    def _local_rows(self, x: DNDarray) -> torch.Tensor:
        """This rank's rows of the state(s) ``x`` in the basis' row layout."""
        basis = self.rom_basis_
        if not basis.is_distributed():
            return (x.resplit(None) if x.is_distributed() else x).larray
        if x.split == 0 and x.is_distributed():
            counts = list(x.counts_displs()[0])
            rows = list(basis.counts_displs()[0])
            return x.larray if counts == rows else x.comm.redistribute(x.larray, 0, counts, rows)
        whole = (x.resplit(None) if x.is_distributed() else x).larray
        off = basis.counts_displs()[1][basis.comm.rank]
        return whole[off: off + basis.lshape[0]]

    def _gather_rows(self, t: torch.Tensor, axis: int) -> torch.Tensor:
        """The whole of ``t``, which holds this rank's basis rows along ``axis``."""
        basis = self.rom_basis_
        if not basis.is_distributed():
            return t
        return basis.comm.Allgatherv(t.contiguous(), axis, counts=basis.counts_displs()[0])

    def predict(self, x: DNDarray, n_steps) -> DNDarray:
        """The states after each of steps 1..``n_steps`` (or the listed
        steps) from the state(s) ``x``, by the eigendecomposition of the
        reduced operator (one diagonal power a step); the real part, of
        shape ``(len(steps),) + x.shape``, replicated."""
        if self.rom_basis_ is None:
            raise RuntimeError("fit must be called before predict")
        if isinstance(n_steps, numbers.Integral):
            steps = list(range(1, int(n_steps) + 1))
        else:
            steps = [int(t) for t in np.atleast_1d(np.asarray(n_steps))]
        if not steps:
            raise ValueError("predict needs at least one step")
        u = self.rom_basis_.larray
        lam = self.rom_eigenvalues_.larray
        w = self.rom_eigenmodes_.larray
        xl = self._local_rows(x)
        with _full_float32():
            red0 = torch.linalg.solve(w, self._sum_rows(u.T @ xl).to(w.dtype))
            flat0 = red0.reshape(red0.shape[0], -1)
            powers = lam[None, :] ** torch.tensor(steps, dtype=lam.real.dtype, device=lam.device)[:, None]
            red_t = torch.einsum("ir,tr,rm->tim", w, powers, flat0)
            res = torch.einsum("ni,tim->tnm", u, red_t.real.to(u.dtype))
        res = self._gather_rows(res, 1).reshape((len(steps),) + tuple(x.shape))
        return DNDarray(res, tuple(res.shape), types.canonical_heat_type(res.dtype), None, x.device, x.comm, True)

    def predict_next(self, x: DNDarray, n_steps: int = 1) -> DNDarray:
        """The state(s) ``x`` advanced ``n_steps`` by the reduced operator, in
        x's layout."""
        if self.rom_basis_ is None:
            raise RuntimeError("fit must be called before predict_next")
        u = self.rom_basis_.larray
        a = self.rom_transfer_matrix_.larray
        xl = self._local_rows(x)
        with _full_float32():
            red = self._sum_rows(u.T @ xl)
            for _ in range(n_steps):
                red = a @ red
            res = u @ red
        if self.rom_basis_.is_distributed() and x.split == 0 and x.is_distributed():
            return DNDarray(res, tuple(x.shape), x.dtype, 0, x.device, x.comm, self.rom_basis_.balanced)
        res = self._gather_rows(res, 0)
        if x.is_distributed():
            res = res[x.comm.chunk(res.shape, x.split)[2]].contiguous()
        return DNDarray(res, tuple(x.shape), types.canonical_heat_type(res.dtype), x.split, x.device, x.comm, True)
