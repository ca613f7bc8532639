"""Lasso regression (reference: ``heat_tpu/regression/lasso.py``).

The reference's cyclic coordinate descent (Gauss–Seidel: each coordinate
updated from the ones already updated in the sweep), in covariance form.
With A = [1, X] (the unpenalised intercept first), a coordinate's update
needs ρⱼ = Aⱼᵀ(y − Aθ) + ‖Aⱼ‖²θⱼ = bⱼ − Gⱼ·θ + Gⱼⱼθⱼ, so G = AᵀA and
b = Aᵀy are formed once on the data's device (float64 products of row
blocks of 2^20 rows, one Allreduce of the (m, m) and (m,) sums over the
ranks), and the sweeps run in the
m = d + 1 dimensional space, in float64 on the host: O(m²) a sweep where the
reference's recomputes Aθ over all n rows for every coordinate, O(n·m²).
The threshold is ``lam * n / 2``, the stop a sweep's largest |Δθ| below
``tol``, as the reference's.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core import types
from ..core.base import BaseEstimator, RegressionMixin
from ..core.dndarray import DNDarray
from ..core.sanitation import on_rows, rows_of

__all__ = ["Lasso"]

_BLOCK = 1 << 20  # rows a float64 product of the Gram


def gram(x: DNDarray, y: Optional[torch.Tensor] = None):
    """(G = AᵀA, b = Aᵀy) in float64 for A = [1, X] over every rank's rows of
    ``x`` (split 0 or replicated), ``y`` this rank's targets."""
    xl = x.larray
    n, d = xl.shape
    dev = xl.device
    G = torch.zeros((d + 1, d + 1), dtype=torch.float64, device=dev)
    b = torch.zeros(d + 1, dtype=torch.float64, device=dev)
    G[0, 0] = n
    for s in range(0, n, _BLOCK):
        xb = xl[s:s + _BLOCK].double()
        G[0, 1:] += xb.sum(0)
        G[1:, 1:] += xb.T @ xb
        if y is not None:
            yb = y[s:s + _BLOCK].double()
            b[0] += yb.sum()
            b[1:] += xb.T @ yb
    G[1:, 0] = G[0, 1:]
    if x.is_distributed():
        x.comm.Allreduce(G)
        x.comm.Allreduce(b)
    return G, b


def soft_threshold(rho, lam):
    return np.sign(rho) * max(abs(rho) - lam, 0.0)


class Lasso(RegressionMixin, BaseEstimator):
    """L1-regularized linear regression by cyclic coordinate descent
    (reference API: ``lam``, ``max_iter``, ``tol``; fitted ``coef_``,
    ``intercept_``, ``theta``, ``n_iter_``)."""

    def __init__(self, lam: float = 0.1, max_iter: int = 100, tol: float = 1e-6):
        self.lam = lam
        self.max_iter = max_iter
        self.tol = tol
        self.__theta = None
        self.n_iter_ = None

    @property
    def coef_(self) -> Optional[DNDarray]:
        return None if self.__theta is None else self.__theta[1:]

    @property
    def intercept_(self) -> Optional[DNDarray]:
        return None if self.__theta is None else self.__theta[0]

    @property
    def theta(self):
        return self.__theta

    @staticmethod
    def soft_threshold(rho, lam):
        return soft_threshold(rho, lam)

    def fit(self, x: DNDarray, y: DNDarray) -> "Lasso":
        if x.ndim != 2:
            raise ValueError("x needs to be 2-D (n_samples, n_features)")
        x = on_rows(x)
        n = x.shape[0]
        G, b = gram(x, rows_of(y, x))
        G, b = G.cpu().numpy(), b.cpu().numpy()
        m = G.shape[0]
        half = self.lam * n / 2.0
        col_sq = np.maximum(np.diag(G), 1e-30)
        theta = np.zeros(m)
        n_iter = 0
        for it in range(self.max_iter):
            old = theta.copy()
            for j in range(m):
                rho = b[j] - G[j] @ theta + G[j, j] * theta[j]
                theta[j] = rho / col_sq[0] if j == 0 else soft_threshold(rho, half) / col_sq[j]
            n_iter = it + 1
            if np.abs(theta - old).max() < self.tol:
                break
        self.n_iter_ = n_iter
        th = torch.tensor(theta.reshape(-1, 1), dtype=x.larray.dtype if x.larray.is_floating_point()
                          else torch.float32, device=x.larray.device)
        self.__theta = DNDarray(th, tuple(th.shape), types.canonical_heat_type(th.dtype), None, x.device, x.comm,
                                True)
        return self

    def predict(self, x: DNDarray) -> DNDarray:
        if self.__theta is None:
            raise RuntimeError("fit must be called before predict")
        from ..decomposition.pca import project

        th = self.__theta.larray
        return project(x, th[1:], offset=th[0])
