"""PCA and IncrementalPCA (reference: ``heat_tpu/decomposition/pca.py``).

PCA centres the data and takes the distributed SVD layer's solvers, the
reference's dispatch: ``'hierarchical'`` (``hsvd_rank``, the default),
``'full'`` (TS-SVD of a matrix split along its rows) and ``'randomized'``
(``rsvd``).  A float ``n_components`` keeps as many components as reach
that share of the variance (one ``searchsorted`` read on the host).

IncrementalPCA merges batch by batch (Ross et al.): the stack of the kept
(k, d) sketch Σ·Vᵀ, the centred batch and the mean-correction row is
decomposed whole on every rank (the batch, split along its rows, is
gathered: (k + batch + 1, d) values), as TS-SVD decomposes a block: a
Householder QR of the stack, then the SVD of its (d, d) R in float64 (only
Σ and Vᵀ are kept; the card's float32 SVD is accurate to ~1e-4 only).
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from ..core import statistics, types
from ..core.base import BaseEstimator, TransformMixin
from ..core.dndarray import DNDarray
from ..core.sanitation import on_rows, whole
from ..linalg import svdtools
from ..linalg.basics import _full_float32

__all__ = ["PCA", "IncrementalPCA"]


def _replicated(t: torch.Tensor, proto: DNDarray) -> DNDarray:
    return DNDarray(t, tuple(t.shape), types.canonical_heat_type(t.dtype), None, proto.device, proto.comm, True)


def project(x: DNDarray, w: torch.Tensor, shift: Optional[torch.Tensor] = None,
            offset: Optional[torch.Tensor] = None) -> DNDarray:
    """``(x - shift) @ w + offset`` for a replicated (d, k) ``w``, in x's row
    layout and of x's split: a local product of this rank's rows (full
    float32); an array split along its columns takes its rows first."""
    split = x.split
    rows = on_rows(x)
    t = rows.larray
    if shift is not None:
        t = t - shift
    with _full_float32():
        res = t @ w.to(t.dtype)
    if offset is not None:
        res = res + offset
    out = DNDarray(res, (x.shape[0], w.shape[1]), types.canonical_heat_type(res.dtype), rows.split, x.device,
                   x.comm, rows.balanced)
    return out.resplit(split) if out.split != split else out


class PCA(TransformMixin, BaseEstimator):
    """Principal component analysis by the distributed SVD (reference API:
    n_components (int, float share of variance, or None), svd_solver
    ('hierarchical' | 'full' | 'randomized'), iterated_power,
    n_oversamples; ``whiten=True`` raises)."""

    def __init__(
        self,
        n_components: Optional[Union[int, float]] = None,
        copy: bool = True,
        whiten: bool = False,
        svd_solver: str = "hierarchical",
        tol: Optional[float] = None,
        iterated_power: int = 0,
        n_oversamples: int = 10,
        power_iteration_normalizer: str = "qr",
        random_state: Optional[int] = None,
    ):
        if whiten:
            raise NotImplementedError("whiten=True not supported (reference parity)")
        self.n_components = n_components
        self.copy = copy
        self.whiten = whiten
        self.svd_solver = svd_solver
        self.tol = tol
        self.iterated_power = iterated_power
        self.n_oversamples = n_oversamples
        self.power_iteration_normalizer = power_iteration_normalizer
        self.random_state = random_state

        self.components_ = None
        self.explained_variance_ = None
        self.explained_variance_ratio_ = None
        self.singular_values_ = None
        self.mean_ = None
        self.n_components_ = None
        self.total_explained_variance_ratio_ = None

    def fit(self, x: DNDarray, y=None) -> "PCA":
        if x.ndim != 2:
            raise ValueError("PCA requires 2-D data (n_samples, n_features)")
        n, d = x.shape
        mean = statistics.mean(x, axis=0)
        xc = x - mean
        self.mean_ = mean.resplit(None) if mean.is_distributed() else mean

        k = self.n_components
        if k is None:
            k = min(n, d)
        k_int = min(n, d) if isinstance(k, float) else int(k)

        if self.svd_solver == "full":
            _, S, V = svdtools.svd(xc)
        elif self.svd_solver == "hierarchical":
            _, S, V, _ = svdtools.hsvd_rank(xc, maxrank=k_int, compute_sv=True)
        elif self.svd_solver == "randomized":
            _, S, V = svdtools.rsvd(xc, rank=k_int, n_oversamples=self.n_oversamples,
                                    power_iter=self.iterated_power)
        else:
            raise ValueError(f"Unknown svd_solver {self.svd_solver!r}")
        s = whole(S)
        comps = whole(V).T
        var = s**2 / max(n - 1, 1)
        total_var = statistics.var(xc, axis=0, ddof=1).larray.sum() if n > 1 else var.sum()
        ratio = var / total_var.clamp_min(1e-30)
        if isinstance(self.n_components, float):
            csum = torch.cumsum(ratio, 0)
            target = torch.tensor([self.n_components], dtype=csum.dtype, device=csum.device)
            k_int = int(torch.searchsorted(csum, target).item()) + 1
        k_int = min(k_int, s.shape[0])

        self.components_ = _replicated(comps[:k_int].contiguous(), x)
        self.singular_values_ = _replicated(s[:k_int].contiguous(), x)
        self.explained_variance_ = _replicated(var[:k_int].contiguous(), x)
        self.explained_variance_ratio_ = _replicated(ratio[:k_int].contiguous(), x)
        self.total_explained_variance_ratio_ = float(ratio[:k_int].sum())
        self.n_components_ = k_int
        return self

    def transform(self, x: DNDarray) -> DNDarray:
        if self.components_ is None:
            raise RuntimeError("fit must be called before transform")
        return project(x, self.components_.larray.T, shift=self.mean_.larray)

    def inverse_transform(self, x: DNDarray) -> DNDarray:
        return project(x, self.components_.larray, offset=self.mean_.larray)


class IncrementalPCA(TransformMixin, BaseEstimator):
    """Streaming PCA: the SVD of each batch merged with the kept sketch
    (reference API: n_components, batch_size; ``whiten=True`` raises)."""

    def __init__(self, n_components: Optional[int] = None, copy: bool = True,
                 whiten: bool = False, batch_size: Optional[int] = None):
        if whiten:
            raise NotImplementedError("whiten=True not supported")
        self.n_components = n_components
        self.copy = copy
        self.whiten = whiten
        self.batch_size = batch_size
        self.components_ = None
        self.singular_values_ = None
        self.mean_ = None
        self.n_samples_seen_ = 0
        self._us = None  # the kept (k, d) sketch Σ·Vᵀ

    def partial_fit(self, x: DNDarray, y=None) -> "IncrementalPCA":
        n_new, d = x.shape
        jx = whole(x)
        n_old = self.n_samples_seen_
        n_tot = n_old + n_new
        mean_new = jx.mean(0)
        if n_old == 0:
            mean = mean_new
            stack = jx - mean
        else:
            mean_old = self.mean_.larray
            mean = (n_old * mean_old + n_new * mean_new) / n_tot
            corr = (n_old * n_new / n_tot) ** 0.5 * (mean_old - mean_new)  # Ross et al.'s mean correction
            stack = torch.cat([self._us, jx - mean_new[None, :], corr[None, :]])
        with _full_float32():
            r = torch.linalg.qr(stack, mode="r").R
        _, s, vt = svdtools._local_svd(r, small=True)
        k = min(self.n_components or min(stack.shape), s.shape[0])
        self._us = s[:k, None] * vt[:k]
        self.mean_ = _replicated(mean, x)
        self.n_samples_seen_ = n_tot
        self.components_ = _replicated(vt[:k].contiguous(), x)
        self.singular_values_ = _replicated(s[:k].contiguous(), x)
        return self

    def fit(self, x: DNDarray, y=None) -> "IncrementalPCA":
        n = x.shape[0]
        bs = self.batch_size or max(1, 5 * (self.n_components or 10))
        self.n_samples_seen_ = 0
        self._us = None
        for lo in range(0, n, bs):
            self.partial_fit(x[lo: min(lo + bs, n)])
        return self

    def transform(self, x: DNDarray) -> DNDarray:
        return project(x, self.components_.larray.T, shift=self.mean_.larray)
