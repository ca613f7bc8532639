"""Gaussian naive Bayes (reference: ``heat_tpu/naive_bayes/gaussianNB.py``).

A batch's per-class moments: every row's class index (``searchsorted`` in
the sorted classes), int32 counts, and the first and second moments of the
rows shifted by the batch's global mean, summed per class by a one-hot
product over row blocks of 2^20 in float64 (the reference's one-hot GEMM,
never (n, c) at once), then
one Allreduce of the (c, d) sums over the ranks.  ``partial_fit`` pools
batches by Chan's update.  The joint log-likelihood is two GEMMs a row
block, (x-s)²·(-1/2σ²)ᵀ + (x-s)·(μ-s)/σ²ᵀ plus a constant a class, with
s the mean of the class means; ``predict`` never holds (n, c).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core import types
from ..core.base import BaseEstimator, ClassificationMixin
from ..core.dndarray import DNDarray
from ..core.sanitation import on_rows, rows_of, whole
from ..linalg.basics import _full_float32

__all__ = ["GaussianNB"]

_BLOCK = 1 << 20


class GaussianNB(ClassificationMixin, BaseEstimator):
    """Gaussian naive Bayes (reference API: ``priors``, ``var_smoothing``;
    fitted ``theta_``, ``var_``, ``class_prior_``, ``class_count_``,
    ``classes_``, ``epsilon_``)."""

    def __init__(self, priors=None, var_smoothing: float = 1e-9):
        self.priors = priors
        self.var_smoothing = var_smoothing
        self.theta_ = None
        self.var_ = None
        self.class_count_ = None
        self.class_prior_ = None
        self.classes_ = None
        self.epsilon_ = None

    @staticmethod
    def _max_var(x: DNDarray) -> float:
        from ..core import statistics

        return float(statistics.var(x, axis=0).larray.max())

    @staticmethod
    def _batch_stats(x: DNDarray, yl: torch.Tensor, classes: torch.Tensor):
        """(int32 counts (c,), means (c, d), variances (c, d)) of one batch,
        unsmoothed, in x's float dtype."""
        xl = x.larray
        n, d = xl.shape
        dev = xl.device
        c = classes.shape[0]
        dt = xl.dtype if xl.is_floating_point() else torch.float32
        idx = torch.searchsorted(classes, yl.to(classes.dtype).contiguous())
        total = torch.zeros(d, dtype=torch.float64, device=dev)
        for s in range(0, n, _BLOCK):  # in float64 block by block: never a float64 copy of x
            total += xl[s:s + _BLOCK].double().sum(0)
        if x.is_distributed():
            x.comm.Allreduce(total)
        gmean = total / max(x.shape[0], 1)
        ids = torch.arange(c, device=dev)
        s1 = torch.zeros((c, d), dtype=torch.float64, device=dev)
        s2 = torch.zeros((c, d), dtype=torch.float64, device=dev)
        counts = torch.bincount(idx, minlength=c)
        for s in range(0, n, _BLOCK):
            xs = xl[s:s + _BLOCK].double() - gmean
            onehot = (ids[:, None] == idx[None, s:s + _BLOCK]).double()
            s1 += onehot @ xs
            s2 += onehot @ (xs * xs)
            del xs, onehot
        if x.is_distributed():
            for t in (s1, s2, counts):
                x.comm.Allreduce(t)
        safe = counts.clamp_min(1).double()[:, None]
        ms = s1 / safe
        var = (s2 / safe - ms * ms).clamp_min(0.0)
        return counts.to(torch.int32), (ms + gmean).to(dt), var.to(dt)

    def _finalize(self, x: DNDarray, classes, counts, means, var):
        def rep(t):
            return DNDarray(t.contiguous(), tuple(t.shape), types.canonical_heat_type(t.dtype), None, x.device,
                            x.comm, True)

        self.classes_ = rep(classes)
        self.class_count_ = rep(counts)
        if self.priors is not None:
            pr = np.asarray(self.priors, dtype=np.float64)
            if pr.shape[0] != int(classes.shape[0]):
                raise ValueError("Number of priors must match number of classes")
            if not np.isclose(pr.sum(), 1.0):
                raise ValueError("The sum of the priors should be 1")
            self.class_prior_ = rep(torch.tensor(pr, dtype=means.dtype, device=means.device))
        else:
            f = counts.to(means.dtype)
            self.class_prior_ = rep(f / f.sum().clamp_min(1.0))
        self.theta_ = rep(means)
        self.var_ = rep(var + self.epsilon_)
        return self

    def fit(self, x: DNDarray, y: DNDarray, sample_weight=None) -> "GaussianNB":
        if x.ndim != 2:
            raise ValueError("x must be 2-D (n_samples, n_features)")
        from ..core.manipulations import unique

        x = on_rows(x)
        yl = rows_of(y, x)
        classes = whole(unique(y.flatten() if y.ndim > 1 else y))
        self.epsilon_ = self.var_smoothing * self._max_var(x)
        counts, means, var = self._batch_stats(x, yl, classes)
        return self._finalize(x, classes, counts, means, var)

    @staticmethod
    def _check_labels(x: DNDarray, yl: torch.Tensor, classes: torch.Tensor, msg: str) -> None:
        bad = (~torch.isin(yl, classes.to(yl.dtype))).any().to(torch.int32).reshape(1)
        if x.is_distributed():
            x.comm.Allreduce(bad, "max")
        if bool(bad.item()):
            raise ValueError(msg)

    def partial_fit(self, x: DNDarray, y: DNDarray, classes=None, sample_weight=None) -> "GaussianNB":
        """Incremental fit on a batch: the batch's per-class moments pooled
        with the fitted state by Chan's update (exact up to rounding against
        one ``fit`` of the concatenation).  ``classes`` must be given on the
        first call; a label outside them raises."""
        if x.ndim != 2:
            raise ValueError("x must be 2-D (n_samples, n_features)")
        x = on_rows(x)
        yl = rows_of(y, x)
        if self.classes_ is None:
            if classes is None:
                raise ValueError("classes must be passed on the first call to partial_fit")
            cls = whole(classes) if isinstance(classes, DNDarray) else torch.as_tensor(np.asarray(classes))
            cls = torch.sort(cls.to(device=x.larray.device, dtype=yl.dtype)).values
            self._check_labels(x, yl, cls, "y contains labels not in the declared classes")
            self.epsilon_ = self.var_smoothing * self._max_var(x)
            counts, means, var = self._batch_stats(x, yl, cls)
            return self._finalize(x, cls, counts, means, var)
        cls = self.classes_.larray
        self._check_labels(x, yl, cls, "y contains labels not in the classes seen at first partial_fit")
        n_new, means_new, var_new = self._batch_stats(x, yl, cls)
        n_old = self.class_count_.larray
        means_old = self.theta_.larray
        var_old = (self.var_.larray - self.epsilon_).clamp_min(0.0)  # the smoothing stripped
        n_tot = n_old + n_new
        f_old, f_new = n_old.to(means_old.dtype), n_new.to(means_old.dtype)
        safe = n_tot.to(means_old.dtype).clamp_min(1.0)
        delta = means_new - means_old
        means = means_old + delta * (f_new / safe)[:, None]
        m2 = var_old * f_old[:, None] + var_new * f_new[:, None] + delta**2 * (f_old * (f_new / safe))[:, None]
        var = (m2 / safe[:, None]).clamp_min(0.0)
        self.epsilon_ = max(self.epsilon_, self.var_smoothing * self._max_var(x))
        return self._finalize(x, cls, n_tot, means, var)

    def _jll_blocks(self, xl: torch.Tensor):
        """Yields (start, (rows, c) joint log-likelihoods) over row blocks."""
        means, var, prior = self.theta_.larray, self.var_.larray, self.class_prior_.larray
        shift = means.mean(0)
        mu = means - shift
        inv = 1.0 / var
        const = (torch.log(prior.clamp_min(1e-30)) - 0.5 * torch.log(2.0 * math.pi * var).sum(1)
                 - 0.5 * (mu * mu * inv).sum(1))
        quad, lin = (-0.5 * inv).T.contiguous(), (mu * inv).T.contiguous()
        with _full_float32():
            for s in range(0, xl.shape[0], _BLOCK):
                xs = xl[s:s + _BLOCK].to(means.dtype) - shift
                yield s, torch.addmm(torch.addmm(const, xs, lin), xs * xs, quad)

    def _out(self, t: torch.Tensor, x: DNDarray) -> DNDarray:
        # the rows of x (split 0 after on_rows, or a split-1 x at world size 1,
        # which on_rows leaves): outputs are split 0 wherever x is split at all
        split = None if x.split is None else 0
        return DNDarray(t, (x.shape[0],) + tuple(t.shape[1:]), types.canonical_heat_type(t.dtype), split,
                        x.device, x.comm, x.balanced if split is not None else True)

    def predict(self, x: DNDarray) -> DNDarray:
        if self.theta_ is None:
            raise RuntimeError("fit must be called before predict")
        x = on_rows(x)
        xl = x.larray
        idx = torch.empty(xl.shape[0], dtype=torch.int64, device=xl.device)
        for s, jll in self._jll_blocks(xl):
            idx[s:s + jll.shape[0]] = jll.argmax(1)
        return self._out(self.classes_.larray[idx], x)

    def predict_log_proba(self, x: DNDarray) -> DNDarray:
        x = on_rows(x)
        xl = x.larray
        out = torch.empty((xl.shape[0], self.classes_.shape[0]), dtype=self.theta_.larray.dtype, device=xl.device)
        for s, jll in self._jll_blocks(xl):
            out[s:s + jll.shape[0]] = jll - torch.logsumexp(jll, 1, keepdim=True)
        return self._out(out, x)

    def predict_proba(self, x: DNDarray) -> DNDarray:
        lp = self.predict_log_proba(x)
        return self._out(lp.larray.exp(), lp)
