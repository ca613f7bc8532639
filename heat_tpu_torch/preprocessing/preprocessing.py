"""Data scalers (reference: ``heat_tpu/preprocessing/preprocessing.py``).

The statistics are the array core's distributed reductions along the
samples (``mean``, ``var``, ``min``, ``max``; ``RobustScaler``'s median and
quartiles, each column's exact order statistics across ranks by the
selection of ``parallel.sample_sort``), replicated; the transforms are element-wise on this rank's rows, in x's
layout.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..core import statistics, types
from ..core.base import BaseEstimator, TransformMixin
from ..core.dndarray import DNDarray
from ..core.sanitation import on_rows, whole

__all__ = ["StandardScaler", "MinMaxScaler", "MaxAbsScaler", "RobustScaler", "Normalizer"]


def _rep(t: torch.Tensor, proto: DNDarray) -> DNDarray:
    return DNDarray(t.contiguous(), tuple(t.shape), types.canonical_heat_type(t.dtype), None, proto.device,
                    proto.comm, True)


def _feature_view(v: DNDarray, x: DNDarray) -> torch.Tensor:
    """The (d,) statistic ``v`` as it broadcasts over this rank's part of x:
    its slice of x's local columns where x is split along them."""
    t = v.larray
    if x.is_distributed() and x.split == 1:
        counts, displs = x.counts_displs()
        r = x.comm.rank
        t = t[displs[r]: displs[r] + counts[r]]
    return t


def _like(t: torch.Tensor, x: DNDarray) -> DNDarray:
    return DNDarray(t, x.gshape, types.canonical_heat_type(t.dtype), x.split, x.device, x.comm, x.balanced)


def _float(x: DNDarray) -> torch.Tensor:
    t = x.larray
    return t if t.is_floating_point() else t.to(torch.float32)


class StandardScaler(TransformMixin, BaseEstimator):
    """Zero-mean, unit-variance scaling of each feature."""

    def __init__(self, copy: bool = True, with_mean: bool = True, with_std: bool = True):
        self.copy = copy
        self.with_mean = with_mean
        self.with_std = with_std
        self.mean_ = None
        self.var_ = None
        self.scale_ = None

    def fit(self, x: DNDarray, sample_weight=None) -> "StandardScaler":
        mean = whole(statistics.mean(x, axis=0))
        var = whole(statistics.var(x, axis=0))
        scale = torch.where(var > 1e-30, var.sqrt(), torch.ones_like(var))
        self.mean_, self.var_, self.scale_ = _rep(mean, x), _rep(var, x), _rep(scale, x)
        return self

    def transform(self, x: DNDarray) -> DNDarray:
        t = _float(x)
        if self.with_mean:
            t = t - _feature_view(self.mean_, x)
        if self.with_std:
            t = t / _feature_view(self.scale_, x)
        return _like(t, x)

    def inverse_transform(self, x: DNDarray) -> DNDarray:
        t = _float(x)
        if self.with_std:
            t = t * _feature_view(self.scale_, x)
        if self.with_mean:
            t = t + _feature_view(self.mean_, x)
        return _like(t, x)


class MinMaxScaler(TransformMixin, BaseEstimator):
    """Scale each feature to ``feature_range`` (default [0, 1])."""

    def __init__(self, feature_range: Tuple[float, float] = (0.0, 1.0), copy: bool = True, clip: bool = False):
        if feature_range[0] >= feature_range[1]:
            raise ValueError("Minimum of feature_range must be smaller than maximum")
        self.feature_range = feature_range
        self.copy = copy
        self.clip = clip
        self.data_min_ = None
        self.data_max_ = None
        self.scale_ = None
        self.min_ = None

    def fit(self, x: DNDarray) -> "MinMaxScaler":
        from ..core.statistics import max as amax, min as amin

        dmin, dmax = whole(amin(x, axis=0)), whole(amax(x, axis=0))
        if not dmin.is_floating_point():
            dmin, dmax = dmin.float(), dmax.float()
        rng = torch.where(dmax > dmin, dmax - dmin, torch.ones_like(dmax))
        lo, hi = self.feature_range
        scale = (hi - lo) / rng
        self.data_min_, self.data_max_, self.data_range_ = _rep(dmin, x), _rep(dmax, x), _rep(rng, x)
        self.scale_ = _rep(scale, x)
        self.min_ = _rep(lo - dmin * scale, x)
        return self

    def transform(self, x: DNDarray) -> DNDarray:
        t = _float(x) * _feature_view(self.scale_, x) + _feature_view(self.min_, x)
        if self.clip:
            t = t.clamp(self.feature_range[0], self.feature_range[1])
        return _like(t, x)

    def inverse_transform(self, x: DNDarray) -> DNDarray:
        return _like((_float(x) - _feature_view(self.min_, x)) / _feature_view(self.scale_, x), x)


class MaxAbsScaler(TransformMixin, BaseEstimator):
    """Scale each feature by its largest absolute value."""

    def __init__(self, copy: bool = True):
        self.copy = copy
        self.max_abs_ = None
        self.scale_ = None

    def fit(self, x: DNDarray) -> "MaxAbsScaler":
        from ..core.rounding import abs as aabs
        from ..core.statistics import max as amax

        ma = whole(amax(aabs(x), axis=0))
        if not ma.is_floating_point():
            ma = ma.float()
        self.max_abs_ = _rep(ma, x)
        self.scale_ = _rep(torch.where(ma > 0, ma, torch.ones_like(ma)), x)
        return self

    def transform(self, x: DNDarray) -> DNDarray:
        return _like(_float(x) / _feature_view(self.scale_, x), x)

    def inverse_transform(self, x: DNDarray) -> DNDarray:
        return _like(_float(x) * _feature_view(self.scale_, x), x)


class RobustScaler(TransformMixin, BaseEstimator):
    """Median and interquartile-range scaling (distributed order statistics)."""

    def __init__(self, with_centering: bool = True, with_scaling: bool = True,
                 quantile_range: Tuple[float, float] = (25.0, 75.0), copy: bool = True,
                 unit_variance: bool = False):
        lo, hi = quantile_range
        if not 0 <= lo <= hi <= 100:
            raise ValueError(f"Invalid quantile range {quantile_range}")
        if unit_variance:
            raise NotImplementedError("unit_variance=True not supported (reference parity)")
        self.with_centering = with_centering
        self.with_scaling = with_scaling
        self.quantile_range = quantile_range
        self.copy = copy
        self.unit_variance = unit_variance
        self.center_ = None
        self.scale_ = None

    def fit(self, x: DNDarray) -> "RobustScaler":
        xf = x if x.larray.dtype == torch.float32 else x.astype(types.float32)
        lo, hi = self.quantile_range
        if self.with_centering or self.with_scaling:
            # column by column, each the exact order statistics of the 1-D
            # column (never a sort of the whole (n, d) array); the median is
            # the 50th percentile
            q = torch.stack([whole(statistics.percentile(xf[:, j], [50.0, lo, hi])) for j in range(x.shape[1])], 1)
        if self.with_centering:
            self.center_ = _rep(q[0], x)
        if self.with_scaling:
            iqr = q[2] - q[1]
            self.scale_ = _rep(torch.where(iqr > 0, iqr, torch.ones_like(iqr)), x)
        return self

    def transform(self, x: DNDarray) -> DNDarray:
        t = _float(x)
        if self.with_centering:
            t = t - _feature_view(self.center_, x)
        if self.with_scaling:
            t = t / _feature_view(self.scale_, x)
        return _like(t, x)

    def inverse_transform(self, x: DNDarray) -> DNDarray:
        t = _float(x)
        if self.with_scaling:
            t = t * _feature_view(self.scale_, x)
        if self.with_centering:
            t = t + _feature_view(self.center_, x)
        return _like(t, x)


class Normalizer(TransformMixin, BaseEstimator):
    """Each row to unit norm ('l1' | 'l2' | 'max'); stateless."""

    def __init__(self, norm: str = "l2", copy: bool = True):
        if norm not in ("l1", "l2", "max"):
            raise NotImplementedError(f"Unsupported norm {norm!r}")
        self.norm = norm
        self.copy = copy

    def fit(self, x: DNDarray) -> "Normalizer":
        return self

    def transform(self, x: DNDarray) -> DNDarray:
        split = x.split
        rows = on_rows(x)
        t = _float(rows)
        if self.norm == "l1":
            n = t.abs().sum(1, keepdim=True)
        elif self.norm == "l2":
            n = (t * t).sum(1, keepdim=True).sqrt()
        else:
            n = t.abs().amax(1, keepdim=True)
        out = _like(t / torch.where(n > 0, n, torch.ones_like(n)), rows)
        return out.resplit(split) if out.split != split else out
