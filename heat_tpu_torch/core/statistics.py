"""Statistics (reference: ``heat_tpu/core/statistics.py``): the extrema, so
far.  ``max`` and ``min`` over the split axis Allreduce the ranks' extrema
(an empty chunk gives the op's identity); ``maximum`` and ``minimum`` are
broadcast binary ops.  The rest of the module (mean, var, median,
percentiles, histograms, ...) is still to port."""

from __future__ import annotations

import torch

from ._operations import Reduction, _binary_op, _reduce_op
from .arithmetics import _tensors
from .dndarray import DNDarray

__all__ = ["amax", "amin", "max", "maximum", "min", "minimum"]

_MAX = Reduction(lambda t, d, k: torch.amax(t, dim=d, keepdim=k), "max")
_MIN = Reduction(lambda t, d, k: torch.amin(t, dim=d, keepdim=k), "min")


def max(x, axis=None, out=None, keepdims=False) -> DNDarray:
    """Maximum along ``axis`` (all axes for None)."""
    return _reduce_op(_MAX, x, axis=axis, keepdims=keepdims, out=out)


def min(x, axis=None, out=None, keepdims=False) -> DNDarray:
    """Minimum along ``axis`` (all axes for None)."""
    return _reduce_op(_MIN, x, axis=axis, keepdims=keepdims, out=out)


def maximum(x1, x2, out=None) -> DNDarray:
    """Elementwise maximum of two arrays."""
    return _binary_op(lambda a, b: torch.maximum(*_tensors(a, b)), x1, x2, out=out)


def minimum(x1, x2, out=None) -> DNDarray:
    return _binary_op(lambda a, b: torch.minimum(*_tensors(a, b)), x1, x2, out=out)


amax = max
amin = min

DNDarray.max = max
DNDarray.min = min
