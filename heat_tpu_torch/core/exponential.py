"""Exponential and logarithmic operations (reference:
``heat_tpu/core/exponential.py``): element-wise, no communication; integer
inputs compute in float32."""

from __future__ import annotations

import torch

from ._operations import _binary_op, _local_op
from .arithmetics import _float, _floating
from .dndarray import DNDarray

__all__ = ["exp", "expm1", "exp2", "log", "log2", "log10", "log1p", "logaddexp", "logaddexp2", "sqrt", "square", "cbrt",
           "rsqrt"]


def exp(x, out=None) -> DNDarray:
    return _local_op(torch.exp, x, out=out)


def expm1(x, out=None) -> DNDarray:
    return _local_op(lambda t: torch.expm1(_float(t)), x, out=out)


def exp2(x, out=None) -> DNDarray:
    return _local_op(lambda t: torch.exp2(_float(t)), x, out=out)


def log(x, out=None) -> DNDarray:
    return _local_op(torch.log, x, out=out)


def log2(x, out=None) -> DNDarray:
    return _local_op(torch.log2, x, out=out)


def log10(x, out=None) -> DNDarray:
    return _local_op(torch.log10, x, out=out)


def log1p(x, out=None) -> DNDarray:
    return _local_op(lambda t: torch.log1p(_float(t)), x, out=out)


def logaddexp(t1, t2) -> DNDarray:
    return _binary_op(lambda a, b: torch.logaddexp(*_floating(a, b)), t1, t2)


def logaddexp2(t1, t2) -> DNDarray:
    return _binary_op(lambda a, b: torch.logaddexp2(*_floating(a, b)), t1, t2)


def sqrt(x, out=None) -> DNDarray:
    return _local_op(torch.sqrt, x, out=out)


def _rsqrt(t: torch.Tensor) -> torch.Tensor:
    if not (t.is_floating_point() or t.is_complex()):
        raise TypeError(f"rsqrt does not accept dtype {t.dtype}; it takes floating and complex arrays, as in the JAX "
                        "package")
    return torch.rsqrt(t)


def rsqrt(x, out=None) -> DNDarray:
    """1/sqrt(x) of a floating or complex array."""
    return _local_op(_rsqrt, x, out=out)


def square(x, out=None) -> DNDarray:
    """x * x; bools square as int32, as in the JAX package."""
    return _local_op(lambda t: torch.square(t.to(torch.int32) if t.dtype == torch.bool else t), x, out=out)


def cbrt(x, out=None) -> DNDarray:
    """The real cube root (negative for negative x)."""
    return _local_op(lambda t: torch.sign(_float(t)) * torch.abs(_float(t)).pow(1.0 / 3.0), x, out=out)


DNDarray.exp = exp
DNDarray.log = log
DNDarray.sqrt = sqrt
DNDarray.square = square
DNDarray.exp2 = exp2
DNDarray.log1p = log1p
DNDarray.log2 = log2
DNDarray.log10 = log10
DNDarray.expm1 = expm1
