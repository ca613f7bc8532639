"""Rounding operations (reference: ``heat_tpu/core/rounding.py``): all
element-wise, no communication.  Integers and bools keep their dtype under
``ceil``, ``floor``, ``trunc`` and ``round``, as in the JAX package."""

from __future__ import annotations

import numpy as np
import torch

from . import types
from ._operations import _local_op, _localize, _operand
from .arithmetics import _float
from .dndarray import DNDarray

__all__ = ["abs", "absolute", "ceil", "clip", "fabs", "floor", "frexp", "modf", "nan_to_num", "rint", "round", "sgn",
           "sign", "trunc"]


def _exact_kept(fn):
    """``fn`` on floats; integers and bools copied as they are."""
    return lambda t: fn(t) if t.is_floating_point() or t.is_complex() else t.clone()


def nan_to_num(x, nan: float = 0.0, posinf=None, neginf=None, out=None):
    """Replace NaN and +-inf with finite numbers (numpy semantics)."""
    return _local_op(_exact_kept(lambda t: torch.nan_to_num(t, nan=nan, posinf=posinf, neginf=neginf)), x, out=out)


def abs(x, out=None, dtype=None) -> DNDarray:
    """Elementwise absolute value."""
    res = _local_op(lambda t: t.clone() if t.dtype == torch.bool else torch.abs(t), x, out=out)
    if dtype is not None:
        res = res.astype(dtype, copy=False)
    return res


absolute = abs


def fabs(x, out=None) -> DNDarray:
    """Absolute value as a float (float32 for integers)."""
    return _local_op(lambda t: torch.abs(_float(t)), x, out=out)


def ceil(x, out=None) -> DNDarray:
    return _local_op(_exact_kept(torch.ceil), x, out=out)


def floor(x, out=None) -> DNDarray:
    return _local_op(_exact_kept(torch.floor), x, out=out)


def clip(x, min=None, max=None, out=None) -> DNDarray:
    """Clamp values into [min, max]; DNDarray bounds broadcast as operands."""
    if min is None and max is None:
        raise ValueError("clip requires at least one of min/max")
    lo = _localize(_operand(min, x), x.split, x.ndim, x) if min is not None else None
    hi = _localize(_operand(max, x), x.split, x.ndim, x) if max is not None else None

    def fn(t):
        t = t.to(torch.int32) if t.dtype == torch.bool else t
        dt = t.dtype
        for bound in (lo, hi):
            if isinstance(bound, torch.Tensor):
                dt = torch.promote_types(dt, bound.dtype)
            elif bound is not None:
                dt = torch.result_type(torch.empty(1, dtype=dt), bound)
        b = [torch.as_tensor(v, device=t.device).to(dt) if v is not None else None for v in (lo, hi)]
        return torch.clamp(t.to(dt), *b)

    return _local_op(fn, x, out=out)


def frexp(x, out=None):
    """(mantissa, exponent) decomposition; the exponent is int32."""
    return (_local_op(lambda t: torch.frexp(_float(t))[0], x), _local_op(lambda t: torch.frexp(_float(t))[1], x))


def modf(x, out=None):
    """(fractional, integral) parts, both carrying the input's sign."""
    f = _local_op(lambda t: torch.frac(_float(t)), x)
    i = _local_op(lambda t: torch.trunc(_float(t)), x)
    if out is not None:
        out[0].larray.copy_(f.larray)
        out[1].larray.copy_(i.larray)
        return out
    return (f, i)


def _round(decimals):
    def fn(t):
        if t.dtype == torch.bool:
            raise ValueError("round of a bool array is not supported")
        if not (t.is_floating_point() or t.is_complex()):
            if decimals >= 0:
                return t.clone()
            raise NotImplementedError("rounding integers to decimals < 0 is not supported, as in the JAX package")
        return torch.round(t, decimals=decimals)

    return fn


def round(x, decimals: int = 0, out=None, dtype=None) -> DNDarray:
    """Round half to even to ``decimals`` decimals."""
    res = _local_op(_round(decimals), x, out=out)
    if dtype is not None:
        res = res.astype(dtype, copy=False)
    return res


def rint(x, out=None) -> DNDarray:
    """Round to the nearest integer, half to even; integers give float32."""
    return _local_op(lambda t: torch.round(_float(t)), x, out=out)


def _no_bool(fn):
    def inner(t):
        if t.dtype == torch.bool:
            raise TypeError("sign of a bool array is not supported")
        return fn(t)

    return inner


def _nan_kept(fn):
    """``fn`` with nan mapped to nan (torch's sign of nan is 0, numpy's and
    the JAX package's nan)."""
    return lambda t: torch.where(torch.isnan(t), t, fn(t)) if t.is_floating_point() else fn(t)


def sgn(x, out=None) -> DNDarray:
    """Sign (complex: x/|x|); nan stays nan."""
    return _local_op(_no_bool(_nan_kept(torch.sgn)), x, out=out)


def sign(x, out=None) -> DNDarray:
    """Sign; for complex inputs the sign of the real part; nan stays nan."""
    if issubclass(x.dtype, types.complexfloating):
        return _local_op(lambda t: _nan_kept(torch.sign)(t.real).to(t.dtype), x, out=out)
    return _local_op(_no_bool(_nan_kept(torch.sign)), x, out=out)


def trunc(x, out=None) -> DNDarray:
    return _local_op(_exact_kept(torch.trunc), x, out=out)


DNDarray.abs = abs
DNDarray.__abs__ = lambda self: abs(self)
DNDarray.ceil = ceil
DNDarray.clip = clip
DNDarray.floor = floor
DNDarray.modf = modf
DNDarray.round = round
DNDarray.trunc = trunc
DNDarray.sign = sign


def fix(x, out=None) -> DNDarray:
    """Round toward zero (numpy ``fix``; ``trunc`` for floats)."""
    return trunc(x, out=out)


def real_if_close(x, tol: float = 100.0) -> DNDarray:
    """Drop an imaginary part that is negligible everywhere (numpy
    semantics: ``tol`` machine epsilons, or an absolute bound below 1)."""
    if not issubclass(x.dtype, types.complexfloating):
        return x
    eps = torch.finfo(x.larray.real.dtype).eps
    thresh = tol * eps if tol > 1 else tol
    from .logical import all as ht_all

    if bool(ht_all(_local_op(lambda t: t.imag.abs() < thresh, x)).item()):
        return _local_op(lambda t: t.real.clone(), x)
    return x


around = round

__all__ += ["around", "fix", "real_if_close"]
