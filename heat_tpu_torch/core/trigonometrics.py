"""Trigonometric and hyperbolic operations (reference:
``heat_tpu/core/trigonometrics.py``): element-wise, no communication;
integer inputs compute in float32."""

from __future__ import annotations

import torch

from ._operations import _binary_op, _local_op
from .arithmetics import _float, _floating
from .dndarray import DNDarray

__all__ = [
    "arccos",
    "acos",
    "arccosh",
    "acosh",
    "arcsin",
    "asin",
    "arcsinh",
    "asinh",
    "arctan",
    "atan",
    "arctan2",
    "atan2",
    "arctanh",
    "atanh",
    "cos",
    "cosh",
    "deg2rad",
    "degrees",
    "rad2deg",
    "radians",
    "sin",
    "sinc",
    "sinh",
    "tan",
    "tanh",
]


def _unary(fn):
    return lambda x, out=None: _local_op(lambda t: fn(_float(t)), x, out=out)


arccos = acos = _unary(torch.arccos)
arccosh = acosh = _unary(torch.arccosh)
arcsin = asin = _unary(torch.arcsin)
arcsinh = asinh = _unary(torch.arcsinh)
arctan = atan = _unary(torch.arctan)
arctanh = atanh = _unary(torch.arctanh)
cos = _unary(torch.cos)
cosh = _unary(torch.cosh)
deg2rad = radians = _unary(torch.deg2rad)
rad2deg = degrees = _unary(torch.rad2deg)
sin = _unary(torch.sin)
sinc = _unary(torch.sinc)
sinh = _unary(torch.sinh)
tan = _unary(torch.tan)
tanh = _unary(torch.tanh)


def arctan2(t1, t2) -> DNDarray:
    return _binary_op(lambda a, b: torch.arctan2(*_floating(a, b)), t1, t2)


atan2 = arctan2

for _n in ("sin", "cos", "tan", "sinh", "cosh", "tanh", "arcsin", "arccos", "arctan"):
    setattr(DNDarray, _n, globals()[_n])
