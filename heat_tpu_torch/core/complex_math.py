"""Complex number operations (reference: ``heat/core/complex_math.py``)."""

from __future__ import annotations

import math

import torch

from ._operations import _local_op
from .dndarray import DNDarray

__all__ = ["angle", "conj", "conjugate", "imag", "real"]


def angle(x, deg: bool = False, out=None) -> DNDarray:
    """The phase angle of each element, in radians (degrees with ``deg``)."""
    return _local_op(lambda t: torch.angle(t) * (180.0 / math.pi) if deg else torch.angle(t), x, out=out)


def conjugate(x, out=None) -> DNDarray:
    """The complex conjugate of each element."""
    return _local_op(lambda t: torch.conj_physical(t) if t.is_complex() else t.clone(), x, out=out)


conj = conjugate


def imag(x, out=None) -> DNDarray:
    """The imaginary part of each element (zeros of a real array)."""
    return _local_op(lambda t: torch.imag(t).clone() if t.is_complex() else torch.zeros_like(t), x, out=out)


def real(x, out=None) -> DNDarray:
    """The real part of each element (a copy of a real array)."""
    return _local_op(lambda t: torch.real(t).clone(), x, out=out)


DNDarray.conj = conjugate
