"""The heat_tpu_torch type system.

The same contract as ``heat_tpu.core.types``: a small class hierarchy of
canonical types (``ht.bool`` … ``ht.complex128``) with NumPy-style
promotion, mapped onto torch dtypes.  Only the types torch stores natively
exist here (no unsigned types wider than 8 bits).  ``bfloat16`` is
first-class.
"""

from __future__ import annotations

import builtins
from typing import Type

import numpy as np
import torch

__all__ = [
    "datatype",
    "generic",
    "number",
    "integer",
    "signedinteger",
    "unsignedinteger",
    "floating",
    "flexible",
    "complexfloating",
    "bool",
    "bool_",
    "uint8",
    "ubyte",
    "int8",
    "byte",
    "int16",
    "short",
    "int32",
    "int",
    "int_",
    "int64",
    "long",
    "bfloat16",
    "float16",
    "half",
    "float32",
    "float",
    "float_",
    "float64",
    "double",
    "complex64",
    "cfloat",
    "complex128",
    "cdouble",
    "canonical_heat_type",
    "heat_type_of",
    "promote_types",
]


class datatype:
    """Base class of the scalar type hierarchy (``ht.generic``)."""

    _name: str = None  # dtype name of the concrete leaf classes

    def __new__(cls, *value, device=None, comm=None):
        # instantiation casts: ht.float32(x) == ht.array(x, dtype=ht.float32)
        from . import factories

        if len(value) == 0:
            value = (0,)
        if len(value) == 1:
            return factories.array(value[0], dtype=cls, device=device, comm=comm)
        raise TypeError(f"takes at most 1 argument, got {len(value)}")

    @classmethod
    def torch_type(cls) -> torch.dtype:
        return getattr(torch, cls._name)


generic = datatype


class bool(datatype):
    _name = "bool"


class number(datatype):
    pass


class integer(number):
    pass


class signedinteger(integer):
    pass


class unsignedinteger(integer):
    pass


class floating(number):
    pass


class flexible(datatype):
    pass


class complexfloating(number):
    pass


class uint8(unsignedinteger):
    _name = "uint8"


class int8(signedinteger):
    _name = "int8"


class int16(signedinteger):
    _name = "int16"


class int32(signedinteger):
    _name = "int32"


class int64(signedinteger):
    _name = "int64"


class bfloat16(floating):
    _name = "bfloat16"


class float16(floating):
    _name = "float16"


class float32(floating):
    _name = "float32"


class float64(floating):
    _name = "float64"


class complex64(complexfloating):
    _name = "complex64"


class complex128(complexfloating):
    _name = "complex128"


# aliases (reference-compatible)
bool_ = bool
ubyte = uint8
byte = int8
short = int16
int = int32
int_ = int32
long = int64
half = float16
float = float32
float_ = float32
double = float64
cfloat = complex64
cdouble = complex128


_HEAT_TYPES = [
    bool,
    uint8,
    int8,
    int16,
    int32,
    int64,
    bfloat16,
    float16,
    float32,
    float64,
    complex64,
    complex128,
]

# python-builtin / numpy / torch dtype / name → heat type
_CANONICAL = {}
for _t in _HEAT_TYPES:
    _CANONICAL[_t] = _t
    _CANONICAL[_t._name] = _t
    _CANONICAL[_t.torch_type()] = _t
    if _t is not bfloat16:
        _CANONICAL[np.dtype(_t._name)] = _t
        _CANONICAL[np.dtype(_t._name).type] = _t
_CANONICAL[builtins.bool] = bool
_CANONICAL[builtins.int] = int32
_CANONICAL[builtins.float] = float32
_CANONICAL[builtins.complex] = complex64


def canonical_heat_type(a_type) -> Type[datatype]:
    """Resolve any dtype-like object to the canonical heat type class."""
    try:
        return _CANONICAL[a_type]
    except (KeyError, TypeError):
        pass
    try:
        return _CANONICAL[np.dtype(a_type)]
    except (KeyError, TypeError):
        raise TypeError(f"Data type {a_type!r} is not understood") from None


def heat_type_of(obj) -> Type[datatype]:
    """The heat type of ``obj``'s elements (DNDarray / tensor / numpy / scalars / sequences)."""
    dt = getattr(obj, "dtype", None)
    if dt is not None:
        return canonical_heat_type(dt)
    if isinstance(obj, (builtins.bool, builtins.int, builtins.float, builtins.complex)):
        return canonical_heat_type(type(obj))
    if isinstance(obj, (list, tuple)):
        return canonical_heat_type(np.asarray(obj).dtype)
    raise TypeError(f"Cannot determine heat type of {type(obj)}")


def promote_types(type1, type2) -> Type[datatype]:
    """Type promotion over heat types, by torch's table (bfloat16-aware)."""
    t1, t2 = canonical_heat_type(type1), canonical_heat_type(type2)
    return canonical_heat_type(torch.promote_types(t1.torch_type(), t2.torch_type()))
