"""The heat_tpu_torch type system.

The same contract as ``heat_tpu.core.types``: a small class hierarchy of
canonical types (``ht.bool`` … ``ht.complex128``) with NumPy-style
promotion, mapped onto torch dtypes.  Only the types torch stores natively
exist here (no unsigned types wider than 8 bits).  ``bfloat16`` is
first-class.  The 64-bit types are kept where asked for (the JAX package,
with 64-bit types off, narrows them to 32 bits), so ``result_type`` and
``promote_types`` of a 64-bit type answer with a 64-bit one where the JAX
package answers with 32 bits.
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
    "heat_type_is_exact",
    "heat_type_is_inexact",
    "heat_type_is_complexfloating",
    "issubdtype",
    "promote_types",
    "result_type",
    "can_cast",
    "iscomplex",
    "isreal",
    "finfo",
    "iinfo",
    "isdtype",
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


def issubdtype(arg1, arg2) -> builtins.bool:
    """numpy's ``issubdtype`` over the heat class hierarchy."""
    if not isinstance(arg1, type) or not issubclass(arg1, datatype):
        arg1 = canonical_heat_type(arg1)
    if isinstance(arg2, type) and issubclass(arg2, datatype):
        return issubclass(arg1, arg2)
    return issubclass(arg1, canonical_heat_type(arg2))


def heat_type_is_exact(ht_dtype) -> builtins.bool:
    """True for the integer types and bool."""
    t = canonical_heat_type(ht_dtype)
    return issubclass(t, integer) or t is bool


def heat_type_is_inexact(ht_dtype) -> builtins.bool:
    """True for the floating and complex types."""
    return issubclass(canonical_heat_type(ht_dtype), (floating, complexfloating))


def heat_type_is_complexfloating(ht_dtype) -> builtins.bool:
    return issubclass(canonical_heat_type(ht_dtype), complexfloating)


def result_type(*operands) -> Type[datatype]:
    """The type of combining ``operands`` (heat types, dtypes, arrays or
    Python scalars): arrays and types promote by :func:`promote_types`, and a
    Python scalar takes part only by its kind (bool < int < float <
    complex), lifting the result to the default type of a higher kind."""
    types_, kinds = [], []
    for o in operands:
        if isinstance(o, (builtins.bool, builtins.int, builtins.float, builtins.complex)):
            kinds.append(_KINDS.index(type(o)))
        elif isinstance(o, type) and issubclass(o, datatype):
            types_.append(o)
        else:
            types_.append(canonical_heat_type(o if isinstance(o, (type, str, np.dtype)) else getattr(o, "dtype", o)))
    if not types_:
        return canonical_heat_type(_KINDS[max(kinds)])
    out = types_[0]
    for t in types_[1:]:
        out = promote_types(out, t)
    if kinds and max(kinds) > _kind(out):
        out = promote_types(out, canonical_heat_type(_KINDS[max(kinds)]))
    return out


_KINDS = [builtins.bool, builtins.int, builtins.float, builtins.complex]


def _kind(t) -> builtins.int:
    """0 for bool, 1 for the integers, 2 for the floating types, 3 for complex."""
    return 0 if t is bool else 1 if issubclass(t, integer) else 2 if issubclass(t, floating) else 3


def _np_dtype(t) -> np.dtype:
    """numpy's dtype of heat type ``t`` (bfloat16 as float32, which numpy
    lacks)."""
    return np.dtype("float32" if t is bfloat16 else t._name)


def can_cast(from_, to, casting: str = "safe") -> builtins.bool:
    """numpy's ``can_cast`` over heat types ('intuitive' as 'safe'; a Python
    scalar by its heat type)."""
    if casting == "unsafe":
        return True
    if isinstance(from_, (builtins.int, builtins.float, builtins.complex, builtins.bool)):
        f = heat_type_of(from_)
    else:
        f = canonical_heat_type(from_)
    fd, td = _np_dtype(f), _np_dtype(canonical_heat_type(to))
    if casting == "same_kind":
        return np.can_cast(fd, td, casting="same_kind")
    if casting in ("safe", "intuitive"):
        return np.can_cast(fd, td, casting="safe")
    raise ValueError(f"Unknown casting mode {casting}")


def iscomplex(x):
    """Element-wise: whether the element has a non-zero imaginary part."""
    from . import _operations, factories
    from .dndarray import DNDarray

    if not isinstance(x, DNDarray):
        x = factories.array(x)
    if heat_type_is_complexfloating(x.dtype):
        return _operations._local_op(lambda t: torch.imag(t) != 0, x)
    return factories.zeros(x.shape, dtype=bool, split=x.split, device=x.device, comm=x.comm)


def isreal(x):
    """Element-wise: whether the element's imaginary part is zero."""
    from .logical import logical_not

    return logical_not(iscomplex(x))


class finfo:
    """Machine limits of a floating heat type (``np.finfo``): ``bits``,
    ``eps``, ``max``, ``min`` and ``tiny``."""

    def __new__(cls, dtype):
        t = canonical_heat_type(dtype)
        if not issubclass(t, (floating, complexfloating)):
            raise TypeError(f"Data type {dtype} not inexact")
        info = torch.finfo(t.torch_type())
        self = object.__new__(cls)
        self.bits = info.bits
        self.eps = builtins.float(info.eps)
        self.max = builtins.float(info.max)
        self.min = builtins.float(info.min)
        self.tiny = builtins.float(info.tiny)
        return self


class iinfo:
    """Machine limits of an integer heat type (``np.iinfo``): ``bits``,
    ``max`` and ``min``."""

    def __new__(cls, dtype):
        t = canonical_heat_type(dtype)
        if t is bool or not issubclass(t, integer):
            raise TypeError(f"Data type {dtype} not an integer type")
        info = torch.iinfo(t.torch_type())
        self = object.__new__(cls)
        self.bits = info.bits
        self.max = builtins.int(info.max)
        self.min = builtins.int(info.min)
        return self


_ISDTYPE_KINDS = {
    "bool": (bool,),
    "signed integer": (signedinteger,),
    "unsigned integer": (unsignedinteger,),
    "integral": (integer,),
    "real floating": (floating,),
    "complex floating": (complexfloating,),
    "numeric": (number,),
}


def isdtype(dtype, kind) -> builtins.bool:
    """The array API's ``isdtype``: whether ``dtype`` is of ``kind``, a kind's
    name ('bool', 'signed integer', 'unsigned integer', 'integral', 'real
    floating', 'complex floating', 'numeric'), a dtype, or a tuple of
    these."""
    t = canonical_heat_type(dtype)
    if isinstance(kind, tuple):
        return any(isdtype(t, k) for k in kind)
    if isinstance(kind, str):
        if kind not in _ISDTYPE_KINDS:
            raise ValueError(f"kind argument is a string, but {kind!r} is not a known kind name")
        return issubclass(t, _ISDTYPE_KINDS[kind]) and not (kind == "numeric" and t is bool)
    return t is canonical_heat_type(kind)
