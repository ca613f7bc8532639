"""Logical operations (reference: ``heat_tpu/core/logical.py``).

``all``, ``any`` and ``count_nonzero`` over the split axis Allreduce the
ranks' partials (minimum, maximum, sum); ``allclose`` and the ``array_*``
tests reduce to one Python bool on every rank.
"""

from __future__ import annotations

import numpy as np
import torch

from . import types
from ._operations import Reduction, _binary_op, _local_op, _reduce_op
from .arithmetics import _tensors
from .dndarray import DNDarray

__all__ = [
    "all",
    "allclose",
    "any",
    "count_nonzero",
    "isclose",
    "isfinite",
    "isinf",
    "isnan",
    "isneginf",
    "isposinf",
    "logical_and",
    "logical_not",
    "logical_or",
    "logical_xor",
    "signbit",
]


def _each_dim(fn):
    def local(t, dims, keepdim):
        t = t.bool()
        for d in sorted(dims, reverse=True):
            t = fn(t, dim=d, keepdim=keepdim)
        return t

    return local


_ALL = Reduction(_each_dim(torch.all), "min", lambda dt: torch.bool)
_ANY = Reduction(_each_dim(torch.any), "max", lambda dt: torch.bool)
_COUNT = Reduction(lambda t, d, k: torch.sum(t != 0, dim=d, keepdim=k), "sum", lambda dt: torch.int32)


def all(x, axis=None, out=None, keepdims=False) -> DNDarray:
    """True where all elements along ``axis`` are truthy."""
    return _reduce_op(_ALL, x, axis=axis, keepdims=keepdims, out=out)


def any(x, axis=None, out=None, keepdims=False) -> DNDarray:
    return _reduce_op(_ANY, x, axis=axis, keepdims=keepdims, out=out)


def count_nonzero(x, axis=None, keepdims=False) -> DNDarray:
    """The number of non-zero elements along ``axis`` (int32)."""
    return _reduce_op(_COUNT, x, axis=axis, keepdims=keepdims)


def allclose(x, y, rtol: float = 1e-05, atol: float = 1e-08, equal_nan: bool = False) -> bool:
    """True iff ``isclose`` holds everywhere (one Python bool on every rank)."""
    return bool(all(isclose(x, y, rtol=rtol, atol=atol, equal_nan=equal_nan)).item())


def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False) -> DNDarray:
    return _binary_op(lambda a, b: torch.isclose(*_tensors(a, b), rtol=rtol, atol=atol, equal_nan=equal_nan), x, y)


def isfinite(x) -> DNDarray:
    return _local_op(torch.isfinite, x)


def isinf(x) -> DNDarray:
    return _local_op(torch.isinf, x)


def isnan(x) -> DNDarray:
    return _local_op(torch.isnan, x)


def isneginf(x, out=None) -> DNDarray:
    return _local_op(torch.isneginf, x, out=out)


def isposinf(x, out=None) -> DNDarray:
    return _local_op(torch.isposinf, x, out=out)


def logical_and(t1, t2) -> DNDarray:
    return _binary_op(lambda a, b: torch.logical_and(*_tensors(a, b)), t1, t2)


def logical_not(x, out=None) -> DNDarray:
    return _local_op(torch.logical_not, x, out=out)


def logical_or(t1, t2) -> DNDarray:
    return _binary_op(lambda a, b: torch.logical_or(*_tensors(a, b)), t1, t2)


def logical_xor(t1, t2) -> DNDarray:
    return _binary_op(lambda a, b: torch.logical_xor(*_tensors(a, b)), t1, t2)


def signbit(x, out=None) -> DNDarray:
    return _local_op(torch.signbit, x, out=out)


DNDarray.all = all
DNDarray.any = any
DNDarray.allclose = allclose
DNDarray.isclose = isclose


def _as_dnd(a, proto):
    if isinstance(a, DNDarray):
        return a
    from . import factories

    return factories.array(np.asarray(a), device=proto.device, comm=proto.comm)


def array_equal(a1, a2) -> bool:
    """True iff the shapes match and all elements are equal."""
    proto = a1 if isinstance(a1, DNDarray) else a2
    a1, a2 = _as_dnd(a1, proto), _as_dnd(a2, proto)
    if a1.shape != a2.shape:
        return False
    return bool(all(_binary_op(torch.eq, a1, a2)).item())


def array_equiv(a1, a2) -> bool:
    """True iff the inputs broadcast together and are equal everywhere."""
    proto = a1 if isinstance(a1, DNDarray) else a2
    a1, a2 = _as_dnd(a1, proto), _as_dnd(a2, proto)
    try:
        np.broadcast_shapes(a1.shape, a2.shape)
    except ValueError:
        return False
    return bool(all(_binary_op(torch.eq, a1, a2)).item())


def isin(element, test_elements, assume_unique: bool = False, invert: bool = False) -> DNDarray:
    """Elementwise membership of ``element`` in ``test_elements`` (which every
    rank holds whole), compared in the two's promoted dtype (so uint8 254 is
    not -2); split as ``element``."""
    if isinstance(test_elements, DNDarray):
        tests = (test_elements.resplit(None) if test_elements.is_distributed() else test_elements).larray
    else:  # as the JAX package takes numpy and Python data: 64 bits narrowed to 32
        from .factories import narrow_64bit

        tests = torch.as_tensor(narrow_64bit(np.asarray(test_elements)))

    def fn(t):
        tt = tests.to(t.device).reshape(-1)
        dt = torch.promote_types(t.dtype, tt.dtype)
        dt = torch.uint8 if dt == torch.bool else dt  # torch.isin takes no bools
        return torch.isin(t.to(dt), tt.to(dt), invert=invert)

    return _local_op(fn, element)


def in1d(ar1, ar2, assume_unique: bool = False, invert: bool = False) -> DNDarray:
    """1-D membership: ``isin`` on the flattened ``ar1`` (split 0 where
    ``ar1`` is split; rank order is the flat order along split 0)."""
    if ar1.split not in (None, 0) and ar1.is_distributed():
        ar1 = ar1.resplit(0)
    flat = ar1.larray.reshape(-1)
    width = int(np.prod(ar1.gshape[1:], dtype=np.int64))
    split = 0 if ar1.split is not None else None
    flat = DNDarray(flat, (ar1.size,), ar1.dtype, split, ar1.device, ar1.comm, ar1.balanced and width == 1)
    return isin(flat, ar2, assume_unique=assume_unique, invert=invert)


def iscomplexobj(x) -> bool:
    if isinstance(x, DNDarray):
        return issubclass(x.dtype, types.complexfloating)
    return np.iscomplexobj(x)


def isrealobj(x) -> bool:
    return not iscomplexobj(x)


def isscalar(x) -> bool:
    """numpy.isscalar semantics: Python and numpy scalars, not 0-d arrays."""
    if isinstance(x, DNDarray):
        return False
    return np.isscalar(x)


__all__ += ["array_equal", "array_equiv", "in1d", "iscomplexobj", "isin", "isrealobj", "isscalar"]
