"""Relational operations (reference: ``heat_tpu/core/relational.py``).

Binding ``__eq__`` makes ``DNDarray`` unhashable (``__hash__ = None``), as in
the JAX package: no DNDarray is a dict key or a set member in this package.
"""

from __future__ import annotations

import torch

from ._operations import _binary_op
from .dndarray import DNDarray

__all__ = ["eq", "equal", "ge", "greater_equal", "gt", "greater", "le", "less_equal", "lt", "less", "ne", "not_equal"]


def eq(t1, t2) -> DNDarray:
    """Elementwise ``t1 == t2`` (bool result)."""
    return _binary_op(torch.eq, t1, t2)


def equal(t1, t2) -> bool:
    """True iff the operands broadcast and are equal everywhere (a Python
    bool, reduced over the ranks)."""
    from .logical import all as ht_all

    try:
        res = eq(t1, t2)
    except (ValueError, RuntimeError):
        return False
    return bool(ht_all(res).item())


def ge(t1, t2) -> DNDarray:
    return _binary_op(torch.ge, t1, t2)


greater_equal = ge


def gt(t1, t2) -> DNDarray:
    return _binary_op(torch.gt, t1, t2)


greater = gt


def le(t1, t2) -> DNDarray:
    return _binary_op(torch.le, t1, t2)


less_equal = le


def lt(t1, t2) -> DNDarray:
    return _binary_op(torch.lt, t1, t2)


less = lt


def ne(t1, t2) -> DNDarray:
    return _binary_op(torch.ne, t1, t2)


not_equal = ne

DNDarray.__eq__ = lambda self, other: eq(self, other)
DNDarray.__ne__ = lambda self, other: ne(self, other)
DNDarray.__lt__ = lambda self, other: lt(self, other)
DNDarray.__le__ = lambda self, other: le(self, other)
DNDarray.__gt__ = lambda self, other: gt(self, other)
DNDarray.__ge__ = lambda self, other: ge(self, other)
DNDarray.__hash__ = None
