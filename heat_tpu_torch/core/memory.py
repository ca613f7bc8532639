"""Memory operations (reference: ``heat_tpu/core/memory.py``)."""

from __future__ import annotations

__all__ = ["copy", "sanitize_memory_layout"]


def copy(x):
    """A deep copy of the array: its local tensor cloned, the metadata kept."""
    from .dndarray import DNDarray

    if not isinstance(x, DNDarray):
        raise TypeError(f"input needs to be a DNDarray, got {type(x)}")
    return DNDarray(x.larray.clone(), x.gshape, x.dtype, x.split, x.device, x.comm, x.balanced)


def sanitize_memory_layout(x, order: str = "C"):
    """Validate the memory order flag; local tensors are kept in row-major
    (C) order, and ``'F'`` is accepted as the JAX package accepts it."""
    if order not in ("C", "F"):
        raise ValueError(f"Unsupported memory layout {order!r}, expected 'C' or 'F'")
    return x
