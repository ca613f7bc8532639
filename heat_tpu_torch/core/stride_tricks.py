"""Shape/axis sanitation helpers (reference: ``heat/core/stride_tricks.py``)."""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np

__all__ = ["broadcast_shape", "sanitize_axis", "sanitize_shape"]


def broadcast_shape(shape_a: Tuple[int, ...], shape_b: Tuple[int, ...]) -> Tuple[int, ...]:
    """The NumPy-broadcast result shape of two shapes (raises on mismatch)."""
    return np.broadcast_shapes(tuple(shape_a), tuple(shape_b))


def sanitize_axis(
    shape: Tuple[int, ...], axis: Union[int, Tuple[int, ...], None]
) -> Union[int, Tuple[int, ...], None]:
    """Normalize ``axis`` against ``shape``: wrap negatives, validate bounds."""
    ndim = len(shape)
    if axis is None:
        return None
    if isinstance(axis, (list, tuple)):
        return tuple(sanitize_axis(shape, a) for a in axis)
    if not isinstance(axis, (int, np.integer)):
        raise TypeError(f"axis must be None or int or tuple of ints, got {type(axis)}")
    axis = int(axis)
    if ndim == 0 and axis in (-1, 0):
        return axis
    if axis < -ndim or axis >= ndim:
        raise ValueError(f"axis {axis} is out of bounds for {ndim}-dimensional array")
    return axis % ndim if ndim else axis


def sanitize_shape(shape, lval: int = 0) -> Tuple[int, ...]:
    """Normalize a shape argument to a tuple of non-negative ints."""
    if isinstance(shape, (int, np.integer)):
        shape = (int(shape),)
    shape = tuple(int(s) for s in shape)
    for s in shape:
        if s < lval:
            raise ValueError(f"negative dimensions are not allowed, got {shape}")
    return shape
