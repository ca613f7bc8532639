"""Array factories (reference: ``heat/core/factories.py``).

Each factory builds only this process's chunk of the array, directly on the
target device.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from . import types
from .communication import Communication, sanitize_comm
from .devices import sanitize_device
from .dndarray import DNDarray
from .stride_tricks import sanitize_axis, sanitize_shape

__all__ = ["arange", "array", "asarray", "empty", "full", "ones", "zeros"]


def _sanitize(device, comm):
    device = sanitize_device(device)
    return device, device.torch_device, sanitize_comm(comm)


def array(
    obj,
    dtype=None,
    copy: Optional[bool] = None,
    ndmin: int = 0,
    order: str = "C",
    split: Optional[int] = None,
    is_split: Optional[int] = None,
    device=None,
    comm: Optional[Communication] = None,
) -> DNDarray:
    """Create a DNDarray from array-like data.

    ``split=k`` treats ``obj`` as the GLOBAL array and keeps this rank's
    chunk of axis ``k``; ``is_split=k`` treats ``obj`` as this rank's LOCAL
    chunk along ``k`` and derives the global shape from all ranks.
    A Python scalar or list of floats becomes float32, as in torch.
    """
    if split is not None and is_split is not None:
        raise ValueError("split and is_split are mutually exclusive")
    if isinstance(obj, DNDarray):
        device = obj.device if device is None else device
        comm = obj.comm if comm is None else comm
        if split is None and is_split is None:
            split = obj.split
        if obj.is_distributed() and split != obj.split:
            raise NotImplementedError("changing the split of a distributed array (resplit) is not ported yet")
        t = obj.larray
        if obj.is_distributed():
            is_split, split = obj.split, None
    elif isinstance(obj, torch.Tensor):
        t = obj
    else:
        npa = np.asarray(obj)
        if npa.dtype == object:
            raise TypeError("invalid data of type object")
        if not isinstance(obj, np.ndarray) and npa.dtype == np.float64:
            npa = npa.astype(np.float32)
        t = torch.from_numpy(np.array(npa, order="C", copy=not npa.flags.writeable))
    device, tdev, comm = _sanitize(device, comm)
    if dtype is not None:
        dtype = types.canonical_heat_type(dtype)
        t = t.to(dtype.torch_type())
    while t.ndim < ndmin:
        t = t.unsqueeze(0)

    if is_split is not None:
        is_split = sanitize_axis(tuple(t.shape), is_split)
        t = t.to(device=tdev, copy=copy is not False).contiguous()
        size = torch.tensor([t.shape[is_split]], dtype=torch.int64, device=tdev)
        counts = [int(c.item()) for c in comm.Allgather(size)]
        gshape = tuple(t.shape[:is_split]) + (sum(counts),) + tuple(t.shape[is_split + 1 :])
        balanced = tuple(counts) == comm.counts_displs_shape(gshape, is_split)[0]
        return DNDarray(t, gshape, types.canonical_heat_type(t.dtype), is_split, device, comm, balanced)

    split = sanitize_axis(tuple(t.shape), split)
    gshape = tuple(t.shape)
    if split is not None:
        t = t[comm.chunk(gshape, split)[2]]
    t = t.to(device=tdev, copy=copy is not False).contiguous()
    return DNDarray(t, gshape, types.canonical_heat_type(t.dtype), split, device, comm, True)


def asarray(obj, dtype=None, copy=None, order="C", is_split=None, device=None) -> DNDarray:
    return array(obj, dtype=dtype, copy=copy, order=order, is_split=is_split, device=device)


def _filled(fill, shape, dtype, split, device, comm) -> DNDarray:
    shape = sanitize_shape(shape)
    split = sanitize_axis(shape, split)
    dtype = types.canonical_heat_type(dtype)
    device, tdev, comm = _sanitize(device, comm)
    lshape = comm.chunk(shape, split)[1]
    t = fill(lshape, dtype=dtype.torch_type(), device=tdev)
    return DNDarray(t, shape, dtype, split, device, comm, True)


def zeros(shape, dtype=types.float32, split=None, device=None, comm=None, order="C") -> DNDarray:
    return _filled(torch.zeros, shape, dtype, split, device, comm)


def ones(shape, dtype=types.float32, split=None, device=None, comm=None, order="C") -> DNDarray:
    return _filled(torch.ones, shape, dtype, split, device, comm)


def empty(shape, dtype=types.float32, split=None, device=None, comm=None, order="C") -> DNDarray:
    return _filled(torch.empty, shape, dtype, split, device, comm)


def full(shape, fill_value, dtype=None, split=None, device=None, comm=None, order="C") -> DNDarray:
    if dtype is None:
        dtype = types.heat_type_of(fill_value)

    def fill(lshape, dtype, device):
        return torch.full(lshape, fill_value, dtype=dtype, device=device)

    return _filled(fill, shape, dtype, split, device, comm)


def arange(*args, dtype=None, split=None, device=None, comm=None) -> DNDarray:
    """``arange([start,] stop[, step])`` with only this rank's chunk built."""
    if not 1 <= len(args) <= 3:
        raise TypeError(f"arange takes 1 to 3 positional arguments, got {len(args)}")
    start, stop, step = (0, args[0], 1) if len(args) == 1 else (args + (1,))[:3]
    if step == 0:
        raise ValueError("arange: step must not be 0")
    num = max(int(math.ceil((stop - start) / step)), 0)
    if dtype is None:
        exact = all(isinstance(a, (int, np.integer)) for a in (start, stop, step))
        dtype = types.int32 if exact else types.float32
    dtype = types.canonical_heat_type(dtype)
    device, tdev, comm = _sanitize(device, comm)
    split = sanitize_axis((num,), split)
    off, (cnt,), _ = comm.chunk((num,), split)
    idx = torch.arange(off, off + cnt, device=tdev, dtype=torch.float64)
    t = (start + idx * step).to(dtype.torch_type())
    return DNDarray(t, (num,), dtype, split, device, comm, True)
