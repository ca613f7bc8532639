"""Signal processing (reference: ``heat/core/signal.py``): ``convolve``,
``convolve2d`` and ``correlate`` with numpy's modes.

A signal split along the axis it is convolved over takes HeAT's halo
route: each rank extends its chunk with the ``m - 1`` elements before and
after it (``parallel.halo.halo_exchange``; zeros at the global edges) and
runs one local valid convolution (``torch.nn.functional.conv1d``/``conv2d``
with the filter flipped), which gives rows ``G[lo : lo + c + m - 1]`` of
the full convolution G; the rank keeps the rows of the mode that it owns,
and the result is moved to ``chunk``'s layout.  Nothing is gathered but the
filter, which every rank needs whole.  Products run in IEEE float32 (cuDNN
would take TF32 by default).  Integer and bool inputs convolve exactly in
float64, where every sum is below 2^53, and raise past it (no CUDA
convolution takes integers).  The result's split follows the signal, also
where the operands swap because the filter is the longer one.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from . import types
from .dndarray import DNDarray

__all__ = ["convolve", "convolve2d", "correlate"]

# an exact float64 sum: every partial sum stays below 2^53
_EXACT = float(2**53)


def _as_dnd(x, proto=None) -> DNDarray:
    from . import factories

    if isinstance(x, DNDarray):
        return x
    if proto is not None:
        return factories.array(x, device=proto.device, comm=proto.comm)
    return factories.array(x)


def _whole(v: DNDarray) -> torch.Tensor:
    return (v.resplit(None) if v.is_distributed() else v).larray


def _work_dtype(dt) -> torch.dtype:
    """The dtype a convolution of ``dt`` computes in: float64 for the exact
    types, else dt's own (complex too)."""
    if types.heat_type_is_exact(dt):
        return torch.float64
    return dt.torch_type()


def _check_exact(a: DNDarray, vt: torch.Tensor) -> None:
    """Raise where a sum of the integer convolution could pass 2^53."""
    amax = a.larray.abs().max() if a.larray.numel() else a.larray.new_zeros(())
    amax = amax.to(torch.float64).reshape(1)
    if a.is_distributed():
        amax = a.comm.Allreduce(amax, "max")
    bound = float(amax.item()) * float(vt.abs().sum().item())
    if bound >= _EXACT:
        raise ValueError(f"integer convolution could reach {bound:.3g}, past the 2^53 of its exact float64 route")


def _local_conv(ext: torch.Tensor, v: torch.Tensor, pads) -> torch.Tensor:
    """The valid convolution of ``ext`` (padded by ``pads`` = (lo, hi) a
    dimension) with ``v``, in ext's dtype."""
    flat = [p for lo_hi in reversed(pads) for p in lo_hi]
    if any(flat):
        ext = F.pad(ext, flat)
    w = torch.flip(v, tuple(range(v.ndim))).to(ext.dtype)
    conv = F.conv1d if ext.ndim == 1 else F.conv2d
    return conv(ext[None, None], w[None, None])[0, 0]


def _mode_range(mode: str, n: int, m: int, same_offset: int) -> Tuple[int, int]:
    """The rows [lo, hi) of the full convolution G (of n + m - 1 rows) that
    ``mode`` keeps."""
    if mode == "full":
        return 0, n + m - 1
    if mode == "same":
        return same_offset, same_offset + n
    return m - 1, n


def _pads(mode: str, m: int, same_offset: int) -> Tuple[int, int]:
    """(lo, hi) zero padding of an axis that is not split, for ``mode``."""
    if mode == "full":
        return m - 1, m - 1
    if mode == "same":
        return m - 1 - same_offset, same_offset
    return 0, 0


def _convolve_along(a: DNDarray, vt: torch.Tensor, mode: str, same_offsets, out_dtype) -> DNDarray:
    """Convolve ``a`` (1-D or 2-D) with the whole filter ``vt``.  A split
    axis goes through halos; the other axes are padded for ``mode``."""
    from ..parallel.halo import halo_exchange

    work = vt.dtype
    shape = list(a.shape)
    m = list(vt.shape)
    split = a.split if a.is_distributed() else None
    pads = [_pads(mode, m[d], same_offsets[d]) for d in range(a.ndim)]
    out_shape = [hi - lo for lo, hi in (_mode_range(mode, shape[d], m[d], same_offsets[d]) for d in range(a.ndim))]
    from ..linalg.basics import _full_float32

    if split is None:
        with _full_float32():
            res = _local_conv(a.larray.to(work), vt, pads)
        res = res.to(out_dtype)
        out = DNDarray(res, tuple(out_shape), types.canonical_heat_type(out_dtype), None, a.device, a.comm, True)
        return out
    comm = a.comm
    counts, displs = a.counts_displs()
    r = comm.rank
    lo, c = displs[r], counts[r]
    h = m[split] - 1
    blk = a.larray.to(work)
    prev, nxt = halo_exchange(blk, h, comm, split, counts)
    ext = torch.cat([prev, blk, nxt], split)
    pads[split] = (0, 0)
    with _full_float32():
        g = _local_conv(ext, vt, pads)  # rows G[lo : lo + c + h] of the split axis
    # the rows of the mode this rank owns: [lo, lo + c) of G, and the last
    # rank also the tail past n
    own_lo, own_hi = lo, lo + c if r + 1 < comm.size else shape[split] + h
    keep_lo, keep_hi = _mode_range(mode, shape[split], m[split], same_offsets[split])
    if mode == "same":  # a rank's rows of the result are its own rows of the signal, shifted
        a_lo, a_hi = lo + keep_lo, lo + keep_lo + c
    else:
        a_lo, a_hi = max(own_lo, keep_lo), min(own_hi, keep_hi)
    a_hi = max(a_hi, a_lo)
    res = g.narrow(split, a_lo - lo, a_hi - a_lo).to(out_dtype).contiguous()
    out = DNDarray(res, tuple(out_shape), types.canonical_heat_type(out_dtype), split, a.device, comm,
                   mode == "same" and a.balanced)
    out.balance_()
    return out


def _finish(res: DNDarray, dt, signal: DNDarray) -> DNDarray:
    """Round an exact type's result back to it, and split it as the signal."""
    if types.heat_type_is_exact(dt):
        t = torch.round(res.larray).to(dt.torch_type())
        res = DNDarray(t, res.shape, dt, res.split, res.device, res.comm, res.balanced)
    want = signal.split if signal.split is not None and signal.split < res.ndim else None
    if res.split != want:
        if res.is_distributed() or want is None:
            res = res.resplit(want)
        else:
            from .factories import array

            res = array(res.larray, split=want, device=res.device, comm=res.comm)
    return res


def convolve(a, v, mode: str = "full", stride: int = 1) -> DNDarray:
    """Discrete 1-D convolution of ``a`` with ``v`` (numpy's modes
    ``'full'``, ``'same'``, ``'valid'``).  The longer operand is the signal
    that is convolved; the result is split as ``a``."""
    a = _as_dnd(a)
    v = _as_dnd(v, a)
    if a.ndim != 1 or v.ndim != 1:
        raise ValueError("convolve requires 1-D inputs")
    if mode not in ("full", "same", "valid"):
        raise ValueError(f"Unsupported mode {mode!r}")
    if stride != 1:
        raise NotImplementedError("stride != 1 not supported (reference parity)")
    signal = a
    if a.shape[0] < v.shape[0]:
        a, v = v, a
    dt = types.promote_types(a.dtype, v.dtype)
    work = _work_dtype(dt)
    vt = _whole(v).to(work)
    if a.larray.device != vt.device:
        vt = vt.to(a.larray.device)
    if types.heat_type_is_exact(dt):
        _check_exact(a, vt)
    out_dtype = work
    res = _convolve_along(a, vt, mode, ((vt.shape[0] - 1) // 2,), out_dtype)
    return _finish(res, dt, signal)


def convolve2d(a, v, mode: str = "full") -> DNDarray:
    """2-D convolution (beyond the reference's 1-D surface) with numpy's
    modes (``'same'`` centred as scipy's ``convolve2d``); split as ``a``.
    Integer and bool inputs give float32, the reference's dtype."""
    a = _as_dnd(a)
    v = _as_dnd(v, a)
    if a.ndim != 2 or v.ndim != 2:
        raise ValueError("convolve2d requires 2-D inputs")
    if mode not in ("full", "same", "valid"):
        raise ValueError(f"Unsupported mode {mode!r}")
    dt = types.promote_types(a.dtype, v.dtype)
    exact = types.heat_type_is_exact(dt)
    work = _work_dtype(dt)
    vt = _whole(v).to(work).to(a.larray.device)
    if exact:
        _check_exact(a, vt)
    res = _convolve_along(a, vt, mode, (vt.shape[0] // 2, vt.shape[1] // 2), work)
    if exact:
        res = res.astype(types.float32)
    return _finish(res, res.dtype, a)


def correlate(a, v, mode: str = "valid") -> DNDarray:
    """Cross-correlation of 1-D sequences, numpy's ``correlate``: ``a`` with
    ``v`` reversed (and conjugated), through :func:`convolve`."""
    from . import manipulations

    a = _as_dnd(a)
    v = _as_dnd(v, a)
    flipped = manipulations.flip(v, 0)
    if types.heat_type_is_complexfloating(flipped.dtype):
        from .complex_math import conjugate

        flipped = conjugate(flipped)
    return convolve(a, flipped, mode=mode)
