"""The FFT namespace (reference: ``heat/fft/fft.py``), over ``torch.fft``.

A transform along axes that do not hold the split runs on each rank's
chunk.  A transform that hits the split axis takes HeAT's transpose
method: the array is resplit to the first axis the transform leaves free,
transformed there, and resplit back (two Alltoalls, nothing gathered).
Where every axis is transformed, the split axis is gathered, with the
reference's implicit-gather warning, and the result split again.  Dtypes
follow the reference's (complex64 from float32 and the integers);
complex128 and float64 stay 64-bit, the port's 64-bit divergence.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core import types
from ..core.dndarray import DNDarray
from ..core.sanitation import sanitize_in

__all__ = [
    "fft", "fft2", "fftn", "fftfreq", "fftshift",
    "hfft", "hfft2", "hfftn",
    "ifft", "ifft2", "ifftn", "ifftshift", "ihfft", "ihfft2", "ihfftn",
    "irfft", "irfft2", "irfftn",
    "rfft", "rfft2", "rfftfreq", "rfftn",
]

# the routes taken (tests check that the transpose method engages)
fft_paths = {"transpose": 0, "direct": 0, "gather": 0}


def _input(t: torch.Tensor) -> torch.Tensor:
    """torch.fft takes floating and complex tensors: the exact types go as float32."""
    if t.is_floating_point() or t.is_complex():
        return t
    return t.to(torch.float32)


def _wrap(t: torch.Tensor, split: Optional[int], x: DNDarray, gaxis: Optional[int] = None) -> DNDarray:
    """A DNDarray of the local result ``t`` of a transform of x: the split
    axis (if any) keeps x's global extent, the other axes are whole."""
    t = t.resolve_conj()  # ihfft's result is a conjugate view
    if split is not None and split >= t.ndim:
        split = None
    gshape = list(t.shape)
    if split is not None and x.is_distributed():
        gshape[split] = x.shape[split] if gaxis is None else gaxis
    return DNDarray(t, tuple(gshape), types.canonical_heat_type(t.dtype), split, x.device, x.comm,
                    x.balanced if split is not None else True)


def _free_axis(x: DNDarray, busy) -> Optional[int]:
    """The first axis the transform leaves free, to carry the split."""
    for a in range(x.ndim):
        if a not in busy and x.shape[a] > 0:
            return a
    return None


def _run(x: DNDarray, busy, op) -> DNDarray:
    """``op(local tensor)`` on x's chunk, moving the split off the busy axes
    first where it is on one."""
    sanitize_in(x)
    if not x.is_distributed() or x.split not in busy:
        fft_paths["direct"] += 1
        return _wrap(op(_input(x.larray)), x.split, x)
    t = _free_axis(x, busy)
    if t is not None:
        fft_paths["transpose"] += 1
        xr = x.resplit(t)
        return _wrap(op(_input(xr.larray)), t, xr).resplit(x.split)
    fft_paths["gather"] += 1
    from ..core.manipulations import _warn_implicit_gather
    from ..core import factories

    _warn_implicit_gather("fft", x)
    res = op(_input(x.resplit(None).larray)).resolve_conj()
    return factories.array(res, split=x.split if x.split < res.ndim else None, device=x.device, comm=x.comm)


def _fft_op(name: str, x: DNDarray, n=None, axis=-1, norm=None) -> DNDarray:
    sanitize_in(x)
    op = getattr(torch.fft, name)
    axis_n = axis % max(x.ndim, 1)
    return _run(x, {axis_n}, lambda t: op(t, n=n, dim=axis, norm=norm))


def _busy_axes(x: DNDarray, s, axes):
    if axes is not None:
        return {a % x.ndim for a in (axes if isinstance(axes, (tuple, list)) else (axes,))}
    if s is not None:  # numpy's rule: with s and no axes, the last len(s) axes
        return set(range(x.ndim - len(s), x.ndim))
    return set(range(x.ndim))


def _fftn_op(name: str, x: DNDarray, s=None, axes=None, norm=None) -> DNDarray:
    sanitize_in(x)
    op = getattr(torch.fft, name)
    dim = axes
    if dim is None and s is not None:
        dim = tuple(range(x.ndim - len(s), x.ndim))
    return _run(x, _busy_axes(x, s, axes), lambda t: op(t, s=s, dim=dim, norm=norm))


def fft(x, n=None, axis=-1, norm=None) -> DNDarray:
    """1-D discrete Fourier transform along ``axis``."""
    return _fft_op("fft", x, n=n, axis=axis, norm=norm)


def ifft(x, n=None, axis=-1, norm=None) -> DNDarray:
    return _fft_op("ifft", x, n=n, axis=axis, norm=norm)


def rfft(x, n=None, axis=-1, norm=None) -> DNDarray:
    return _fft_op("rfft", x, n=n, axis=axis, norm=norm)


def irfft(x, n=None, axis=-1, norm=None) -> DNDarray:
    return _fft_op("irfft", x, n=n, axis=axis, norm=norm)


def hfft(x, n=None, axis=-1, norm=None) -> DNDarray:
    return _fft_op("hfft", x, n=n, axis=axis, norm=norm)


def ihfft(x, n=None, axis=-1, norm=None) -> DNDarray:
    return _fft_op("ihfft", x, n=n, axis=axis, norm=norm)


def fft2(x, s=None, axes=(-2, -1), norm=None) -> DNDarray:
    return _fftn_op("fft2", x, s=s, axes=axes, norm=norm)


def ifft2(x, s=None, axes=(-2, -1), norm=None) -> DNDarray:
    return _fftn_op("ifft2", x, s=s, axes=axes, norm=norm)


def rfft2(x, s=None, axes=(-2, -1), norm=None) -> DNDarray:
    return _fftn_op("rfft2", x, s=s, axes=axes, norm=norm)


def irfft2(x, s=None, axes=(-2, -1), norm=None) -> DNDarray:
    return _fftn_op("irfft2", x, s=s, axes=axes, norm=norm)


def fftn(x, s=None, axes=None, norm=None) -> DNDarray:
    return _fftn_op("fftn", x, s=s, axes=axes, norm=norm)


def ifftn(x, s=None, axes=None, norm=None) -> DNDarray:
    return _fftn_op("ifftn", x, s=s, axes=axes, norm=norm)


def rfftn(x, s=None, axes=None, norm=None) -> DNDarray:
    return _fftn_op("rfftn", x, s=s, axes=axes, norm=norm)


def irfftn(x, s=None, axes=None, norm=None) -> DNDarray:
    return _fftn_op("irfftn", x, s=s, axes=axes, norm=norm)


def _hfftn_op(x: DNDarray, s, axes, norm, inverse: bool) -> DNDarray:
    """The Hermitian n-D transforms composed axis by axis, as the reference
    composes them: the one-sided axis, the last of ``axes``, takes
    ``hfft``/``ihfft`` and every other axis a plain ``fft``/``ifft``, each
    with its own norm factor; ``ihfftn`` takes ``ihfft`` first, ``hfftn``
    its full axes first."""
    sanitize_in(x)
    nd = max(x.ndim, 1)
    if axes is None:
        axes = tuple(range(nd)) if s is None else tuple(range(nd - len(s), nd))
    elif not isinstance(axes, (tuple, list)):
        axes = (axes,)
    axes = tuple(a % nd for a in axes)
    if len(set(axes)) != len(axes):
        raise ValueError(f"axes must be unique, got {axes} on a {nd}-D array")
    if s is not None and len(s) != len(axes):
        raise ValueError(f"s and axes must have the same length, got {len(s)} != {len(axes)}")
    ss = list(s) if s is not None else [None] * len(axes)

    def run(t):
        if inverse:
            t = torch.fft.ihfft(t, n=ss[-1], dim=axes[-1], norm=norm)
            for a, n in zip(axes[:-1], ss[:-1]):
                t = torch.fft.ifft(t, n=n, dim=a, norm=norm)
        else:
            for a, n in zip(axes[:-1], ss[:-1]):
                t = torch.fft.fft(t, n=n, dim=a, norm=norm)
            t = torch.fft.hfft(t, n=ss[-1], dim=axes[-1], norm=norm)
        return t

    return _run(x, set(axes), run)


def hfft2(x, s=None, axes=(-2, -1), norm=None) -> DNDarray:
    return _hfftn_op(x, s, axes, norm, inverse=False)


def ihfft2(x, s=None, axes=(-2, -1), norm=None) -> DNDarray:
    return _hfftn_op(x, s, axes, norm, inverse=True)


def hfftn(x, s=None, axes=None, norm=None) -> DNDarray:
    """n-D FFT of a Hermitian-symmetric signal (one-sided last axis): real output."""
    return _hfftn_op(x, s, axes, norm, inverse=False)


def ihfftn(x, s=None, axes=None, norm=None) -> DNDarray:
    """Inverse of :func:`hfftn`: real input, one-sided complex output."""
    return _hfftn_op(x, s, axes, norm, inverse=True)


def _freq(fn, n: int, d: float, dtype, split, device, comm) -> DNDarray:
    from ..core import factories
    from ..core.devices import sanitize_device

    dev = sanitize_device(device)
    res = fn(n, d=d, dtype=torch.float32, device=dev.torch_device)
    return factories.array(res, dtype=dtype, split=split, device=dev, comm=comm)


def fftfreq(n: int, d: float = 1.0, dtype=None, split=None, device=None, comm=None) -> DNDarray:
    """The sample frequencies of an ``n``-point transform (float32)."""
    return _freq(torch.fft.fftfreq, n, d, dtype, split, device, comm)


def rfftfreq(n: int, d: float = 1.0, dtype=None, split=None, device=None, comm=None) -> DNDarray:
    return _freq(torch.fft.rfftfreq, n, d, dtype, split, device, comm)


def _shift(x: DNDarray, axes, sign: int) -> DNDarray:
    from ..core.manipulations import roll

    sanitize_in(x)
    if axes is None:
        axes = tuple(range(x.ndim))
    elif not isinstance(axes, (tuple, list)):
        axes = (axes,)
    axes = [a % x.ndim for a in axes]
    if sign > 0:
        shifts = [x.shape[a] // 2 for a in axes]
    else:
        shifts = [-(x.shape[a] // 2) for a in axes]
    return roll(x, shifts, axes) if axes else x


def fftshift(x, axes=None) -> DNDarray:
    """The zero frequency moved to the centre (``roll`` by n // 2 along ``axes``)."""
    return _shift(x, axes, 1)


def ifftshift(x, axes=None) -> DNDarray:
    return _shift(x, axes, -1)
