"""Padding, the shuffles and the adaptive pools (reference: ``heat_tpu/nn/padshuffle.py``).

A pad takes torch's per-side widths, last axis first ((left, right[, top,
bottom[, front, back]]); an int pads every side), over its trailing 1, 2
or 3 axes; a negative width crops, as torch's does.  The constant pads
(``Zero``, ``Constant``) are ``F.pad``'s; the reflection, replication and
circular pads gather along each axis by an index that follows numpy's
'reflect', 'edge' and 'wrap' rules at any width, as the reference's
``jnp.pad`` does: a circular or reflection pad wider than its axis wraps
or reflects again (torch's own refuse it).  ``PixelShuffle``,
``PixelUnshuffle`` and ``ChannelShuffle`` are the reference's reshapes;
the adaptive max pools and ``AdaptiveAvgPool3d`` pool over equal windows
and raise where an extent is not a multiple of the output's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .modules import _AdaptivePool

__all__ = [
    "AdaptiveAvgPool3d", "AdaptiveMaxPool1d", "AdaptiveMaxPool2d",
    "AdaptiveMaxPool3d", "ChannelShuffle", "CircularPad1d", "CircularPad2d",
    "CircularPad3d", "ConstantPad1d", "ConstantPad2d", "ConstantPad3d",
    "PixelShuffle", "PixelUnshuffle", "ReflectionPad1d", "ReflectionPad2d",
    "ReflectionPad3d", "ReplicationPad1d", "ReplicationPad2d",
    "ReplicationPad3d", "ZeroPad1d", "ZeroPad2d", "ZeroPad3d",
]


def _source_index(n: int, lo: int, hi: int, mode: str, device) -> torch.Tensor:
    """The source position along an axis of ``n`` of each output position
    of a pad by (lo, hi) (negative: a crop), numpy's rule for ``mode``."""
    i = torch.arange(-lo, n + hi, device=device)
    if mode == "wrap":
        return torch.remainder(i, n)
    if mode == "edge" or n == 1:
        return torch.clamp(i, 0, n - 1)
    period = 2 * (n - 1)  # 'reflect' mirrors about the edge samples without repeating them
    m = torch.remainder(i, period)
    return torch.where(m < n, m, period - m)


class _Pad(torch.nn.Module):
    """Pads the ``spatial`` trailing axes in one mode (module docstring)."""

    spatial = 1
    mode = "constant"

    def __init__(self, padding, value: float = 0.0):
        super().__init__()
        n = self.spatial
        if isinstance(padding, int):
            padding = (padding,) * (2 * n)
        padding = tuple(int(p) for p in padding)
        if len(padding) != 2 * n:
            raise ValueError(f"{type(self).__name__} expects an int or {2 * n} per-side widths (torch order: last "
                             f"dim first), got {len(padding)}")
        self.padding, self.value = padding, value

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = self.spatial
        if x.ndim < n + 1:
            raise ValueError(f"{type(self).__name__} expects at least {n + 1}-D input, got {x.ndim}-D")
        if self.mode == "constant":
            return F.pad(x, self.padding, mode="constant", value=self.value)
        for i in range(n):  # padding[2i], padding[2i + 1] widen axis -1 - i
            axis = x.ndim - 1 - i
            lo, hi = self.padding[2 * i], self.padding[2 * i + 1]
            x = x.index_select(axis, _source_index(x.shape[axis], lo, hi, self.mode, x.device))
        return x


def _pad_family(spatial: int):
    """The five pads of one spatial rank."""

    class Zero(_Pad):
        pass

    class Constant(_Pad):
        pass

    class Reflection(_Pad):
        mode = "reflect"

        def __init__(self, padding):
            super().__init__(padding)

    class Replication(_Pad):
        mode = "edge"

        def __init__(self, padding):
            super().__init__(padding)

    class Circular(_Pad):
        mode = "wrap"

        def __init__(self, padding):
            super().__init__(padding)

    classes = (Zero, Constant, Reflection, Replication, Circular)
    for cls, name in zip(classes, ("ZeroPad", "ConstantPad", "ReflectionPad", "ReplicationPad", "CircularPad")):
        cls.spatial = spatial
        cls.__name__ = cls.__qualname__ = f"{name}{spatial}d"
    return classes


ZeroPad1d, ConstantPad1d, ReflectionPad1d, ReplicationPad1d, CircularPad1d = _pad_family(1)
ZeroPad2d, ConstantPad2d, ReflectionPad2d, ReplicationPad2d, CircularPad2d = _pad_family(2)
ZeroPad3d, ConstantPad3d, ReflectionPad3d, ReplicationPad3d, CircularPad3d = _pad_family(3)


class PixelShuffle(torch.nn.Module):
    """(..., C·r², H, W) -> (..., C, H·r, W·r), torch's sub-pixel layout."""

    def __init__(self, upscale_factor: int):
        super().__init__()
        self.r = int(upscale_factor)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        *lead, crr, h, w = x.shape
        r = self.r
        if crr % (r * r):
            raise ValueError(f"channels {crr} not divisible by r^2 = {r * r}")
        k = len(lead)
        y = x.reshape(*lead, crr // (r * r), r, r, h, w).permute(*range(k), k, k + 3, k + 1, k + 4, k + 2)
        return y.reshape(*lead, crr // (r * r), h * r, w * r)


class PixelUnshuffle(torch.nn.Module):
    """The inverse of :class:`PixelShuffle`."""

    def __init__(self, downscale_factor: int):
        super().__init__()
        self.r = int(downscale_factor)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        *lead, c, hr, wr = x.shape
        r = self.r
        if hr % r or wr % r:
            raise ValueError(f"spatial dims ({hr}, {wr}) not divisible by r = {r}")
        k = len(lead)
        y = x.reshape(*lead, c, hr // r, r, wr // r, r).permute(*range(k), k, k + 2, k + 4, k + 1, k + 3)
        return y.reshape(*lead, c * r * r, hr // r, wr // r)


class ChannelShuffle(torch.nn.Module):
    """(N, g·c, ...) -> the g channel groups interleaved (ShuffleNet)."""

    def __init__(self, groups: int):
        super().__init__()
        self.groups = int(groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ch, g = x.shape[1], self.groups
        if ch % g:
            raise ValueError(f"channels {ch} not divisible by groups {g}")
        return x.reshape(x.shape[0], g, ch // g, *x.shape[2:]).transpose(1, 2).reshape(x.shape)


class AdaptiveMaxPool1d(_AdaptivePool):
    spatial, op = 1, "max"


class AdaptiveMaxPool2d(_AdaptivePool):
    spatial, op = 2, "max"


class AdaptiveMaxPool3d(_AdaptivePool):
    spatial, op = 3, "max"


class AdaptiveAvgPool3d(_AdaptivePool):
    spatial = 3
