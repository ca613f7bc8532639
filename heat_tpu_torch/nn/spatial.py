"""1-D and 3-D convolutions and pools, transposed convolutions, upsampling and the distance modules
(reference: ``heat_tpu/nn/spatial.py``).

The weights keep torch's layouts, as the reference's do: ``Conv1d`` (O, I,
K), ``Conv3d`` (O, I, D, H, W), the transposed convolutions (I, O, *k)
with ``output_padding`` smaller than ``stride`` (checked when built), and
``Bilinear`` (out, in1, in2); each is torch's module on the default device,
whose initialization (uniform in ±1/sqrt(fan_in), the transposed ones'
fan_in from out · prod(k)) is the reference's.  Pools have no padding
(the reference's VALID windows); ``MaxPool1d/3d(return_indices=True)``
give torch's flat index into each channel's plane, as the reference's do.
``CosineSimilarity`` clamps each norm at ``eps``; ``PairwiseDistance`` is
the p-norm of ``x1 - x2 + eps`` along the last axis; ``LocalResponseNorm``
sums the squares over a channel window of ``size`` (size // 2 before,
the rest after).  ``Upsample`` resizes the trailing axes with half-pixel
geometry, as ``jax.image.resize`` does: 'nearest' is torch's
'nearest-exact' (so any ratio agrees with the reference, where the
reference's own note compares with torch's 'nearest'), and 'bilinear',
'linear' and 'trilinear' interpolate over every spatial axis with
``align_corners=False``; a ratio below 1 in the linear modes does not take
``jax.image``'s antialiasing.  ``UpsamplingBilinear2d`` is the reference's
deliberate deviation from torch (torch's alias hard-codes
``align_corners=True``): it equals ``Upsample(mode='bilinear')``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .modules import _device

__all__ = [
    "AdaptiveAvgPool1d", "AvgPool1d", "AvgPool3d", "Bilinear", "Conv1d",
    "Conv3d", "ConvTranspose1d", "ConvTranspose2d", "ConvTranspose3d",
    "CosineSimilarity", "LocalResponseNorm", "MaxPool1d",
    "MaxPool3d", "PairwiseDistance", "Upsample", "UpsamplingBilinear2d",
    "UpsamplingNearest2d",
]


class Conv1d(torch.nn.Conv1d):
    """1-D convolution, NCL, weight (out, in, k), on the default device."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int = 1, padding: int = 0,
                 bias: bool = True, device=None, dtype=None):
        super().__init__(in_channels, out_channels, int(kernel_size), stride=int(stride), padding=int(padding),
                         bias=bias, device=_device(device), dtype=dtype)


class Conv3d(torch.nn.Conv3d):
    """3-D convolution, NCDHW, weight (out, in, kd, kh, kw), on the default device."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size, stride=1, padding=0, bias: bool = True,
                 device=None, dtype=None):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride, padding=padding, bias=bias,
                         device=_device(device), dtype=dtype)


class MaxPool1d(torch.nn.MaxPool1d):
    def __init__(self, kernel_size: int, stride: int = None, return_indices: bool = False):
        super().__init__(kernel_size, stride=stride, return_indices=return_indices)


class MaxPool3d(torch.nn.MaxPool3d):
    def __init__(self, kernel_size, stride=None, return_indices: bool = False):
        super().__init__(kernel_size, stride=stride, return_indices=return_indices)


class AvgPool1d(torch.nn.AvgPool1d):
    def __init__(self, kernel_size: int, stride: int = None):
        super().__init__(kernel_size, stride=stride)


class AvgPool3d(torch.nn.AvgPool3d):
    def __init__(self, kernel_size, stride=None):
        super().__init__(kernel_size, stride=stride)


class AdaptiveAvgPool1d(torch.nn.Module):
    """Mean over equal windows of an (N, C, L) input to ``output_size``;
    raises ``ValueError`` where L is not a multiple of it."""

    def __init__(self, output_size: int = 1):
        super().__init__()
        self.output_size = int(output_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c, length = x.shape
        o = self.output_size
        if length % o:
            raise ValueError(f"AdaptiveAvgPool1d: input {length} not divisible by output {o}")
        return x.reshape(n, c, o, length // o).mean(dim=3)


class CosineSimilarity(torch.nn.Module):
    """cos(x1, x2) along ``dim``, each norm clamped at ``eps``."""

    def __init__(self, dim: int = 1, eps: float = 1e-8):
        super().__init__()
        self.dim, self.eps = dim, eps

    def forward(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        n1 = torch.clamp(torch.linalg.vector_norm(x1, dim=self.dim), min=self.eps)
        n2 = torch.clamp(torch.linalg.vector_norm(x2, dim=self.dim), min=self.eps)
        return (x1 * x2).sum(dim=self.dim) / (n1 * n2)


class PairwiseDistance(torch.nn.Module):
    """The ``p``-norm of ``x1 - x2 + eps`` along the last axis (for all
    pairs of distributed rows, ``ht.spatial.cdist``)."""

    def __init__(self, p: float = 2.0, eps: float = 1e-6, keepdim: bool = False):
        super().__init__()
        self.p, self.eps, self.keepdim = p, eps, keepdim

    def forward(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        return torch.linalg.vector_norm(x1 - x2 + self.eps, ord=self.p, dim=-1, keepdim=self.keepdim)


class Bilinear(torch.nn.Bilinear):
    """y = x1 W x2 + b for each output feature, weight (out, in1, in2), on the default device."""

    def __init__(self, in1_features: int, in2_features: int, out_features: int, bias: bool = True, device=None,
                 dtype=None):
        super().__init__(in1_features, in2_features, out_features, bias=bias, device=_device(device), dtype=dtype)


class LocalResponseNorm(torch.nn.Module):
    """x / (k + alpha / size · Σ_window x²) ** beta over a window of ``size``
    channels (size // 2 before a channel, size - size // 2 - 1 after)."""

    def __init__(self, size: int, alpha: float = 1e-4, beta: float = 0.75, k: float = 1.0):
        super().__init__()
        self.size, self.alpha, self.beta, self.k = int(size), alpha, beta, k

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        half = self.size // 2
        pad = [0, 0] * (x.ndim - 2) + [half, self.size - half - 1]
        sq = F.pad(x * x, pad)
        c = x.shape[1]
        win = sum(sq.narrow(1, j, c) for j in range(self.size))
        return x / (self.k + self.alpha / self.size * win) ** self.beta


_LINEAR_MODES = {1: "linear", 2: "bilinear", 3: "trilinear"}


class Upsample(torch.nn.Module):
    """Resize the trailing axes of an (N, C, ...) input to ``size`` or by
    ``scale_factor`` (module docstring: half-pixel geometry)."""

    def __init__(self, size=None, scale_factor=None, mode: str = "nearest"):
        super().__init__()
        if (scale_factor is None) == (size is None):
            raise ValueError("exactly one of scale_factor/size is required")
        if mode not in ("nearest", "bilinear", "linear", "trilinear"):
            raise ValueError(f"unsupported mode {mode!r}")
        self.size, self.scale_factor, self.mode = size, scale_factor, mode

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        spatial = x.shape[2:]
        if self.size is not None:
            out = tuple(self.size) if isinstance(self.size, tuple) else (self.size,) * len(spatial)
        else:
            sf = self.scale_factor if isinstance(self.scale_factor, tuple) else (self.scale_factor,) * len(spatial)
            out = tuple(int(s * f) for s, f in zip(spatial, sf))
        if self.mode == "nearest":
            return F.interpolate(x, size=out, mode="nearest-exact")
        return F.interpolate(x, size=out, mode=_LINEAR_MODES[len(spatial)], align_corners=False)


class UpsamplingNearest2d(Upsample):
    def __init__(self, size=None, scale_factor=None):
        super().__init__(size=size, scale_factor=scale_factor, mode="nearest")


class UpsamplingBilinear2d(Upsample):
    """``Upsample(mode='bilinear')``: half-pixel geometry, the reference's
    rule (torch's alias takes ``align_corners=True``)."""

    def __init__(self, size=None, scale_factor=None):
        super().__init__(size=size, scale_factor=scale_factor, mode="bilinear")


def _check_output_padding(output_padding, stride, n: int) -> None:
    tup = lambda v: tuple(v) if isinstance(v, (tuple, list)) else (v,) * n  # noqa: E731
    if any(op >= s for op, s in zip(tup(output_padding), tup(stride))):
        raise ValueError("output_padding must be smaller than stride")


class ConvTranspose1d(torch.nn.ConvTranspose1d):
    """Transposed 1-D convolution, weight (in, out, k), on the default device."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size, stride=1, padding=0, output_padding=0,
                 bias: bool = True, device=None, dtype=None):
        _check_output_padding(output_padding, stride, 1)
        super().__init__(in_channels, out_channels, kernel_size, stride=stride, padding=padding,
                         output_padding=output_padding, bias=bias, device=_device(device), dtype=dtype)


class ConvTranspose2d(torch.nn.ConvTranspose2d):
    """Transposed 2-D convolution, weight (in, out, kh, kw), on the default device."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size, stride=1, padding=0, output_padding=0,
                 bias: bool = True, device=None, dtype=None):
        _check_output_padding(output_padding, stride, 2)
        super().__init__(in_channels, out_channels, kernel_size, stride=stride, padding=padding,
                         output_padding=output_padding, bias=bias, device=_device(device), dtype=dtype)


class ConvTranspose3d(torch.nn.ConvTranspose3d):
    """Transposed 3-D convolution, weight (in, out, kd, kh, kw), on the default device."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size, stride=1, padding=0, output_padding=0,
                 bias: bool = True, device=None, dtype=None):
        _check_output_padding(output_padding, stride, 3)
        super().__init__(in_channels, out_channels, kernel_size, stride=stride, padding=padding,
                         output_padding=output_padding, bias=bias, device=_device(device), dtype=dtype)
