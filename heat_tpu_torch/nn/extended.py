"""LP pools, the alpha dropouts, EmbeddingBag, Fold/Unfold and MaxUnpool (reference: ``heat_tpu/nn/extended.py``).

``LPPool1d/2d/3d`` are (Σ_window x^p)^(1/p) with torch's signed sum (an
odd p keeps the sign; a negative sum at a fractional 1/p gives NaN, as
torch's and the reference's do).  ``AlphaDropout`` and
``FeatureAlphaDropout`` keep a SELU network's mean and variance: dropped
units take alpha' = -1.7580993408473766 and the result is a·x + b, in
training (torch's module mode; the mask from torch's generator of the
input's device).  ``EmbeddingBag`` (weight standard normal, on the default
device) reduces each bag by 'sum', 'mean' or 'max': (B, L) indices, or
1-D indices with the bags' starts in ``offsets`` (``offsets[0]`` must be
0); ``per_sample_weights`` with 'sum'; an empty bag gives 0.  ``Unfold``
and ``Fold`` are torch's im2col and col2im, the patch channels in (C, kh,
kw) order as the reference's.  ``MaxUnpool1d/2d/3d`` put each value at its
flat index into its channel's plane, the indices of ``MaxPool*d(
return_indices=True)`` (the reference's are the same); the output extent
defaults to (i - 1)·stride + kernel, ``output_size`` must lie within one
stride of it, and an index outside the plane raises.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .modules import _device, _pair

__all__ = [
    "AlphaDropout", "EmbeddingBag", "FeatureAlphaDropout", "Fold",
    "LPPool1d", "LPPool2d", "LPPool3d", "MaxUnpool1d", "MaxUnpool2d",
    "MaxUnpool3d", "Unfold",
]

_AVG_POOLS = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}


def _tup(v, n: int) -> tuple:
    return tuple(v) if isinstance(v, (tuple, list)) else (v,) * n


class _LPPool(torch.nn.Module):
    spatial = 1

    def __init__(self, norm_type: float, kernel_size, stride=None):
        super().__init__()
        n = self.spatial
        self.norm_type = float(norm_type)
        self.kernel_size = _tup(kernel_size, n)
        self.stride = _tup(stride if stride is not None else kernel_size, n)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.norm_type
        s = _AVG_POOLS[self.spatial](x ** p, self.kernel_size, self.stride) * math.prod(self.kernel_size)
        return s ** (1.0 / p)


class LPPool1d(_LPPool):
    spatial = 1


class LPPool2d(_LPPool):
    spatial = 2


class LPPool3d(_LPPool):
    spatial = 3


_ALPHA_PRIME = -1.7580993408473766  # -selu_scale * selu_alpha


class AlphaDropout(torch.nn.Module):
    """SELU-preserving dropout (module docstring), a mask over every element."""

    def __init__(self, p: float = 0.5):
        super().__init__()
        self.p = p

    def _mask_shape(self, x: torch.Tensor) -> tuple:
        return tuple(x.shape)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        keep = 1.0 - self.p
        a = (keep + _ALPHA_PRIME ** 2 * keep * (1 - keep)) ** -0.5
        b = -a * _ALPHA_PRIME * (1 - keep)
        mask = torch.empty(self._mask_shape(x), device=x.device).bernoulli_(keep).bool()
        return a * torch.where(mask, x, torch.full_like(x, _ALPHA_PRIME)) + b


class FeatureAlphaDropout(AlphaDropout):
    """AlphaDropout of whole channels: an (N, C) mask over the spatial axes."""

    def _mask_shape(self, x: torch.Tensor) -> tuple:
        return tuple(x.shape[:2]) + (1,) * (x.ndim - 2)


_BAG_MODES = ("sum", "mean", "max")


class EmbeddingBag(torch.nn.Module):
    """Each bag's embedding rows reduced by ``mode`` (module docstring)."""

    def __init__(self, num_embeddings: int, embedding_dim: int, mode: str = "mean", device=None, dtype=None):
        super().__init__()
        if mode not in _BAG_MODES:
            raise ValueError(f"mode must be sum/mean/max, got {mode!r}")
        self.num_embeddings, self.embedding_dim, self.mode = num_embeddings, embedding_dim, mode
        self.weight = torch.nn.Parameter(torch.randn((num_embeddings, embedding_dim), device=_device(device),
                                                     dtype=dtype))

    def forward(self, idx: torch.Tensor, offsets: torch.Tensor = None,
                per_sample_weights: torch.Tensor = None) -> torch.Tensor:
        if per_sample_weights is not None and self.mode != "sum":
            raise ValueError("per_sample_weights requires mode='sum' (torch)")
        dev = self.weight.device
        idx = torch.as_tensor(idx, device=dev).long()
        if offsets is None:
            if idx.ndim != 2:
                raise ValueError("without offsets, indices must be 2-D (B, L)")
        else:
            if idx.ndim != 1:
                raise ValueError("with offsets, indices must be 1-D")
            offsets = torch.as_tensor(offsets, device=dev).long()
            if offsets.numel() and int(offsets[0]) != 0:
                raise ValueError("offsets[0] has to be 0 (torch contract): leading indices would fall outside "
                                 "every bag")
        if per_sample_weights is not None:
            per_sample_weights = torch.as_tensor(per_sample_weights, device=dev).to(self.weight.dtype)
        return F.embedding_bag(idx, self.weight, offsets, mode=self.mode, per_sample_weights=per_sample_weights)


class Unfold(torch.nn.Module):
    """im2col: (N, C, H, W) -> (N, C·kh·kw, L)."""

    def __init__(self, kernel_size, dilation=1, padding=0, stride=1):
        super().__init__()
        self.kernel_size, self.dilation = _pair(kernel_size), _pair(dilation)
        self.padding, self.stride = _pair(padding), _pair(stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.unfold(x, self.kernel_size, self.dilation, self.padding, self.stride)


class Fold(torch.nn.Module):
    """col2im: the patches summed back into (N, C) + ``output_size``, C
    from the patch channels."""

    def __init__(self, output_size, kernel_size, dilation=1, padding=0, stride=1):
        super().__init__()
        self.output_size, self.kernel_size = _pair(output_size), _pair(kernel_size)
        self.dilation, self.padding, self.stride = _pair(dilation), _pair(padding), _pair(stride)

    def forward(self, cols: torch.Tensor) -> torch.Tensor:
        return F.fold(cols.reshape(cols.shape[0], cols.shape[1], -1), self.output_size, self.kernel_size,
                      self.dilation, self.padding, self.stride)


class _MaxUnpool(torch.nn.Module):
    spatial = 2

    def __init__(self, kernel_size, stride=None):
        super().__init__()
        n = self.spatial
        self.kernel_size = _tup(kernel_size, n)
        self.stride = _tup(stride if stride is not None else kernel_size, n)

    def forward(self, x: torch.Tensor, indices: torch.Tensor = None, output_size=None) -> torch.Tensor:
        if indices is None:
            raise ValueError("MaxUnpool requires the indices from MaxPool(return_indices=True)")
        n = self.spatial
        if output_size is None:
            output_size = tuple((i - 1) * s + k for i, s, k in zip(x.shape[2:], self.stride, self.kernel_size))
        output_size = tuple(int(o) for o in output_size)
        if len(output_size) == x.ndim:  # torch also takes the full shape
            output_size = output_size[2:]
        if len(output_size) != n:
            raise ValueError(f"output_size must have {n} (spatial) or {n + 2} (full shape) entries, got "
                             f"{len(output_size)}")
        for d, (o, i, s, k) in enumerate(zip(output_size, x.shape[2:], self.stride, self.kernel_size)):
            default = (i - 1) * s + k
            if not default - s < o < default + s:
                raise ValueError(f"invalid output_size {output_size}: dim {d} must be between {default - s} and "
                                 f"{default + s}")
        N, C = x.shape[:2]
        plane = math.prod(output_size)
        idx = torch.as_tensor(indices, device=x.device).reshape(N, C, -1).long()
        if idx.numel():
            lo, hi = (int(v) for v in torch.stack([idx.min(), idx.max()]).tolist())
            if hi >= plane:
                raise ValueError(f"found an invalid max index {hi} for output size {output_size} (flat plane "
                                 f"{plane})")
            if lo < 0:
                raise ValueError(f"found an invalid (negative) index {lo}")
        out = x.new_zeros((N, C, plane)).scatter(2, idx, x.reshape(N, C, -1))
        return out.reshape(N, C, *output_size)


class MaxUnpool1d(_MaxUnpool):
    spatial = 1


class MaxUnpool2d(_MaxUnpool):
    spatial = 2


class MaxUnpool3d(_MaxUnpool):
    spatial = 3
