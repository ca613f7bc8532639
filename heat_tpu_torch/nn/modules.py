"""``torch.nn`` modules under the reference's names: the transformer's and the vision models' layers.

``heat_tpu.nn.modules`` defines functional modules (``init``/``apply`` over
a parameter pytree) that mirror ``torch.nn``; here they are ``torch.nn``
modules.  Where torch's own already agree with the reference in
parameters, defaults and initialization they are used as they are
(``GELU``: exact erf by default, ``'tanh'`` on request; ``Dropout``;
``Sequential``).  ``Linear`` (weight and bias uniform in ±1/sqrt(in)),
``LayerNorm`` (biased variance, eps 1e-5, weight 1, bias 0) and
``Embedding`` (standard normal) agree too, and only gain the package's
default device: they are built on ``gpu`` unless ``device=`` or
``use_device`` says otherwise.

The vision layers of the MLP and the ResNets: ``ReLU``, ``Tanh``,
``Sigmoid``, ``Identity`` and ``Flatten`` (all dims but the first) are
torch's; ``Conv2d`` (weight and bias uniform in ±1/sqrt(fan_in)),
``MaxPool2d`` and ``AvgPool2d`` (no padding) agree with the reference and
gain the default device.  ``AdaptiveAvgPool2d`` raises ``ValueError``
where an input extent is not a multiple of the output's, as the reference
does.  ``BatchNorm1d``/``BatchNorm2d`` follow the reference, not torch:
training normalizes with the batch's biased variance and leaves the
running buffers alone; :meth:`_BatchNorm.update_stats` is the explicit
running-stat EMA (ddof=1 variance); evaluation uses the buffers.  Under a
``DataParallel`` of more than one rank a BatchNorm takes the statistics of
the GLOBAL batch (:class:`_GlobalBatchNorm`: one collective each way).
``Residual`` is ``body(x) + shortcut(x)``.

The rest of the reference's modules: ``Module`` is ``torch.nn.Module``
itself (the reference's base class has ``init``/``apply`` over a pytree;
this package's modules are torch modules); ``Softmax`` and ``LogSoftmax``
over the last axis by default (torch's take ``dim=None``);
``Dropout1d/2d/3d`` zero whole channels, an (N, C) mask over an input of
exactly 3, 4 or 5 axes, in training (torch's module mode); ``Unflatten``
is torch's; ``BatchNorm3d`` is ``_BatchNorm`` over (N, C, D, H, W);
``RMSNorm`` is x · rsqrt(mean(x²) + eps) · weight with the reference's
``eps=None``: the input dtype's machine epsilon; ``GroupNorm`` is torch's
on the default device (biased variance within each group).  The adaptive
pools (``_AdaptivePool``) take equal windows and raise where an extent is
not a multiple of the output's.
"""

from __future__ import annotations

import torch

import torch.nn.functional as F

from ..core import devices

__all__ = ["Module", "Linear", "LayerNorm", "Embedding", "GELU", "Dropout", "Sequential", "ReLU", "Tanh",
           "Sigmoid", "Identity", "Flatten", "Conv2d", "MaxPool2d", "AvgPool2d", "AdaptiveAvgPool2d", "BatchNorm1d",
           "BatchNorm2d", "Residual", "Softmax", "LogSoftmax", "Dropout1d", "Dropout2d", "Dropout3d", "Unflatten",
           "BatchNorm3d", "RMSNorm", "GroupNorm"]

Module = torch.nn.Module
Unflatten = torch.nn.Unflatten

GELU = torch.nn.GELU
Dropout = torch.nn.Dropout
Sequential = torch.nn.Sequential
ReLU = torch.nn.ReLU
Tanh = torch.nn.Tanh
Sigmoid = torch.nn.Sigmoid
Identity = torch.nn.Identity
Flatten = torch.nn.Flatten


def _device(device) -> torch.device:
    return devices.sanitize_device(device).torch_device


class Linear(torch.nn.Linear):
    """y = x Wᵀ + b with W (out, in), on the default device."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True, device=None, dtype=None):
        super().__init__(in_features, out_features, bias=bias, device=_device(device), dtype=dtype)


class LayerNorm(torch.nn.LayerNorm):
    """Layer normalization over the trailing ``normalized_shape`` dims, on the default device."""

    def __init__(self, normalized_shape, eps: float = 1e-5, elementwise_affine: bool = True, device=None,
                 dtype=None):
        super().__init__(normalized_shape, eps=eps, elementwise_affine=elementwise_affine, device=_device(device),
                         dtype=dtype)


class Embedding(torch.nn.Embedding):
    """Lookup table (num_embeddings, embedding_dim), on the default device."""

    def __init__(self, num_embeddings: int, embedding_dim: int, device=None, dtype=None):
        super().__init__(num_embeddings, embedding_dim, device=_device(device), dtype=dtype)


def _pair(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


class Conv2d(torch.nn.Conv2d):
    """2-D convolution, NCHW, weight (out, in, kh, kw), on the default device."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size, stride=1, padding=0, bias: bool = True,
                 device=None, dtype=None):
        super().__init__(in_channels, out_channels, _pair(kernel_size), stride=_pair(stride),
                         padding=_pair(padding), bias=bias, device=_device(device), dtype=dtype)


class MaxPool2d(torch.nn.MaxPool2d):
    """Max pooling without padding (the reference's VALID windows);
    ``return_indices`` gives torch's flat index into each plane."""

    def __init__(self, kernel_size, stride=None, return_indices: bool = False):
        super().__init__(kernel_size, stride=stride, return_indices=return_indices)


class AvgPool2d(torch.nn.AvgPool2d):
    """Average pooling without padding."""

    def __init__(self, kernel_size, stride=None):
        super().__init__(kernel_size, stride=stride)


class _AdaptivePool(torch.nn.Module):
    """Adaptive pooling over the trailing ``spatial`` axes by equal windows
    (``op``: mean or max) to ``output_size`` (an int, or a tuple whose
    ``None`` keeps that extent); raises ``ValueError`` where an input
    extent is not a multiple of the output's."""

    spatial = 2
    op = "mean"

    def __init__(self, output_size=1):
        super().__init__()
        n = self.spatial
        out = tuple(output_size) if isinstance(output_size, (tuple, list)) else (output_size,) * n
        if len(out) != n:
            raise ValueError(f"output_size must have {n} entries")
        self.output_size = out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = self.spatial
        shape, axes = list(x.shape[:-n]), []
        for s, o in zip(x.shape[-n:], self.output_size):
            o = s if o is None else int(o)
            if s % o:
                raise ValueError(f"{type(self).__name__}: input {s} not divisible by output {o}")
            shape += [o, s // o]
            axes.append(len(shape) - 1)
        x = x.reshape(shape)
        return x.mean(dim=axes) if self.op == "mean" else x.amax(dim=axes)


class AdaptiveAvgPool2d(_AdaptivePool):
    """Mean over equal windows to ``output_size`` (module docstring)."""


class _GlobalBatchNorm(torch.autograd.Function):
    """Training-mode batch normalization over the rows of every rank of
    ``comm``: one collective each way.  The forward gathers each rank's
    row count, mean and biased variance (one Allgather of 2C + 1 values)
    and combines them exactly (Chan's centred formula), then normalizes
    with the fused ``F.batch_norm`` at those statistics.  Rank r holds the
    loss of its rows, weighted by its share w_r = n_r / N in the global
    loss, so the backward sums w_r times the local sum(dy) and
    sum(dy (x - mean)) over the ranks (one Allreduce) and returns dx in
    rank r's units: w·invstd·(dy - S_dy/n_r - (x - mean)·invstd^2·S_dyxmu/n_r).
    The weight's and bias's gradients stay local; ``DataParallel``
    weights and sums them like every other gradient."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, comm):
        axes = (0,) + tuple(range(2, x.ndim))
        rows = x.numel() // x.shape[1]
        var_r, mean_r = torch.var_mean(x, axes, correction=0)
        mine = torch.cat([mean_r, var_r, x.new_full((1,), float(rows))])
        table = torch.stack(comm.Allgather(mine))  # (ranks, 2C + 1)
        c = x.shape[1]
        counts = table[:, -1:]
        total = counts.sum()
        mean = (counts * table[:, :c]).sum(0) / total
        var = (counts * (table[:, c:2 * c] + (table[:, :c] - mean) ** 2)).sum(0) / total
        invstd = torch.rsqrt(var + eps)
        ctx.save_for_backward(x, weight, mean, invstd)
        ctx.comm, ctx.rows, ctx.share = comm, rows, rows / total
        return F.batch_norm(x, mean, var, weight, bias, False, 0.0, eps)

    @staticmethod
    def backward(ctx, dy):
        x, weight, mean, invstd = ctx.saved_tensors
        axes = (0,) + tuple(range(2, x.ndim))
        shape = (1, -1) + (1,) * (x.ndim - 2)
        xmu = x - mean.reshape(shape)
        sum_dy, sum_dy_xmu = dy.sum(axes), (dy * xmu).sum(axes)
        both = ctx.comm.Allreduce(torch.cat([sum_dy, sum_dy_xmu]) * ctx.share)
        s_dy, s_dy_xmu = both.chunk(2)
        a = invstd if weight is None else weight * invstd
        b = -a * invstd * invstd * s_dy_xmu / ctx.rows
        dx = torch.addcmul(torch.addcmul((-a * s_dy / ctx.rows).reshape(shape), dy, a.reshape(shape)), xmu,
                           b.reshape(shape))
        dweight = None if weight is None else sum_dy_xmu * invstd
        dbias = None if weight is None else sum_dy
        return dx, dweight, dbias, None, None


class _BatchNorm(torch.nn.Module):
    """Batch normalization with torch's parameter and buffer names and the
    reference's semantics (module docstring).  ``_sync`` is set by
    ``DataParallel``: a communicator makes training take the global
    batch's statistics over its ranks (:class:`_GlobalBatchNorm`)."""

    _dims: tuple = ()

    def __init__(self, num_features: int, eps: float = 1e-5, momentum: float = 0.1, affine: bool = True,
                 device=None, dtype=None):
        super().__init__()
        dev = _device(device)
        self.num_features, self.eps, self.momentum, self.affine = num_features, eps, momentum, affine
        self.register_buffer("running_mean", torch.zeros(num_features, device=dev, dtype=dtype))
        self.register_buffer("running_var", torch.ones(num_features, device=dev, dtype=dtype))
        if affine:
            self.weight = torch.nn.Parameter(torch.ones(num_features, device=dev, dtype=dtype))
            self.bias = torch.nn.Parameter(torch.zeros(num_features, device=dev, dtype=dtype))
        else:
            self.register_parameter("weight", None)
            self.register_parameter("bias", None)
        self._sync = None

    def _check(self, x: torch.Tensor) -> None:
        if x.ndim not in self._dims:
            raise ValueError(f"{type(self).__name__} expects {' or '.join(map(str, self._dims))}-D input, "
                             f"got {x.ndim}-D")

    def _bcast(self, v: torch.Tensor, ndim: int) -> torch.Tensor:
        return v.reshape((1, -1) + (1,) * (ndim - 2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        self._check(x)
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias, False, 0.0, self.eps)
        if self._sync is None or self._sync.size == 1:
            return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
        return _GlobalBatchNorm.apply(x, self.weight, self.bias, self.eps, self._sync)

    @torch.no_grad()
    def update_stats(self, x: torch.Tensor) -> "_BatchNorm":
        """The running-stat EMA from the batch ``x`` (this rank's rows), in
        place, with the unbiased (ddof=1) variance; returns the module."""
        self._check(x)
        axes = (0,) + tuple(range(2, x.ndim))
        m = self.momentum
        self.running_mean.mul_(1 - m).add_(m * x.mean(axes))
        self.running_var.mul_(1 - m).add_(m * x.var(axes, correction=1))
        return self


class BatchNorm1d(_BatchNorm):
    """BatchNorm over (N, C) or (N, C, L) input."""

    _dims = (2, 3)


class BatchNorm2d(_BatchNorm):
    """BatchNorm over (N, C, H, W) input."""

    _dims = (4,)


class BatchNorm3d(_BatchNorm):
    """BatchNorm over (N, C, D, H, W) input."""

    _dims = (5,)


class Softmax(torch.nn.Module):
    def __init__(self, dim: int = -1):
        super().__init__()
        self.dim = dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.softmax(x, dim=self.dim)


class LogSoftmax(torch.nn.Module):
    def __init__(self, dim: int = -1):
        super().__init__()
        self.dim = dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.log_softmax(x, dim=self.dim)


class _ChannelDropout(torch.nn.Module):
    """Zero whole channels in training: a Bernoulli(1 - p) mask over (N, C),
    broadcast over the ``spatial`` trailing axes, the kept ones scaled by
    1 / (1 - p)."""

    spatial = 1

    def __init__(self, p: float = 0.5):
        super().__init__()
        self.p = p

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        if x.ndim != self.spatial + 2:
            raise ValueError(f"expected a {self.spatial + 2}-D (N, C, ...) input, got {x.ndim}-D")
        keep = 1.0 - self.p
        mask = torch.empty(x.shape[:2] + (1,) * self.spatial, device=x.device).bernoulli_(keep)
        return torch.where(mask.bool(), x / keep, torch.zeros_like(x))


class Dropout1d(_ChannelDropout):
    spatial = 1


class Dropout2d(_ChannelDropout):
    spatial = 2


class Dropout3d(_ChannelDropout):
    spatial = 3


def _shape_of(normalized_shape) -> tuple:
    return (normalized_shape,) if isinstance(normalized_shape, int) else tuple(normalized_shape)


class RMSNorm(torch.nn.Module):
    """x · rsqrt(mean(x²) + eps) over the trailing ``normalized_shape``
    axes, times ``weight`` (ones); ``eps=None``: the input dtype's machine
    epsilon."""

    def __init__(self, normalized_shape, eps: float = None, elementwise_affine: bool = True, device=None,
                 dtype=None):
        super().__init__()
        self.normalized_shape = _shape_of(normalized_shape)
        self.eps = eps
        if elementwise_affine:
            self.weight = torch.nn.Parameter(torch.ones(self.normalized_shape, device=_device(device), dtype=dtype))
        else:
            self.register_parameter("weight", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        axes = tuple(range(x.ndim - len(self.normalized_shape), x.ndim))
        eps = torch.finfo(x.dtype).eps if self.eps is None else self.eps
        y = x * torch.rsqrt((x * x).mean(dim=axes, keepdim=True) + eps)
        return y if self.weight is None else y * self.weight


class GroupNorm(torch.nn.GroupNorm):
    """Normalization within ``num_groups`` groups of channels, on the default device."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-5, affine: bool = True, device=None,
                 dtype=None):
        if num_channels % num_groups:
            raise ValueError("num_channels must be divisible by num_groups")
        super().__init__(num_groups, num_channels, eps=eps, affine=affine, device=_device(device), dtype=dtype)


class Residual(torch.nn.Module):
    """y = body(x) + shortcut(x), the ResNet block's skeleton (shortcut:
    ``Identity`` where none is given)."""

    def __init__(self, body: torch.nn.Module, shortcut: torch.nn.Module = None):
        super().__init__()
        self.body = body
        self.shortcut = shortcut if shortcut is not None else Identity()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.body(x) + self.shortcut(x)
