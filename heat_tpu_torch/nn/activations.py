"""The activation zoo (reference: ``heat_tpu/nn/activations.py``): torch modules under the reference's names.

Each follows the reference's ``jax.nn`` expression and its defaults, which
are torch's: ``ELU``/``CELU`` alpha 1, ``LeakyReLU`` slope 0.01,
``Softplus`` beta 1 with the linear branch above ``threshold`` 20,
``Hardtanh`` [-1, 1], ``Hard``/``Softshrink`` lambda 0.5, ``GLU`` and
``Softmin`` over the last axis (torch's ``Softmin`` takes ``dim=None``).
``PReLU`` holds ``weight`` (num_parameters,) at 0.25, broadcast on axis 1
of an input of two or more axes, on the default device.  ``RReLU`` in
training (torch's module mode, where the reference takes ``train=`` and a
key) draws each element's slope from U[lower, upper] with torch's
generator of the input's device; in evaluation the slope is
(lower + upper) / 2.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .modules import _device

__all__ = [
    "CELU", "ELU", "GLU", "Hardshrink", "Hardsigmoid", "Hardswish",
    "Hardtanh", "LeakyReLU", "LogSigmoid", "Mish", "PReLU", "RReLU",
    "ReLU6", "SELU", "SiLU", "Softmin", "Softplus", "Softshrink",
    "Softsign", "Tanhshrink", "Threshold",
]


class _Elementwise(torch.nn.Module):
    """A parameter-free activation: ``fn(x)``."""

    fn = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return type(self).fn(x)


class SELU(_Elementwise):
    fn = staticmethod(F.selu)


class SiLU(_Elementwise):
    fn = staticmethod(F.silu)


class Mish(_Elementwise):
    fn = staticmethod(lambda x: x * torch.tanh(F.softplus(x)))


class ReLU6(_Elementwise):
    fn = staticmethod(lambda x: torch.clamp(x, 0.0, 6.0))


class LogSigmoid(_Elementwise):
    fn = staticmethod(F.logsigmoid)


class Softsign(_Elementwise):
    fn = staticmethod(lambda x: x / (1.0 + x.abs()))


class Tanhshrink(_Elementwise):
    fn = staticmethod(lambda x: x - torch.tanh(x))


class Hardswish(_Elementwise):
    fn = staticmethod(lambda x: x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0)


class Hardsigmoid(_Elementwise):
    fn = staticmethod(lambda x: torch.clamp(x + 3.0, 0.0, 6.0) / 6.0)


class ELU(torch.nn.Module):
    def __init__(self, alpha: float = 1.0):
        super().__init__()
        self.alpha = alpha

    def forward(self, x):
        return F.elu(x, alpha=self.alpha)


class CELU(torch.nn.Module):
    def __init__(self, alpha: float = 1.0):
        super().__init__()
        self.alpha = alpha

    def forward(self, x):
        return F.celu(x, alpha=self.alpha)


class LeakyReLU(torch.nn.Module):
    def __init__(self, negative_slope: float = 0.01):
        super().__init__()
        self.negative_slope = negative_slope

    def forward(self, x):
        return torch.where(x >= 0, x, self.negative_slope * x)


class Softplus(torch.nn.Module):
    """softplus(beta x) / beta, and x where beta x > threshold."""

    def __init__(self, beta: float = 1.0, threshold: float = 20.0):
        super().__init__()
        self.beta, self.threshold = beta, threshold

    def forward(self, x):
        return torch.where(self.beta * x > self.threshold, x, F.softplus(self.beta * x) / self.beta)


class Hardtanh(torch.nn.Module):
    def __init__(self, min_val: float = -1.0, max_val: float = 1.0):
        super().__init__()
        self.min_val, self.max_val = min_val, max_val

    def forward(self, x):
        return torch.clamp(x, self.min_val, self.max_val)


class Hardshrink(torch.nn.Module):
    def __init__(self, lambd: float = 0.5):
        super().__init__()
        self.lambd = lambd

    def forward(self, x):
        return torch.where(x.abs() > self.lambd, x, torch.zeros_like(x))


class Softshrink(torch.nn.Module):
    def __init__(self, lambd: float = 0.5):
        super().__init__()
        self.lambd = lambd

    def forward(self, x):
        return torch.sign(x) * torch.clamp(x.abs() - self.lambd, min=0.0)


class Threshold(torch.nn.Module):
    def __init__(self, threshold: float, value: float):
        super().__init__()
        self.threshold, self.value = threshold, value

    def forward(self, x):
        return torch.where(x > self.threshold, x, torch.full_like(x, self.value))


class GLU(torch.nn.Module):
    def __init__(self, dim: int = -1):
        super().__init__()
        self.dim = dim

    def forward(self, x):
        a, b = x.chunk(2, dim=self.dim)
        return a * torch.sigmoid(b)


class Softmin(torch.nn.Module):
    def __init__(self, dim: int = -1):
        super().__init__()
        self.dim = dim

    def forward(self, x):
        return torch.softmax(-x, dim=self.dim)


def _channel_slope(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A per-channel slope broadcast on axis 1 of an input of two or more axes."""
    if x.ndim >= 2 and a.shape[0] > 1:
        return a.reshape((1, -1) + (1,) * (x.ndim - 2))
    return a


class PReLU(torch.nn.Module):
    """x where x >= 0, else weight · x; ``weight`` (num_parameters,) starts at ``init``."""

    def __init__(self, num_parameters: int = 1, init: float = 0.25, device=None, dtype=None):
        super().__init__()
        self.num_parameters = num_parameters
        self.weight = torch.nn.Parameter(torch.full((num_parameters,), float(init), device=_device(device),
                                                    dtype=dtype))

    def forward(self, x):
        return torch.where(x >= 0, x, _channel_slope(self.weight, x) * x)


class RReLU(torch.nn.Module):
    """Randomized leaky ReLU: a slope from U[lower, upper] for each element
    in training, (lower + upper) / 2 in evaluation."""

    def __init__(self, lower: float = 1.0 / 8, upper: float = 1.0 / 3):
        super().__init__()
        self.lower, self.upper = lower, upper

    def forward(self, x):
        if not self.training:
            return torch.where(x >= 0, x, 0.5 * (self.lower + self.upper) * x)
        slope = torch.empty_like(x).uniform_(self.lower, self.upper)
        return torch.where(x >= 0, x, slope * x)
