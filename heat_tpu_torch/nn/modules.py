"""The transformer's building blocks: ``torch.nn`` modules under the reference's names.

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
"""

from __future__ import annotations

import torch

from ..core import devices

__all__ = ["Linear", "LayerNorm", "Embedding", "GELU", "Dropout", "Sequential"]

GELU = torch.nn.GELU
Dropout = torch.nn.Dropout
Sequential = torch.nn.Sequential


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
