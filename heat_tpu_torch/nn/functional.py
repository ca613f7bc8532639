"""Functional ops, ``ht.nn.functional`` (reference: ``heat_tpu/nn/functional.py``): the losses of the
training paths and the transformer's attention."""

from __future__ import annotations

import math

import torch

from ..ops.flash_attention import _dense_attention, flash_attention, flash_attention_gqa

__all__ = ["cross_entropy", "l1_loss", "mse_loss", "nll_loss", "scaled_dot_product_attention"]


def _reduce(v: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == "mean":
        return v.mean()
    if reduction == "sum":
        return v.sum()
    return v


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor, reduction: str = "mean") -> torch.Tensor:
    """Softmax cross-entropy with integer class targets; ``reduction`` is
    ``'mean'``, ``'sum'`` or ``'none'``."""
    return nll_loss(torch.log_softmax(logits, dim=-1), targets, reduction)


def nll_loss(log_probs: torch.Tensor, targets: torch.Tensor, reduction: str = "mean") -> torch.Tensor:
    """Negative log-likelihood of integer class targets under ``log_probs``."""
    return _reduce(-log_probs.gather(-1, targets[..., None].long())[..., 0], reduction)


def mse_loss(pred: torch.Tensor, target: torch.Tensor, reduction: str = "mean") -> torch.Tensor:
    return _reduce((pred - target) ** 2, reduction)


def l1_loss(pred: torch.Tensor, target: torch.Tensor, reduction: str = "mean") -> torch.Tensor:
    return _reduce((pred - target).abs(), reduction)


def scaled_dot_product_attention(query, key, value, attn_mask=None, is_causal: bool = False, scale=None,
                                 enable_gqa: bool = False):
    """torch ``F.scaled_dot_product_attention``'s call shape: ``(..., S, d)``
    operands, optional ``attn_mask`` (bool True = attend, or float
    additive), top-left causal.

    Unmasked calls with identical shapes run the flash kernels (forward and
    backward), and unmasked grouped-query calls (``enable_gqa`` with fewer
    K/V heads and the same leading axes) the grouped flash kernels, which
    never repeat K/V.  Everything else runs the one dense softmax path
    (grouped K/V repeated to the query heads), whose fully-masked rows give 0
    with NaN-free gradients (torch gives NaN)."""
    q, k, v = query, key, value
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if enable_gqa and q.ndim >= 3 and k.shape[-3] != q.shape[-3]:
        hq, hkv = q.shape[-3], k.shape[-3]
        if hq % hkv:
            raise ValueError(f"enable_gqa requires query heads ({hq}) divisible by key/value heads ({hkv})")
        if attn_mask is None and k.shape == v.shape and q.shape[-2:] == k.shape[-2:] and q.shape[:-3] == k.shape[:-3]:
            return flash_attention_gqa(q, k, v, causal=is_causal, scale=scale)
        k = k.repeat_interleave(hq // hkv, dim=-3)
        v = v.repeat_interleave(hq // hkv, dim=-3)
    if attn_mask is None and q.shape == k.shape == v.shape:
        return flash_attention(q, k, v, causal=is_causal, scale=scale)
    bias = None
    if attn_mask is not None:
        attn_mask = torch.as_tensor(attn_mask, device=q.device)
        if attn_mask.dtype == torch.bool:
            # torch sdpa semantics: True = allowed to attend
            bias = torch.zeros(attn_mask.shape, dtype=q.dtype, device=q.device).masked_fill(~attn_mask, float("-inf"))
        else:
            bias = attn_mask.to(q.dtype)
    return _dense_attention(q, k, v, is_causal, scale, k.shape[-2], bias=bias)
