"""Functional ops, ``ht.nn.functional`` (reference: ``heat_tpu/nn/functional.py``): the losses, ``relu``,
``softmax``/``log_softmax`` and the transformer's attention.

The losses follow the reference's formulas, not torch's where they part:
``binary_cross_entropy`` clips the probability to [eps, 1 - eps] with eps
1e-7 (torch clamps each log at -100 instead); ``kl_div``'s 'mean' averages
over elements as torch's does, 'batchmean' divides the sum by the batch,
and 0 · log 0 counts 0; ``smooth_l1_loss`` at ``beta=0`` is the L1 loss."""

from __future__ import annotations

import math

import torch

from ..ops.flash_attention import _dense_attention, flash_attention, flash_attention_gqa

__all__ = ["cross_entropy", "nll_loss", "mse_loss", "l1_loss", "binary_cross_entropy",
           "binary_cross_entropy_with_logits", "huber_loss", "smooth_l1_loss", "kl_div", "relu", "softmax",
           "log_softmax", "scaled_dot_product_attention"]


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


def binary_cross_entropy(pred: torch.Tensor, target: torch.Tensor, reduction: str = "mean",
                         eps: float = 1e-7) -> torch.Tensor:
    """-(t log p + (1 - t) log(1 - p)) with p clipped to [eps, 1 - eps]."""
    p = torch.clamp(pred, eps, 1.0 - eps)
    return _reduce(-(target * torch.log(p) + (1.0 - target) * torch.log(1.0 - p)), reduction)


def binary_cross_entropy_with_logits(logits: torch.Tensor, target: torch.Tensor,
                                     reduction: str = "mean") -> torch.Tensor:
    """max(z, 0) - z t + log1p(exp(-|z|)): the binary cross-entropy of sigmoid(z)."""
    z = logits
    return _reduce(torch.clamp(z, min=0.0) - z * target + torch.log1p(torch.exp(-z.abs())), reduction)


def huber_loss(pred: torch.Tensor, target: torch.Tensor, reduction: str = "mean", delta: float = 1.0):
    """0.5 d² within ``delta`` of the target, delta (d - delta / 2) beyond."""
    d = (pred - target).abs()
    return _reduce(torch.where(d <= delta, 0.5 * d ** 2, delta * (d - 0.5 * delta)), reduction)


def smooth_l1_loss(pred: torch.Tensor, target: torch.Tensor, reduction: str = "mean", beta: float = 1.0):
    """0.5 d² / beta below ``beta``, d - beta / 2 above; the L1 loss at beta 0."""
    d = (pred - target).abs()
    if beta == 0.0:
        return _reduce(d, reduction)
    return _reduce(torch.where(d < beta, 0.5 * d ** 2 / beta, d - 0.5 * beta), reduction)


def kl_div(log_pred: torch.Tensor, target: torch.Tensor, reduction: str = "mean", log_target: bool = False):
    """Pointwise KL divergence, torch's argument order: ``log_pred`` holds
    log-probabilities, ``target`` probabilities (log-probabilities with
    ``log_target``).  ``reduction`` also takes 'batchmean'."""
    if log_target:
        v = torch.exp(target) * (target - log_pred)
    else:
        pos = target > 0
        tlogt = torch.where(pos, target * torch.log(torch.where(pos, target, torch.ones_like(target))),
                            torch.zeros_like(target))
        v = tlogt - target * log_pred
    if reduction == "batchmean":
        return v.sum() / log_pred.shape[0]
    return _reduce(v, reduction)


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.relu(x)


def softmax(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    return torch.softmax(x, dim=axis)


def log_softmax(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    return torch.log_softmax(x, dim=axis)


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
