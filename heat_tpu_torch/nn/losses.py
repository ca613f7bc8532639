"""Loss modules (reference: ``heat_tpu/nn/losses.py``): torch-style criteria over ``ht.nn.functional``.

Each is a parameter-free ``torch.nn.Module`` with ``reduction`` in
{'mean', 'sum', 'none'} (default 'mean'; ``KLDivLoss`` also 'batchmean'),
called as torch's: ``loss(pred, target)``, or with three tensors for the
ranking, triplet and ``GaussianNLLLoss`` criteria and four for
``CTCLoss``.  The formulas are the reference's, with its clamps
(``functional``'s docstring): ``BCELoss`` clips the probability at 1e-7,
``GaussianNLLLoss`` clamps the variance at ``eps`` (no gradient below it),
``CosineEmbeddingLoss`` clamps each norm at 1e-8, the triplet losses use
the pairwise p-norm of ``x1 - x2 + eps``.  ``CTCLoss`` is torch's
``ctc_loss`` on (T, N, C) log-probabilities and padded (N, S) targets
(the reference's one layout): the alignment runs where the tensors are, on
the card for CUDA inputs, after ATen copies the N input and target lengths
to the host; 'mean' divides each sequence's loss by its target length
(at least 1) and averages; ``zero_infinity`` zeroes the infeasible ones.
"""

from __future__ import annotations

import math

import torch

from . import functional as F
from .spatial import CosineSimilarity, PairwiseDistance

__all__ = [
    "BCELoss", "BCEWithLogitsLoss", "CTCLoss", "CosineEmbeddingLoss",
    "CrossEntropyLoss", "GaussianNLLLoss", "HingeEmbeddingLoss", "HuberLoss",
    "KLDivLoss", "L1Loss", "MSELoss", "MarginRankingLoss",
    "MultiLabelMarginLoss", "MultiLabelSoftMarginLoss", "MultiMarginLoss", "NLLLoss",
    "PoissonNLLLoss", "SmoothL1Loss", "SoftMarginLoss", "TripletMarginLoss",
    "TripletMarginWithDistanceLoss",
]


class _Loss(torch.nn.Module):
    """Criterion base: checks ``reduction`` and applies ``_fn`` to the inputs."""

    _reductions = ("mean", "sum", "none")

    def __init__(self, reduction: str = "mean"):
        super().__init__()
        if reduction not in self._reductions:
            raise ValueError(f"unknown reduction {reduction!r}")
        self.reduction = reduction

    def _fn(self, *inputs):
        raise NotImplementedError

    def forward(self, *inputs: torch.Tensor) -> torch.Tensor:
        return self._fn(*inputs)


class MSELoss(_Loss):
    def _fn(self, pred, target):
        return F.mse_loss(pred, target, reduction=self.reduction)


class L1Loss(_Loss):
    def _fn(self, pred, target):
        return F.l1_loss(pred, target, reduction=self.reduction)


class CrossEntropyLoss(_Loss):
    def _fn(self, pred, target):
        return F.cross_entropy(pred, target, reduction=self.reduction)


class NLLLoss(_Loss):
    def _fn(self, pred, target):
        return F.nll_loss(pred, target, reduction=self.reduction)


class BCELoss(_Loss):
    def _fn(self, pred, target):
        return F.binary_cross_entropy(pred, target, reduction=self.reduction)


class BCEWithLogitsLoss(_Loss):
    def _fn(self, pred, target):
        return F.binary_cross_entropy_with_logits(pred, target, reduction=self.reduction)


class HuberLoss(_Loss):
    def __init__(self, reduction: str = "mean", delta: float = 1.0):
        super().__init__(reduction)
        self.delta = delta

    def _fn(self, pred, target):
        return F.huber_loss(pred, target, reduction=self.reduction, delta=self.delta)


class SmoothL1Loss(_Loss):
    def __init__(self, reduction: str = "mean", beta: float = 1.0):
        super().__init__(reduction)
        self.beta = beta

    def _fn(self, pred, target):
        return F.smooth_l1_loss(pred, target, reduction=self.reduction, beta=self.beta)


class SoftMarginLoss(_Loss):
    """log(1 + exp(-y x)) with targets in {-1, +1}."""

    def _fn(self, pred, target):
        return F._reduce(torch.nn.functional.softplus(-target * pred), self.reduction)


class HingeEmbeddingLoss(_Loss):
    """x where y == 1, max(0, margin - x) where y == -1."""

    def __init__(self, margin: float = 1.0, reduction: str = "mean"):
        super().__init__(reduction)
        self.margin = margin

    def _fn(self, pred, target):
        return F._reduce(torch.where(target == 1, pred, torch.clamp(self.margin - pred, min=0.0)), self.reduction)


class MarginRankingLoss(_Loss):
    """max(0, -y (x1 - x2) + margin): y = +1 ranks x1 above x2."""

    def __init__(self, margin: float = 0.0, reduction: str = "mean"):
        super().__init__(reduction)
        self.margin = margin

    def _fn(self, x1, x2, target):
        return F._reduce(torch.clamp(-target * (x1 - x2) + self.margin, min=0.0), self.reduction)


class CosineEmbeddingLoss(_Loss):
    """1 - cos(x1, x2) where y == 1, max(0, cos(x1, x2) - margin) where y ==
    -1, the cosine along the last axis."""

    def __init__(self, margin: float = 0.0, reduction: str = "mean"):
        super().__init__(reduction)
        self.margin = margin

    def _fn(self, x1, x2, target):
        cos = CosineSimilarity(dim=x1.ndim - 1)(x1, x2)
        return F._reduce(torch.where(target == 1, 1.0 - cos, torch.clamp(cos - self.margin, min=0.0)),
                         self.reduction)


class GaussianNLLLoss(_Loss):
    """0.5 (log v + (x - t)² / v) with v = max(var, eps), plus 0.5 log 2π
    when ``full``; called as ``loss(input, target, var)``."""

    def __init__(self, full: bool = False, eps: float = 1e-6, reduction: str = "mean"):
        super().__init__(reduction)
        self.full, self.eps = full, eps

    def _fn(self, pred, target, var):
        v = torch.clamp(var, min=self.eps)
        out = 0.5 * (torch.log(v) + (pred - target) ** 2 / v)
        if self.full:
            out = out + 0.5 * math.log(2 * math.pi)
        return F._reduce(out, self.reduction)


class PoissonNLLLoss(_Loss):
    """exp(x) - t x (log-space input, the default) or x - t log(x + eps);
    ``full`` adds Stirling's term t log t - t + 0.5 log(2π t) where t > 1."""

    def __init__(self, log_input: bool = True, full: bool = False, eps: float = 1e-8, reduction: str = "mean"):
        super().__init__(reduction)
        self.log_input, self.full, self.eps = log_input, full, eps

    def _fn(self, pred, target):
        v = torch.exp(pred) - target * pred if self.log_input else pred - target * torch.log(pred + self.eps)
        if self.full:
            big = target > 1
            t = torch.where(big, target, torch.ones_like(target))
            stirling = t * torch.log(t) - t + 0.5 * torch.log(2 * math.pi * t)
            v = v + torch.where(big, stirling, torch.zeros_like(stirling))
        return F._reduce(v, self.reduction)


class TripletMarginWithDistanceLoss(_Loss):
    """max(0, d(a, p) - d(a, n) + margin) with a distance callable (default
    the pairwise Euclidean distance); ``swap`` takes min(d(a, n), d(p, n))."""

    def __init__(self, distance_function=None, margin: float = 1.0, swap: bool = False, reduction: str = "mean"):
        super().__init__(reduction)
        self.distance_function = distance_function if distance_function is not None else PairwiseDistance()
        self.margin, self.swap = margin, swap

    def _fn(self, anchor, positive, negative):
        d = self.distance_function
        d_neg = d(anchor, negative)
        if self.swap:
            d_neg = torch.minimum(d_neg, d(positive, negative))
        return F._reduce(torch.clamp(d(anchor, positive) - d_neg + self.margin, min=0.0), self.reduction)


class TripletMarginLoss(TripletMarginWithDistanceLoss):
    """The triplet rule with the pairwise ``p``-norm of ``x1 - x2 + eps``."""

    def __init__(self, margin: float = 1.0, p: float = 2.0, eps: float = 1e-6, swap: bool = False,
                 reduction: str = "mean"):
        super().__init__(PairwiseDistance(p=p, eps=eps), margin=margin, swap=swap, reduction=reduction)
        self.p, self.eps = p, eps


class KLDivLoss(_Loss):
    _reductions = ("mean", "sum", "none", "batchmean")

    def __init__(self, reduction: str = "mean", log_target: bool = False):
        super().__init__(reduction)
        self.log_target = log_target

    def _fn(self, pred, target):
        return F.kl_div(pred, target, reduction=self.reduction, log_target=self.log_target)


class MultiLabelSoftMarginLoss(_Loss):
    """-1/C Σ_c [y log σ(x) + (1 - y) log σ(-x)], per sample."""

    def _fn(self, pred, target):
        lsig = torch.nn.functional.logsigmoid
        v = -(target * lsig(pred) + (1.0 - target) * lsig(-pred))
        return F._reduce(v.mean(dim=-1), self.reduction)


class MultiMarginLoss(_Loss):
    """1/C Σ_{i != y} max(0, margin - x[y] + x[i])^p with integer class targets."""

    def __init__(self, p: int = 1, margin: float = 1.0, reduction: str = "mean"):
        if p not in (1, 2):
            raise ValueError(f"p must be 1 or 2, got {p}")
        super().__init__(reduction)
        self.p, self.margin = p, margin

    def _fn(self, pred, target):
        y = target.long()
        C = pred.shape[-1]
        xy = pred.gather(-1, y[..., None])
        h = torch.clamp(self.margin - xy + pred, min=0.0) ** self.p
        h = h * (torch.arange(C, device=pred.device) != y[..., None])
        return F._reduce(h.sum(dim=-1) / C, self.reduction)


class MultiLabelMarginLoss(_Loss):
    """Σ_{j in targets} Σ_{i not in targets} max(0, 1 - (x[y_j] - x[i])) / C
    per sample, the target row's class indices ending at its first -1."""

    def _fn(self, pred, target):
        x, y = pred, target.long()
        squeeze = x.ndim == 1
        if squeeze:
            x, y = x[None], y[None]
        C = x.shape[-1]
        valid = torch.cumsum((y < 0).int(), dim=-1) == 0
        y_safe = torch.where(valid, y, torch.zeros_like(y))
        # class c is in the sample's target set; the invalid entries land in a spare column C
        member = torch.zeros((x.shape[0], C + 1), dtype=torch.bool, device=x.device).scatter_(
            1, torch.where(valid, y_safe, torch.full_like(y_safe, C)), True)[:, :C]
        xy = x.gather(1, y_safe)
        h = torch.clamp(1.0 - (xy[:, :, None] - x[:, None, :]), min=0.0)
        v = (h * (valid[:, :, None] & ~member[:, None, :])).sum(dim=(1, 2)) / C
        return F._reduce(v[0] if squeeze else v, self.reduction)


class CTCLoss(_Loss):
    """Connectionist temporal classification: ``ctc(log_probs (T, N, C),
    targets (N, S), input_lengths (N,), target_lengths (N,))`` (module
    docstring)."""

    def __init__(self, blank: int = 0, reduction: str = "mean", zero_infinity: bool = False):
        super().__init__(reduction)
        self.blank, self.zero_infinity = blank, zero_infinity

    def _fn(self, log_probs, targets, input_lengths, target_lengths):
        if targets.ndim != 2:
            raise ValueError("CTCLoss expects padded 2-D targets (N, S); the concatenated 1-D torch form is not "
                             "supported: reshape with per-sequence rows")
        dev = log_probs.device
        il = torch.as_tensor(input_lengths, device=dev).long()
        tl = torch.as_tensor(target_lengths, device=dev).long()
        per_seq = torch.nn.functional.ctc_loss(log_probs, targets.to(dev).long(), il, tl, blank=self.blank,
                                               reduction="none", zero_infinity=self.zero_infinity)
        if self.reduction == "mean":
            return (per_seq / torch.clamp(tl, min=1).to(per_seq.dtype)).mean()
        return F._reduce(per_seq, self.reduction)
