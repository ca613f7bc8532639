"""Loss modules (reference: ``heat_tpu/nn/losses.py``): torch-style criteria over ``ht.nn.functional``.

Each is a parameter-free ``torch.nn.Module`` with ``reduction`` in
{'mean', 'sum', 'none'} (default 'mean'), called as ``loss(pred, target)``.
The reference's other criteria are not ported yet (ROADMAP A11).
"""

from __future__ import annotations

import torch

from . import functional as F

__all__ = ["CrossEntropyLoss", "L1Loss", "MSELoss", "NLLLoss"]


class _Loss(torch.nn.Module):
    """Criterion base: checks ``reduction`` and applies ``_fn``."""

    _reductions = ("mean", "sum", "none")

    def __init__(self, reduction: str = "mean"):
        super().__init__()
        if reduction not in self._reductions:
            raise ValueError(f"unknown reduction {reduction!r}")
        self.reduction = reduction

    def _fn(self, pred, target):
        raise NotImplementedError

    def forward(self, pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        return self._fn(pred, target)


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
