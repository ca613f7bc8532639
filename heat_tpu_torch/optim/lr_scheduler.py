"""Learning-rate schedules (reference: ``heat_tpu/optim/lr_scheduler.py``).

Each factory returns the reference's ``schedule(step) -> lr`` callable, a
function of the optimizer's update count (0 at the first update), with the
reference's values: optax's formulas, which clamp where torch's
schedulers would go on (``CosineAnnealingLR`` stays at ``eta_min`` past
``T_max``).  ``DataParallelOptimizer`` and ``DASO`` take such a callable as
``lr`` and step it through ``torch.optim.lr_scheduler.LambdaLR``; the
values here are float64, the reference's float32.
"""

from __future__ import annotations

import math

__all__ = [
    "ConstantLR",
    "CosineAnnealingLR",
    "CosineAnnealingWarmRestarts",
    "ExponentialLR",
    "LambdaLR",
    "LinearLR",
    "MultiStepLR",
    "OneCycleLR",
    "PolynomialLR",
    "StepLR",
]


def StepLR(lr: float, step_size: int, gamma: float = 0.1):
    """``lr`` times ``gamma`` every ``step_size`` steps."""
    return lambda step: lr * gamma ** (int(step) // step_size)


def ExponentialLR(lr: float, gamma: float):
    return lambda step: lr * gamma ** int(step)


def CosineAnnealingLR(lr: float, T_max: int, eta_min: float = 0.0):
    """Half a cosine from ``lr`` to ``eta_min`` over ``T_max`` steps, then ``eta_min``."""
    alpha = eta_min / lr if lr else 0.0

    def schedule(step):
        cosine = 0.5 * (1.0 + math.cos(math.pi * min(int(step), T_max) / T_max))
        return lr * ((1.0 - alpha) * cosine + alpha)

    return schedule


def LambdaLR(lr: float, lr_lambda):
    return lambda step: lr * lr_lambda(step)


def MultiStepLR(lr: float, milestones, gamma: float = 0.1):
    """``lr`` times ``gamma`` at each distinct milestone reached."""
    marks = sorted({int(m) for m in milestones})
    return lambda step: lr * gamma ** sum(int(step) >= m for m in marks)


def ConstantLR(lr: float, factor: float = 1.0 / 3.0, total_iters: int = 5):
    """``lr * factor`` for the first ``total_iters`` steps, then ``lr``."""
    return lambda step: lr * factor if int(step) < total_iters else lr


def LinearLR(lr: float, start_factor: float = 1.0 / 3.0, end_factor: float = 1.0, total_iters: int = 5):
    """Linear from ``lr*start_factor`` to ``lr*end_factor`` over ``total_iters`` steps, then constant."""
    start, end = lr * start_factor, lr * end_factor

    def schedule(step):
        frac = 1.0 - min(max(int(step), 0), total_iters) / total_iters
        return (start - end) * frac + end

    return schedule


def PolynomialLR(lr: float, total_iters: int = 5, power: float = 1.0):
    """Polynomial decay of ``lr`` to 0 over ``total_iters`` steps."""
    return lambda step: lr * (1.0 - min(max(int(step), 0), total_iters) / total_iters) ** power


def CosineAnnealingWarmRestarts(lr: float, T_0: int, T_mult: int = 1, eta_min: float = 0.0):
    """SGDR: cosine cycles from ``lr`` to ``eta_min``, the first ``T_0``
    steps long, each ``T_mult`` times the last; a step on a restart gives
    the peak.  The cycle is found in integers (the reference corrects its
    float32 logarithm to the same exact cycle starts)."""

    def schedule(step):
        t_cur, period = int(step), T_0
        if T_mult == 1:
            t_cur %= T_0
        else:
            while t_cur >= period:
                t_cur -= period
                period *= T_mult
        return eta_min + (lr - eta_min) * 0.5 * (1.0 + math.cos(math.pi * t_cur / period))

    return schedule


def OneCycleLR(lr: float, total_steps: int, pct_start: float = 0.3, div_factor: float = 25.0,
               final_div_factor: float = 1e4):
    """torch's one-cycle policy, ``anneal_strategy='cos'``, with its
    fractional phase boundary (the peak at step ``pct_start*total_steps - 1``)."""
    end1 = pct_start * total_steps - 1.0
    init_lr = lr / div_factor
    final_lr = init_lr / final_div_factor
    span = (total_steps - 1.0) - end1

    def _cos(frac, a, b):
        return b + (a - b) * 0.5 * (1.0 + math.cos(math.pi * frac))

    def schedule(step):
        s = float(step)
        if s <= end1:
            return _cos(min(max(s / max(end1, 1e-9), 0.0), 1.0), init_lr, lr)
        return _cos(min(max((s - end1) / max(span, 1e-9), 0.0), 1.0), lr, final_lr)

    return schedule
