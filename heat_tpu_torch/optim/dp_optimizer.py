"""The data-parallel optimizer's single-process core (reference: ``heat_tpu/optim/dp_optimizer.py``).

``DataParallelOptimizer("adam" | "adamw" | "sgd", params, **kw)`` builds the
``torch.optim`` optimizer with the hyperparameters of the reference's
``_named_optimizer``, and carries the reference's non-finite guard
(``nonfinite_guard``): a step whose gradients hold any NaN or Inf leaves the
parameters and the optimizer state as they were and counts a skip.
``guard_stats()`` reports ``{"steps", "skipped"}``.

The reference makes the skip decision on the device with ``jnp.where``;
here it is one host read of a single flag a step (the gradients' finite
check), taken before the update is launched.  Gradient sync across
processes (DataParallel, DASO, the bucketed sync) is not ported yet
(ROADMAP A8).
"""

from __future__ import annotations

import torch

__all__ = ["DataParallelOptimizer"]


def _named_optimizer(name: str, params, **kw) -> torch.optim.Optimizer:
    table = {
        "sgd": lambda lr=0.01, momentum=0.0, weight_decay=0.0, nesterov=False: torch.optim.SGD(
            params, lr=lr, momentum=momentum, weight_decay=weight_decay, nesterov=nesterov),
        # weight_decay is accepted and not applied, as in the reference's table (optax.adam has none)
        "adam": lambda lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0: torch.optim.Adam(
            params, lr=lr, betas=tuple(betas), eps=eps),
        "adamw": lambda lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-2: torch.optim.AdamW(
            params, lr=lr, betas=tuple(betas), eps=eps, weight_decay=weight_decay),
    }
    if name.lower() not in table:
        raise ValueError(f"Unknown optimizer {name!r}")
    return table[name.lower()](**kw)


class DataParallelOptimizer:
    """A ``torch.optim`` optimizer with the reference's non-finite guard.

    ``optimizer`` is a name ('sgd' | 'adam' | 'adamw', then ``params`` and
    the hyperparameters as keywords) or a ``torch.optim.Optimizer``.  Use it
    as torch's: ``loss.backward(); opt.step(); opt.zero_grad()``.
    ``step()`` returns False when the guard skipped the update."""

    def __init__(self, optimizer, params=None, guard_nonfinite: bool = True, **kwargs):
        if isinstance(optimizer, str):
            if params is None:
                raise ValueError(f"DataParallelOptimizer({optimizer!r}) needs the parameters to optimize")
            optimizer = _named_optimizer(optimizer, params, **kwargs)
        elif params is not None or kwargs:
            raise TypeError("params and hyperparameters go with an optimizer name, not an optimizer instance")
        self.torch_optimizer = optimizer
        self.guarded = bool(guard_nonfinite)
        self._steps = 0
        self._skipped = 0

    @property
    def param_groups(self):
        return self.torch_optimizer.param_groups

    @property
    def state(self):
        return self.torch_optimizer.state

    def _grads_finite(self) -> bool:
        grads = [p.grad for g in self.param_groups for p in g["params"] if p.grad is not None]
        if not grads:
            return True
        return bool(torch.stack([torch.isfinite(g).all() for g in grads]).all())

    def step(self) -> bool:
        """One update from the parameters' ``.grad``; skipped (parameters and
        state untouched) when the guard finds a non-finite gradient."""
        if self.guarded:
            self._steps += 1
            if not self._grads_finite():
                self._skipped += 1
                return False
        self.torch_optimizer.step()
        return True

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.torch_optimizer.zero_grad(set_to_none=set_to_none)

    def guard_stats(self) -> dict:
        """{'steps', 'skipped'} of the non-finite guard (zeros when unguarded)."""
        return {"steps": self._steps, "skipped": self._skipped}
