"""Data-parallel optimizers and DASO (reference: ``heat_tpu/optim/dp_optimizer.py``).

``DataParallelOptimizer("adam" | "adamw" | "sgd", params, **kw)`` builds the
``torch.optim`` optimizer with the hyperparameters of the reference's
``_named_optimizer``, and carries the reference's non-finite guard
(``nonfinite_guard``): a step whose gradients hold any NaN or Inf leaves the
parameters and the optimizer state as they were and counts a skip.
``guard_stats()`` reports ``{"steps", "skipped"}``.  Without ``params`` it
is built over the parameters of the ``DataParallel`` it is attached to
(the reference's ``DataParallelOptimizer("adam", lr=1e-3)``).  ``lr`` may be
a schedule of ``optim.lr_scheduler`` (``step -> lr``), stepped through
``torch.optim.lr_scheduler.LambdaLR`` after each update that is not skipped.

The reference makes the skip decision on the device with ``jnp.where``;
here it is one host read of a single flag a step (the gradients' finite
check), taken before the update is launched.  The gradients it reads are
already synced by ``nn.DataParallel`` (or ``allreduce_grads``), so every
rank decides alike.

``DASO`` is the reference's hierarchical data-parallel SGD on a
('dcn', 'ici') grid of the ranks: rank r is cell (r // ici, r % ici).
Every step the gradients are averaged in the rank's group of ``ici``
contiguous ranks (the fast tier); every ``global_skip`` steps the
parameters are averaged over the strided group of the ``n_groups`` ranks
with the same r % ici (the slow tier), dispatched asynchronously on a
snapshot and blended ``stale_steps`` later with ``staleness_weight``.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core import collectives
from ..core.communication import Communication, sanitize_comm

__all__ = ["DataParallelOptimizer", "DASO", "SGD", "Adam", "AdamW"]


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


class _OptimizerSpec:
    """A named optimizer and its hyperparameters, built once the
    parameters are known (``SGD(lr=0.1)`` without ``params``)."""

    def __init__(self, name: str, **kw):
        _named_optimizer(name, [torch.zeros(1, requires_grad=True)], **{k: v for k, v in kw.items()
                                                                          if k != "lr" or not callable(v)})
        self.name, self.kw = name, kw


def _optimizer(name: str, params, kw: dict):
    return _named_optimizer(name, params, **kw) if params is not None else _OptimizerSpec(name, **kw)


def SGD(params=None, lr: float = 0.01, momentum: float = 0.0, weight_decay: float = 0.0, nesterov: bool = False):
    """torch-style constructor: a ``torch.optim.SGD`` over ``params``, or
    without them a spec that ``DataParallelOptimizer`` builds later."""
    return _optimizer("sgd", params, dict(lr=lr, momentum=momentum, weight_decay=weight_decay, nesterov=nesterov))


def Adam(params=None, lr: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-8):
    return _optimizer("adam", params, dict(lr=lr, betas=betas, eps=eps))


def AdamW(params=None, lr: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-8, weight_decay: float = 1e-2):
    return _optimizer("adamw", params, dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay))


class DataParallelOptimizer:
    """A ``torch.optim`` optimizer with the reference's non-finite guard.

    ``optimizer`` is a name ('sgd' | 'adam' | 'adamw', then ``params`` and
    the hyperparameters as keywords), a spec of :func:`SGD`/:func:`Adam`/
    :func:`AdamW`, or a ``torch.optim.Optimizer``.  Use it as torch's:
    ``loss.backward(); opt.step(); opt.zero_grad()``.  ``step()`` returns
    False when the guard skipped the update.  ``overlap_sync`` and
    ``grad_bucket_bytes`` are picked up by ``nn.DataParallel`` (the
    bucketed sync); ``blocking`` is accepted for the reference's signature
    and, as there, changes nothing."""

    def __init__(self, optimizer, params=None, blocking: bool = False, guard_nonfinite: bool = True,
                 overlap_sync: bool = False, grad_bucket_bytes=None, **kwargs):
        if isinstance(optimizer, str):
            optimizer = _optimizer(optimizer, None, kwargs)
        elif kwargs:
            raise TypeError("hyperparameters go with an optimizer name, not an optimizer instance")
        if isinstance(optimizer, torch.optim.Optimizer) and params is not None:
            raise TypeError("params go with an optimizer name, not an optimizer instance")
        self.blocking = bool(blocking)
        self.overlap_sync = bool(overlap_sync)
        self.grad_bucket_bytes = grad_bucket_bytes
        self.guarded = bool(guard_nonfinite)
        self._spec, self._torch_optimizer, self.scheduler = None, None, None
        self._steps = 0
        self._skipped = 0
        self._dp = None
        if isinstance(optimizer, torch.optim.Optimizer):
            self._torch_optimizer = optimizer
        else:
            self._spec = optimizer
            if params is not None:
                self._build(params)

    def _build(self, params) -> None:
        """The torch optimizer of the spec over ``params`` (once); a
        schedule ``lr`` becomes a ``LambdaLR`` over base rate 1."""
        if self._torch_optimizer is not None:
            return
        kw = dict(self._spec.kw)
        schedule = kw.get("lr") if callable(kw.get("lr")) else None
        if schedule is not None:
            kw["lr"] = 1.0
        self._torch_optimizer = _named_optimizer(self._spec.name, params, **kw)
        if schedule is not None:
            self.scheduler = torch.optim.lr_scheduler.LambdaLR(self._torch_optimizer, schedule)

    def _attach(self, dp) -> None:
        self._dp = dp
        if self._torch_optimizer is None:
            self._build(dp.module.parameters())

    @property
    def torch_optimizer(self) -> torch.optim.Optimizer:
        if self._torch_optimizer is None:
            raise RuntimeError("the optimizer has no parameters yet: pass params, or attach it to a DataParallel "
                               "or a DASO")
        return self._torch_optimizer

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
        """One update from the parameters' ``.grad``; skipped (parameters,
        state and schedule untouched) when the guard finds a non-finite
        gradient."""
        if self.guarded:
            self._steps += 1
            if not self._grads_finite():
                self._skipped += 1
                return False
        self.torch_optimizer.step()
        if self.scheduler is not None:
            self.scheduler.step()
        return True

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.torch_optimizer.zero_grad(set_to_none=set_to_none)

    def allreduce_grads(self, comm: Optional[Communication] = None, grads=None, domains=None):
        """Mean-allreduce ``grads`` (default: the parameters' ``.grad``) over
        ``comm`` in place, through ``core.collectives.bucketed_grad_allreduce``:
        ``grad_bucket_bytes`` buckets, two in flight, two-level over more
        than one domain.  Returns the gradients."""
        if grads is None:
            grads = [p.grad for g in self.param_groups for p in g["params"] if p.grad is not None]
        return collectives.bucketed_grad_allreduce(sanitize_comm(comm), grads, budget=self.grad_bucket_bytes,
                                                   domains=domains)

    def guard_stats(self) -> dict:
        """{'steps', 'skipped'} of the non-finite guard (zeros when unguarded)."""
        return {"steps": self._steps, "skipped": self._skipped}


def _drain(pending) -> None:
    """Complete a dispatched average without using it."""
    if pending is not None and pending[0] is not None:
        for flight in pending[0][1]:
            flight.wait()


class DASO:
    """Hierarchical asynchronous data parallelism on a ('dcn', 'ici') grid.

    Parameters (the reference's): ``local_optimizer``,
    ``total_local_comm_size`` (ranks a group: default the ranks a host,
    ``LOCAL_WORLD_SIZE``, where it divides the world, else the reference's
    power of two up to 8), ``global_skip``, ``stale_steps``,
    ``staleness_weight``, ``warmup_steps`` (full sync every step),
    ``cooldown_epochs`` with ``total_epochs``, ``plateau_tol``,
    ``overlap_sync`` and ``grad_bucket_bytes`` (the slow tier bucketed,
    each rank of a group sending its 1/ici chunk).  ``comm`` is the world
    to grid (default: the world).  ``mesh`` belongs to the JAX package; the
    port takes ``comm``.  ``checkpoint_every``/``checkpoint_dir`` raise
    ``NotImplementedError``: checkpoints need ``core/io.py`` (ROADMAP A10).
    """

    def __init__(self, local_optimizer, total_local_comm_size: Optional[int] = None, global_skip: int = 4,
                 stale_steps: int = 1, staleness_weight: float = 0.5, warmup_steps: int = 4, cooldown_epochs: int = 0,
                 total_epochs: Optional[int] = None, plateau_tol: float = 0.05, mesh=None,
                 checkpoint_every: Optional[int] = None, checkpoint_dir: Optional[str] = None,
                 overlap_sync: bool = False, grad_bucket_bytes=None, comm: Optional[Communication] = None):
        if mesh is not None:
            raise TypeError("DASO takes comm=, not a device mesh (a JAX package argument)")
        if checkpoint_every is not None or checkpoint_dir is not None:
            raise NotImplementedError("DASO checkpoints need core/io.py, which is not ported yet (ROADMAP A10)")
        if isinstance(local_optimizer, DataParallelOptimizer):
            self.local_optimizer = local_optimizer
        else:
            self.local_optimizer = DataParallelOptimizer(local_optimizer)
        self.global_skip = max(int(global_skip), 1)
        self.stale_steps = max(int(stale_steps), 0)
        self.staleness_weight = float(staleness_weight)
        self.warmup_steps = int(warmup_steps)
        self.cooldown_epochs = int(cooldown_epochs)
        self.total_epochs = total_epochs
        self.plateau_tol = float(plateau_tol)
        if self.cooldown_epochs > 0 and total_epochs is None:
            raise ValueError("cooldown_epochs requires total_epochs so DASO knows when the final synchronous "
                             "phase begins (the cooldown switches to full sync for the LAST cooldown_epochs epochs)")
        self._epoch = 0
        self._best_epoch_loss = None
        self.in_cooldown = False
        self.comm = sanitize_comm(comm)
        n = self.comm.size
        ici = total_local_comm_size or collectives._daso_group_size(n)
        if n % ici:
            raise ValueError(f"total_local_comm_size {ici} must divide the world size {n}")
        self.n_groups, self.ici_size = n // ici, ici
        self.overlap_sync = bool(overlap_sync)
        self.grad_bucket_bytes = grad_bucket_bytes
        self.module = None
        self._step_count = 0
        self._pending = None  # (dispatched average, due step)

    # ------------------------------------------------------------------ #
    def init(self, module: torch.nn.Module, key=None, sample_input=None) -> torch.nn.Module:
        """Take ``module`` as this rank's replica: rank 0's parameters and
        buffers broadcast to every rank, the groups made (every rank makes
        every group), the local optimizer built over its parameters.
        ``key`` and ``sample_input`` are the reference's (torch modules are
        built initialized)."""
        from ..nn.data_parallel import broadcast_module

        broadcast_module(module, self.comm)
        rank = self.comm.rank
        self.ici = self.comm.Split(rank // self.ici_size)  # the rank's contiguous group: the fast tier
        self.dcn = self.comm.Split(rank % self.ici_size)  # the strided group: the slow tier
        self.module = module
        self._params = [p for p in module.parameters() if p.requires_grad]
        self.local_optimizer._attach(_Owner(module))
        self._full_plan = collectives.plan_grad_buckets([p.numel() * p.element_size() for p in self._params], 0)
        self._bucket_plan = (collectives.plan_grad_buckets([p.numel() * p.element_size() for p in self._params],
                                                           self.grad_bucket_bytes)
                             if self.overlap_sync else self._full_plan)
        return module

    @property
    def parameters(self):
        return self._params

    def _sync_args(self):
        """(plan, ici chunking) of the slow tier: one flat bucket, or the
        budgeted buckets each rank of a group sending its 1/ici chunk."""
        if self.overlap_sync:
            return self._bucket_plan, (self.ici if self.ici.size > 1 else None)
        return self._full_plan, None

    def _average_now(self, w: float) -> None:
        plan, ici = self._sync_args()
        collectives.bucketed_param_sync(self.dcn, self._params, w, plan=plan, ici=ici)

    def step(self, loss_fn, x, y, key=None):
        """One DASO step on this rank's rows ``x``, ``y`` (its share of the
        global batch: the group's rows, split over its ``ici`` ranks).
        Every step: forward, backward, the gradient mean over the group,
        the local update.  During warmup a full average over the groups;
        after it, every ``global_skip`` steps an average dispatched on a
        snapshot and blended ``stale_steps`` later.  Returns the group's
        mean loss (0-d; no collective across the groups).  ``key`` is the
        reference's: dropout draws from torch's generator."""
        if self.module is None:
            raise RuntimeError("call init(module) before step()")
        x, y = getattr(x, "larray", x), getattr(y, "larray", y)
        opt = self.local_optimizer
        self.module.train()
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(self.module(x), y)
        loss.backward()
        for p in self._params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        collectives.bucketed_grad_allreduce(self.ici, [p.grad for p in self._params], budget=self.grad_bucket_bytes)
        lval = loss.detach().clone()
        if self.ici.size > 1:
            lval = self.ici.Allreduce(lval) / self.ici.size
        opt.step()
        self._step_count += 1
        t = self._step_count
        if t <= self.warmup_steps:
            self._average_now(1.0)
        else:
            if self._pending is not None and t >= self._pending[1]:
                collectives.consume_bucket_averages_all(self.dcn, self._params, self._pending[0],
                                                        self.staleness_weight)
                self._pending = None
            # dispatch only when none is in flight: otherwise stale_steps >
            # global_skip would overwrite the pending average forever
            if t % self.global_skip == 0 and self._pending is None:
                if self.stale_steps == 0:
                    self._average_now(self.staleness_weight)
                else:
                    plan, ici = self._sync_args()
                    self._pending = (collectives.dispatch_all_bucket_averages(self.dcn, self._params, plan=plan,
                                                                              ici=ici), t + self.stale_steps)
        return lval

    def epoch_loss_logic(self, epoch_loss) -> int:
        """The adaptive skip schedule, once an epoch: a cooldown switches to
        full synchronous averaging (``global_skip`` 1, no staleness, weight
        1, any pending average dropped); else a loss that did not improve on
        the best by ``plateau_tol`` (relative) halves ``global_skip``.  Rank
        0's ``epoch_loss`` decides for every rank.  Returns the
        ``global_skip`` in force."""
        self._epoch += 1
        loss = torch.tensor([float(epoch_loss)], dtype=torch.float64, device=self.comm._scratch_device()
                            if self.comm.is_distributed() else "cpu")
        epoch_loss = float(self.comm.Bcast(loss, root=0).item())
        if self.total_epochs is not None and self.cooldown_epochs > 0 and \
                self._epoch >= self.total_epochs - self.cooldown_epochs:
            self.in_cooldown = True
            self.global_skip = 1
            self.stale_steps = 0
            self.staleness_weight = 1.0
            # a pre-cooldown average blended at full weight would overwrite
            # the updates made since its dispatch
            _drain(self._pending)
            self._pending = None
        elif self._best_epoch_loss is not None:
            ref = abs(self._best_epoch_loss)
            improved = (self._best_epoch_loss - epoch_loss) > self.plateau_tol * (ref if ref > 0 else 1.0)
            if not improved and self.global_skip > 1:
                self.global_skip = max(self.global_skip // 2, 1)
        if self._best_epoch_loss is None or epoch_loss < self._best_epoch_loss:
            self._best_epoch_loss = epoch_loss
        return self.global_skip

    def consolidated_params(self) -> dict:
        """{name: the parameter averaged over the groups} (copies), for
        evaluation; every rank calls it."""
        names = [n for n, p in self.module.named_parameters() if p.requires_grad]
        copies = [p.detach().clone() for p in self._params]
        collectives.bucketed_param_sync(self.dcn, copies, 1.0, plan=self._full_plan)
        return dict(zip(names, copies))

    def zero_grad(self) -> None:
        self.local_optimizer.zero_grad()

    def skip_stats(self) -> dict:
        """{'steps': train steps taken, 'skipped': this rank's updates the
        non-finite guard suppressed}."""
        return {"steps": self._step_count, "skipped": self.local_optimizer.guard_stats()["skipped"]}

    def checkpoint(self, directory: Optional[str] = None) -> str:
        raise NotImplementedError("DASO checkpoints need core/io.py, which is not ported yet (ROADMAP A10)")

    def resume(self, directory: Optional[str] = None) -> bool:
        raise NotImplementedError("DASO checkpoints need core/io.py, which is not ported yet (ROADMAP A10)")


class _Owner:
    """What ``DataParallelOptimizer._attach`` reads of its owner: the module."""

    def __init__(self, module):
        self.module = module
