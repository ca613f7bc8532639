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

import json
import os
import shutil
import time
import warnings
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
    port takes ``comm``.  ``checkpoint_every`` steps (with ``checkpoint_dir``)
    :meth:`checkpoint` writes the whole training state durably, and
    :meth:`resume` restores it after a restart.
    """

    def __init__(self, local_optimizer, total_local_comm_size: Optional[int] = None, global_skip: int = 4,
                 stale_steps: int = 1, staleness_weight: float = 0.5, warmup_steps: int = 4, cooldown_epochs: int = 0,
                 total_epochs: Optional[int] = None, plateau_tol: float = 0.05, mesh=None,
                 checkpoint_every: Optional[int] = None, checkpoint_dir: Optional[str] = None,
                 overlap_sync: bool = False, grad_bucket_bytes=None, comm: Optional[Communication] = None):
        if mesh is not None:
            raise TypeError("DASO takes comm=, not a device mesh (a JAX package argument)")
        if checkpoint_every is not None and checkpoint_dir is None:
            raise ValueError("checkpoint_every requires checkpoint_dir")
        self.checkpoint_every = int(checkpoint_every) if checkpoint_every else None
        self.checkpoint_dir = checkpoint_dir
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
        from ..utils import profiler as _profiler

        # unique per instance ("daso", "daso2", ...); the bound method is
        # held weakly, so the provider dies with the optimizer
        self.profiler_key = _profiler.register_counter_provider("daso", self._counter_snapshot)

    def _counter_snapshot(self) -> dict:
        """``utils.profiler`` counter provider (polled at reporting time)."""
        s = self.skip_stats()
        return {"steps": s["steps"], "skipped_steps": s["skipped"]}

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
        reference's: dropout draws from torch's generator.

        Telemetry (when enabled): each step runs under a ``daso.step`` span,
        and its wall time feeds the ``daso.step_dispatch_s`` histogram, as in
        the reference; the step-time breakdown reads these spans."""
        from ..utils import telemetry as _tel

        if not _tel._ENABLED:
            return self._step_impl(loss_fn, x, y)
        t0 = time.perf_counter()
        with _tel.span("daso.step", step=self._step_count + 1):
            out = self._step_impl(loss_fn, x, y)
        _tel.observe("daso.step_dispatch_s", time.perf_counter() - t0)
        return out

    def _step_impl(self, loss_fn, x, y):
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
        if self.checkpoint_every and t % self.checkpoint_every == 0:
            self.checkpoint()
        # fault site ``proc.exit``: ``proc.exit:exit=N`` on one rank
        # SIGKILLs it after its Nth step, the deterministic rank death the
        # supervisor detects and recovers from.  Disarmed: one dict miss.
        from ..utils import faults as _faults

        _faults.fire("proc.exit")
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

    _CKPT_NAME = "daso_state.npz"
    _PREV_NAME = "daso_state.prev.npz"
    _META_NAME = "daso_state.meta.json"

    def _world_meta(self) -> dict:
        return {"n_groups": int(self.n_groups), "ici": int(self.ici_size), "devices": int(self.comm.size)}

    def _groups(self, t: torch.Tensor) -> torch.Tensor:
        """(n_groups, *t.shape): every group's ``t``, from one rank of each
        (the ranks of a group hold the same)."""
        if self.dcn.size == 1:
            return t.detach().unsqueeze(0)
        return torch.stack(self.dcn.Allgather(t.detach().contiguous()))

    def _state_entries(self):
        """[(param index, name, tensor)] of the local optimizer's state."""
        state = self.local_optimizer.torch_optimizer.state
        out = []
        for i, p in enumerate(self._params):
            for name, v in sorted(state.get(p, {}).items()):
                if isinstance(v, torch.Tensor):
                    out.append((i, name, v))
        return out

    def _counters(self) -> dict:
        opt = self.local_optimizer
        sched = opt.scheduler
        return {"global_skip": self.global_skip, "stale_steps": self.stale_steps,
                "staleness_weight": self.staleness_weight, "epoch": self._epoch,
                "best_epoch_loss": float("nan") if self._best_epoch_loss is None else float(self._best_epoch_loss),
                "in_cooldown": int(self.in_cooldown), "guard_steps": opt._steps, "guard_skipped": opt._skipped,
                "lr": [float(g["lr"]) for g in opt.param_groups],
                "sched": [-1, -1] if sched is None else [int(sched.last_epoch), int(sched._step_count)]}

    def checkpoint(self, directory: Optional[str] = None) -> str:
        """Checkpoint the whole training state to ``<dir>/daso_state.npz``
        (``io.save_checkpoint``, atomic and fsynced): every group's
        parameters and buffers and its optimizer state, stacked along a
        leading group axis, the step, and the tiers' counters (the skip
        schedule, the non-finite guard's counts, the learning rates).  The
        previous file is kept as ``daso_state.prev.npz``, the fallback of
        :meth:`resume`, and ``daso_state.meta.json`` records the world's
        shape, the step and the optimizer state's layout.  A dispatched
        average still in flight is not saved (the reference's rule).
        Collective; rank 0 writes, so the ranks share the directory.
        Returns the path.  Called every ``checkpoint_every`` steps."""
        from ..core import io as _io

        d = directory or self.checkpoint_dir
        if d is None:
            raise ValueError("no checkpoint directory configured")
        if self.module is None:
            raise RuntimeError("call init(module) before checkpoint()")
        entries = self._state_entries()
        tree = {"params": [self._groups(p) for p in self._params],
                "buffers": [self._groups(b) for b in self.module.buffers()],
                "opt_state": [self._groups(v) for _, _, v in entries],
                "step": self._step_count, "counters": self._counters()}
        path = os.path.join(d, self._CKPT_NAME)
        if self.comm.rank == 0:
            os.makedirs(d, exist_ok=True)
            if os.path.exists(path):  # copied, not moved: path stays durable during the new save
                try:
                    shutil.copy2(path, os.path.join(d, self._PREV_NAME))
                except OSError:
                    pass
            _io.save_checkpoint(tree, path)
            layout = [[i, name, list(v.shape), str(v.dtype).replace("torch.", ""), v.device.type]
                      for i, name, v in entries]
            meta = dict(self._world_meta(), step=int(self._step_count), time=time.time(), opt_state=layout)
            mpath = os.path.join(d, self._META_NAME)
            tmp = f"{mpath}.tmp.{os.getpid()}"
            with open(tmp, "w") as fh:
                json.dump(meta, fh)
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, mpath)
        self.comm.Barrier()
        return path

    def resume(self, directory: Optional[str] = None) -> bool:
        """Restore the newest checkpoint into this optimizer (False where
        there is none).  Call after :meth:`init`: each rank takes its group's
        parameters, buffers and optimizer state.  The sidecar's world shape
        must be this optimizer's (``ValueError`` naming both otherwise); an
        unreadable ``daso_state.npz`` falls back, with a warning, to
        ``daso_state.prev.npz``.  A dispatched average in flight is dropped."""
        from ..core import io as _io

        d = directory or self.checkpoint_dir
        if d is None:
            raise ValueError("no checkpoint directory configured")
        path, prev = os.path.join(d, self._CKPT_NAME), os.path.join(d, self._PREV_NAME)
        if not os.path.exists(path) and not os.path.exists(prev):
            return False
        if self.module is None:
            raise RuntimeError("call init() before resume(): the live module gives the structure to restore into")
        with open(os.path.join(d, self._META_NAME)) as fh:
            meta = json.load(fh)
        want = self._world_meta()
        got = {k: int(meta.get(k, want[k])) for k in want}
        if got != want:
            raise ValueError(f"checkpoint under {d!r} was written by a different world: checkpoint {got} vs this "
                             f"optimizer {want}; rebuild the world with the same n_groups/ici/device count")
        g = self.n_groups
        buffers = list(self.module.buffers())
        layout = meta["opt_state"]
        like = {"params": [torch.empty((g,) + tuple(p.shape), dtype=p.dtype) for p in self._params],
                "buffers": [torch.empty((g,) + tuple(b.shape), dtype=b.dtype) for b in buffers],
                "opt_state": [torch.empty([g] + shape, dtype=getattr(torch, dt)) for _, _, shape, dt, _ in layout],
                "step": 0, "counters": self._counters()}
        try:
            tree = _io.load_checkpoint(like, path)
        except (_io.CheckpointCorruptionError, FileNotFoundError, ValueError) as e:
            if not os.path.exists(prev):
                raise
            warnings.warn(f"newest DASO checkpoint is unusable ({e}); falling back to the preserved previous "
                          f"state {prev!r}")
            from ..utils import health as _health

            _health.counter_inc("health.resume.fallbacks")
            tree = _io.load_checkpoint(like, prev)
        mine = self.comm.rank // self.ici_size
        with torch.no_grad():
            for p, v in zip(self._params, tree["params"]):
                p.copy_(v[mine])
            for b, v in zip(buffers, tree["buffers"]):
                b.copy_(v[mine])
        opt = self.local_optimizer
        state = opt.torch_optimizer.state
        state.clear()
        for (i, name, _, _, dev), v in zip(layout, tree["opt_state"]):
            p = self._params[i]
            state.setdefault(p, {})[name] = v[mine].clone().to(p.device if dev != "cpu" else "cpu")
        c = tree["counters"]
        self.global_skip, self.stale_steps = int(c["global_skip"]), int(c["stale_steps"])
        self.staleness_weight, self._epoch = float(c["staleness_weight"]), int(c["epoch"])
        best = float(c["best_epoch_loss"])
        self._best_epoch_loss = None if best != best else best
        self.in_cooldown = bool(c["in_cooldown"])
        opt._steps, opt._skipped = int(c["guard_steps"]), int(c["guard_skipped"])
        for grp, lr in zip(opt.param_groups, c["lr"]):
            grp["lr"] = float(lr)
        if opt.scheduler is not None and int(c["sched"][0]) >= 0:
            opt.scheduler.last_epoch, opt.scheduler._step_count = int(c["sched"][0]), int(c["sched"][1])
            opt.scheduler._last_lr = [float(lr) for lr in c["lr"]]
        self._step_count = int(tree["step"])
        _drain(self._pending)
        self._pending = None
        return True


class _Owner:
    """What ``DataParallelOptimizer._attach`` reads of its owner: the module."""

    def __init__(self, module):
        self.module = module
