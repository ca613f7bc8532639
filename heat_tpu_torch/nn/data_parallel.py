"""Data-parallel training (reference: ``heat_tpu/nn/data_parallel.py``).

``DataParallel`` wraps a module whose replicas, one a rank, train on the
ranks' shares of each global batch.  The sync fires from the backward, as
in HeAT: post-accumulate-grad hooks fill the buckets of
``core.collectives.plan_grad_buckets`` (over the parameters in reverse,
the order their gradients arrive), each full bucket's mean Allreduce is
launched asynchronously in bucket order, and the end of the backward waits
for them and writes the means into ``.grad``.  So torch's own loop works::

    loss = loss_fn(dp(x), y); loss.backward(); opt.step()

and so does ``step = dp.make_train_step(loss_fn); loss = step(x, y)``.
With ``overlap_sync`` the end of the backward runs
``core.collectives.bucketed_grad_allreduce`` instead (the reference's
opt-in path: buckets in parameter order, two in flight, two-level over
more than one host).

The gradient is that of the GLOBAL batch's mean loss, as the reference's
one program over the global batch gives it: rank r's gradient is weighted
n_r·p/N before the mean (n_r its rows, N the global rows: a DNDarray's
global shape, or one small Allreduce a training forward whose result
stays on the card), so ragged batches average rows, not means.  On more
than one rank a ``BatchNorm`` takes the global batch's statistics (the
reference's default step normalizes over the global batch), one
collective each way (``nn.modules._GlobalBatchNorm``); under
``overlap_sync`` it takes this rank's, as the reference's per-shard step
does.  Rank 0's parameters and buffers are broadcast when a module is
wrapped.  At world size 1 nothing is hooked and nothing moves: a step is
torch's own, bit for bit.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..core import collectives
from ..core.communication import Communication, sanitize_comm
from ..core.dndarray import DNDarray
from .modules import _BatchNorm

__all__ = ["DataParallel", "DataParallelMultiGPU"]


def _local(x):
    """This rank's tensor of ``x``: a DNDarray's local tensor, or ``x``."""
    return x.larray if isinstance(x, DNDarray) else x


def broadcast_module(module: torch.nn.Module, comm: Communication, root: int = 0) -> None:
    """Overwrite every parameter and buffer of ``module`` with ``root``'s."""
    if comm.size > 1:
        with torch.no_grad():
            for t in list(module.parameters()) + list(module.buffers()):
                comm.Bcast(t.data, root=root)


class DataParallel(torch.nn.Module):
    """Wrap ``module`` for synchronous data-parallel training over ``comm``.

    ``optimizer``: a ``DataParallelOptimizer``, built over the module's
    parameters when it has none yet (``DataParallelOptimizer("adam",
    lr=1e-3)``); ``make_train_step`` needs one.  ``blocking`` is accepted
    for the reference's signature, which gives it no behaviour either: the
    buckets are always launched from the backward and awaited at its end.
    ``overlap_sync`` (default: the optimizer's flag), ``grad_bucket_bytes``
    (default: the optimizer's, else the process default) and
    ``sync_domains`` (default: one a host) choose the sync as described in
    the module docstring.
    ``scale_gradient_average`` is accepted for the reference's signature;
    the weight is always the rows' share."""

    def __init__(self, module: torch.nn.Module, comm: Optional[Communication] = None, optimizer=None,
                 blocking: bool = False, scale_gradient_average=None, overlap_sync=None, grad_bucket_bytes=None,
                 sync_domains=None):
        super().__init__()
        self.module = module
        self.comm = sanitize_comm(comm)
        self.optimizer = optimizer
        self.blocking = bool(blocking)
        if overlap_sync is None:
            overlap_sync = getattr(optimizer, "overlap_sync", False)
        if grad_bucket_bytes is None:
            grad_bucket_bytes = getattr(optimizer, "grad_bucket_bytes", None)
        self._hooks = []
        self._scale, self._share = 1.0, 1.0
        self._state = None  # the sync of the backward in progress
        broadcast_module(module, self.comm)
        self._configure(bool(overlap_sync), grad_bucket_bytes, sync_domains)
        if optimizer is not None:
            optimizer._attach(self)

    # -- configuration -------------------------------------------------- #
    def _configure(self, overlap_sync: bool, grad_bucket_bytes, sync_domains) -> None:
        """Plan the buckets and (on more than one rank) hook the parameters."""
        self.overlap_sync, self.grad_bucket_bytes, self.sync_domains = overlap_sync, grad_bucket_bytes, sync_domains
        for h in self._hooks:
            h.remove()
        self._hooks = []
        self._params = [p for p in self.module.parameters() if p.requires_grad]
        # hooked buckets fill in the order the gradients arrive (reverse);
        # the overlapped path plans in parameter order, as the reference does
        self._order = self._params if overlap_sync else self._params[::-1]
        self._plan = collectives.plan_grad_buckets([p.numel() * p.element_size() for p in self._order],
                                                   grad_bucket_bytes)
        self._bucket_of = {id(self._order[j]): k for k, idxs in enumerate(self._plan.buckets) for j in idxs}
        self._domains = collectives._derive_domains(self.comm, sync_domains)
        if self.comm.size > 1:
            if self._domains > 1:
                collectives._hier_comms(self.comm, self._domains)  # every group, once, on every rank
            self._hooks = [p.register_post_accumulate_grad_hook(self._grad_ready) for p in self._params]
        global_bn = self.comm.size > 1 and not overlap_sync
        for m in self.module.modules():
            if isinstance(m, _BatchNorm):
                m._sync = self.comm if global_bn else None

    # -- parameters ----------------------------------------------------- #
    def parameters(self, recurse: bool = True):
        return self.module.parameters(recurse)

    def state_dict(self, *args, **kwargs):
        """The module's state dict (no ``module.`` prefix)."""
        return self.module.state_dict(*args, **kwargs)

    def load_state_dict(self, state_dict, strict: bool = True, assign: bool = False):
        return self.module.load_state_dict(state_dict, strict=strict, assign=assign)

    # -- forward -------------------------------------------------------- #
    def forward(self, x, *args, **kwargs):
        """The module on this rank's rows (a tensor, or a DNDarray split
        along the batch axis: then a DNDarray of the outputs, split 0)."""
        local = _local(x)
        if self.comm.size > 1 and self.training and torch.is_grad_enabled():
            self._weigh_rows(local, x.gshape[0] if isinstance(x, DNDarray) else None)
        y = self.module(local, *args, **kwargs)
        if isinstance(x, DNDarray):
            return DNDarray(y, (x.gshape[0],) + tuple(y.shape[1:]), y.dtype, 0, x.device, x.comm, x.balanced)
        return y

    def _weigh_rows(self, local: torch.Tensor, rows=None) -> None:
        """This rank's gradient weight n·p/N and loss share n/N for this
        training forward: N from a DNDarray's global shape, else from one
        small Allreduce of the rows, kept on the device (no host read)."""
        comm, p, n = self.comm, self.comm.size, local.shape[0]
        if rows is None:
            dev = local.device if local.is_cuda else comm._scratch_device()
            # a fill, not a copy from host memory: a copy would wait for the card's queue
            rows = comm.Allreduce(torch.full((1,), float(n), dtype=torch.float64, device=dev))[0]
            if self.overlap_sync:
                rows = int(rows)  # the one host read, on the per-shard path only
        if self.overlap_sync and rows % p:
            raise ValueError(f"global batch {rows} must be divisible by the data-parallel world size {p} "
                             "(overlap_sync takes each rank's mean, as the reference's per-shard step does)")
        self._scale, self._share = n * p / rows, n / rows

    # -- the sync, from the backward ------------------------------------ #
    def _grad_ready(self, param: torch.Tensor) -> None:
        """Post-accumulate-grad hook: on the first gradient of a backward,
        queue the end-of-backward wait; launch each full bucket in order."""
        st = self._state
        if st is None:
            st = self._state = {"ready": [0] * self._plan.n_buckets, "next": 0, "flights": [],
                                "tele": collectives._Telescope()}
            torch.autograd.Variable._execution_engine.queue_callback(self._finish_sync)
        if self.overlap_sync:
            return
        st["ready"][self._bucket_of[id(param)]] += 1
        self._launch_full(st)

    def _launch_full(self, st, force: bool = False) -> None:
        plan = self._plan
        while st["next"] < plan.n_buckets and (force or st["ready"][st["next"]] == len(plan.buckets[st["next"]])):
            k = st["next"]
            grads = [p.grad for p in self._order]
            st["flights"].append((k, collectives.dispatch_bucket_allreduce(
                self.comm, grads, plan, k, st["tele"], self._domains, "mean", self._scale)))
            st["next"] += 1

    def _finish_sync(self) -> None:
        """End of the backward: every gradient synced into ``.grad``."""
        st, self._state = self._state, None
        for p in self._params:
            if p.grad is None:  # a parameter the loss did not reach still takes part
                p.grad = torch.zeros_like(p)
        if self.overlap_sync:
            collectives.bucketed_grad_allreduce(self.comm, [p.grad for p in self._order], plan=self._plan,
                                                domains=self._domains, scale=self._scale)
            return
        self._launch_full(st, force=True)
        grads = [p.grad for p in self._order]
        for k, flight in st["flights"]:
            collectives._unpack(flight.wait(), grads, self._plan.buckets[k])

    # -- the train step ------------------------------------------------- #
    def make_train_step(self, loss_fn: Callable, with_rng: bool = False, donate: bool = True, overlap_sync=None,
                        grad_bucket_bytes=None, sync_domains=None):
        """``step(x, y) -> loss``: forward on this rank's rows, the loss,
        the backward (which syncs the gradients) and the optimizer's
        guarded update; returns the global batch's mean loss (0-d).
        ``overlap_sync``, ``grad_bucket_bytes`` and ``sync_domains``
        reconfigure the sync when given.  ``with_rng`` and ``donate`` are
        the reference's: dropout draws from torch's generator, and the
        module is updated in place."""
        if self.optimizer is None:
            raise RuntimeError("make_train_step requires an attached optimizer")
        if overlap_sync is not None or grad_bucket_bytes is not None or sync_domains is not None:
            self._configure(self.overlap_sync if overlap_sync is None else bool(overlap_sync),
                            self.grad_bucket_bytes if grad_bucket_bytes is None else grad_bucket_bytes,
                            self.sync_domains if sync_domains is None else sync_domains)
        opt = self.optimizer

        def step(x, y):
            self.train()
            opt.zero_grad(set_to_none=True)
            loss = loss_fn(self(_local(x)), _local(y))
            loss.backward()
            opt.step()
            loss = loss.detach()
            if self.comm.size > 1:
                loss = self.comm.Allreduce(loss * self._share)
            return loss

        return step


class DataParallelMultiGPU(DataParallel):
    """The reference's node-group variant: here the same ``DataParallel``,
    whose sync goes two-level over more than one host."""

    def __init__(self, module: torch.nn.Module, optimizer=None, comm: Optional[Communication] = None):
        super().__init__(module, comm=comm, optimizer=optimizer)
