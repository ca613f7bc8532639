"""Bucketed gradient sync (reference: ``heat_tpu/core/collectives.py``).

Gradients, or DASO's parameters, are packed into byte-budgeted buckets
(:func:`plan_grad_buckets`, the reference's packing exactly), each bucket
flattened into one contiguous buffer and reduced by one asynchronous
collective.  The executors are lookahead-1 pipelines: bucket k+1's
collective is dispatched before bucket k is awaited and unpacked, so at
most two buckets are in flight.

Where the ranks span more than one domain (a host: ``LOCAL_WORLD_SIZE``
ranks a host, :func:`_derive_domains`), the mean-allreduce takes the
reference's two levels over :meth:`Communication.Split`'s subgroups:
reduce-scatter within a domain's contiguous ranks, Allreduce of the 1/i
shard across the strided transversal, allgather back.  The stages' wire
bytes telescope to the flat ring's 2(p-1)/p and are accounted under
``Allreduce`` on the caller's communicator (``comm.traffic()``), so the
sum over any split into buckets equals one bucket's to the byte.

DASO's halves (:func:`bucketed_param_sync`,
:func:`dispatch_all_bucket_averages`, :func:`consume_bucket_averages_all`)
average the parameters over the strided group of the ('dcn', 'ici') grid
(``comm``) and blend the average into them in place.  A dispatch snapshots
the parameters into the buckets' buffers, so the local steps that follow
may change them; the blend runs after ``wait()``, on the current stream.

Runtime hooks, as in the JAX package: each bucket's wait runs through
``health.guard_blocking`` (under an armed ``comm.deadline`` a hung bucket
raises ``CollectiveTimeoutError`` at that bucket; with telemetry armed its
blocked time lands as a ``comm.allreduce.wait`` record), and with the
memory ledger armed (``_MEMLEDGER``, poked in by ``utils.memledger``) each
bucket fires the ``mem.alloc`` fault site ahead of its flat buffer, which
is registered as a ``transient`` and consumed once unpacked.  Every bucket
counts under ``comm.allreduce.buckets`` and the largest under
``comm.allreduce.peak_bucket_bytes``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch

from .redistribution import parse_budget

__all__ = [
    "GradBucketPlan",
    "plan_grad_buckets",
    "set_grad_bucket_budget",
    "get_grad_bucket_budget",
    "bucketed_param_sync",
    "dispatch_bucket_averages",
    "consume_bucket_averages",
    "dispatch_all_bucket_averages",
    "consume_bucket_averages_all",
    "bucketed_grad_allreduce",
    "dispatch_bucket_allreduce",
]


_DEFAULT_BUDGET: Optional[int] = parse_budget(os.environ.get("HEAT_TPU_GRAD_BUCKET_BYTES"))

# device-memory-ledger hook (``utils.memledger.enable()`` pokes the module
# in); disabled cost: one module-global load a bucket
_MEMLEDGER = None


def set_grad_bucket_budget(budget) -> Optional[int]:
    """Set the process-wide default bucket budget (bytes, K/M/G suffixes;
    ``None``/0: unbounded, one bucket).  Returns the previous value."""
    global _DEFAULT_BUDGET
    prev = _DEFAULT_BUDGET
    _DEFAULT_BUDGET = parse_budget(budget)
    return prev


def get_grad_bucket_budget() -> Optional[int]:
    """The process-wide default bucket budget in bytes (None: one bucket)."""
    return _DEFAULT_BUDGET


# ---------------------------------------------------------------------- #
# planner (pure)
# ---------------------------------------------------------------------- #
@dataclass(frozen=True)
class GradBucketPlan:
    """Leaves packed into K contiguous byte-budgeted buckets: ``buckets[k]``
    holds bucket k's leaf indices, in order."""

    leaf_nbytes: Tuple[int, ...]
    budget: Optional[int]
    buckets: Tuple[Tuple[int, ...], ...]
    total_bytes: int
    reason: str

    @property
    def n_buckets(self) -> int:
        return len(self.buckets)

    def bucket_nbytes(self, k: int) -> int:
        return sum(self.leaf_nbytes[j] for j in self.buckets[k])

    @property
    def max_bucket_bytes(self) -> int:
        return max((self.bucket_nbytes(k) for k in range(self.n_buckets)), default=0)


def plan_grad_buckets(leaf_nbytes: Sequence[int], budget=None) -> GradBucketPlan:
    """Pack leaves (their byte sizes, in order) into buckets of at most
    ``budget`` bytes.  ``budget=None`` takes the process default
    (:func:`set_grad_bucket_budget`, ``HEAT_TPU_GRAD_BUCKET_BYTES``); 0
    forces one bucket.  A leaf larger than the budget gets a bucket of its
    own."""
    sizes = tuple(int(n) for n in leaf_nbytes)
    total = sum(sizes)
    budget = get_grad_bucket_budget() if budget is None else parse_budget(budget)
    if not sizes:
        return GradBucketPlan(sizes, budget, (), 0, "no-leaves")
    if budget is None:
        return GradBucketPlan(sizes, None, (tuple(range(len(sizes))),), total, "no-budget")
    if total <= budget:
        return GradBucketPlan(sizes, budget, (tuple(range(len(sizes))),), total, "fits-in-budget")
    buckets: List[Tuple[int, ...]] = []
    cur: List[int] = []
    cur_bytes = 0
    for j, nb in enumerate(sizes):
        if cur and cur_bytes + nb > budget:
            buckets.append(tuple(cur))
            cur, cur_bytes = [], 0
        cur.append(j)
        cur_bytes += nb
    if cur:
        buckets.append(tuple(cur))
    return GradBucketPlan(sizes, budget, tuple(buckets), total, "bucketed")


# ---------------------------------------------------------------------- #
# stage math
# ---------------------------------------------------------------------- #
def _hier_stage_factors(p: int, d: int) -> Optional[Tuple[float, float, float]]:
    """Wire factors (reduce-scatter, cross-domain exchange, allgather) of a
    two-level allreduce over ``p = d·i`` ranks, in payloads; ``None`` where
    the hierarchy degenerates (one domain, or one rank a domain).  They
    telescope: (i-1)/i + 2(d-1)/(d·i) + (i-1)/i = 2(p-1)/p."""
    if d <= 1 or p % d or p // d <= 1:
        return None
    i = p // d
    return ((i - 1) / i, 2.0 * (d - 1) / (d * i), (i - 1) / i)


def _daso_stage_factors(d: int, i: int) -> Tuple[float, float]:
    """Wire factors (cross-group exchange, allgather) of DASO's chunked
    parameter average over d groups of i ranks, in one group's payloads
    (the reduce-scatter is a local slice: the i ranks hold one replica)."""
    return (2.0 * (d - 1) / (d * i), (i - 1) / i)


def _hier_groups(p: int, d: int):
    """(intra, inter) rank lists of ``p`` ranks in ``d`` contiguous domains
    of ``i = p // d``: the contiguous blocks, and the strided transversals
    (member k of every domain)."""
    i = p // d
    intra = [list(range(g * i, (g + 1) * i)) for g in range(d)]
    inter = [[g * i + k for g in range(d)] for k in range(i)]
    return intra, inter


class _Telescope:
    """Cumulative-rounding byte accountant: ``wire(x)`` returns
    ``round(moved + x) - accounted``, so the sum over any split into stages
    and buckets equals the one-bucket ``round(total)`` to the byte."""

    __slots__ = ("moved", "accounted")

    def __init__(self):
        self.moved = 0.0
        self.accounted = 0

    def wire(self, nbytes: float) -> int:
        self.moved += nbytes
        w = int(round(self.moved)) - self.accounted
        self.accounted += w
        return w


def _account_stages(comm, tele: _Telescope, payload: float, factors) -> None:
    """One ``Allreduce`` call a stage on ``comm``'s traffic, telescoped."""
    for f in factors:
        if f > 0.0:
            comm._account_bytes("Allreduce", tele.wire(payload * f))


def _ranks_per_host(p: int) -> Optional[int]:
    """The launcher's ranks a host (``LOCAL_WORLD_SIZE``) where it divides
    the ``p`` ranks, else None: the one place the host layout is read."""
    local = int(os.environ.get("LOCAL_WORLD_SIZE", "0") or 0)
    return local if local > 0 and p % local == 0 else None


def _daso_group_size(p: int) -> int:
    """DASO's default ranks a group of ``p``: the ranks a host, else the
    reference's largest power of two up to 8 that divides ``p``."""
    local = _ranks_per_host(p)
    if local is not None:
        return local
    i = 1
    while i * 2 <= min(p, 8) and p % (i * 2) == 0:
        i *= 2
    return i


def _derive_domains(comm, domains=None) -> int:
    """The slow-domain count: one domain a host (:func:`_ranks_per_host`)
    where that divides the ranks, else 1; an explicit ``domains``
    overrides.  1 where the hierarchy would degenerate (flat path)."""
    p = comm.size
    if domains is None:
        local = _ranks_per_host(p)
        d = p // local if local else 1
    else:
        d = int(domains)
    if d <= 1 or p % d or p // d <= 1:
        return 1
    return d


def _hier_comms(comm, d: int):
    """(intra, inter) subgroup communicators of ``comm`` for ``d`` domains,
    made once (every rank creates every group) and kept on ``comm``."""
    cache = comm.__dict__.setdefault("_hier_comms", {})
    if d not in cache:
        i = comm.size // d
        cache[d] = (comm.Split(comm.rank // i), comm.Split(comm.rank % i))
    return cache[d]


def _flatten(tensors, idxs) -> torch.Tensor:
    """Bucket ``idxs`` of ``tensors`` copied into one contiguous 1-D buffer."""
    return torch.cat([tensors[j].detach().reshape(-1) for j in idxs])


def _unpack(flat: torch.Tensor, tensors, idxs) -> None:
    """Bucket ``idxs``' slices of ``flat`` copied back into ``tensors``."""
    off = 0
    for j in idxs:
        t = tensors[j]
        t.copy_(flat[off: off + t.numel()].view_as(t))
        off += t.numel()


# ---------------------------------------------------------------------- #
# gradient mean-allreduce (DataParallel, the ici tier of DASO)
# ---------------------------------------------------------------------- #
class _GradBucket:
    """One bucket in flight: its flat buffer and the stages still to run."""

    def __init__(self, flat, n: int, first, rest=None):
        self.flat, self.n, self._first, self._rest = flat, n, first, rest

    def wait(self) -> torch.Tensor:
        """The bucket's result, awaited through the deadline watchdog."""
        from ..utils import health as _hlth

        def _await():
            out = self._first.wait()
            if self._rest is not None:
                out = self._rest(out)
            return out[: self.n]

        out = _hlth.guard_blocking(_await, "comm.allreduce")
        _ledger_consume(self.flat)
        return out


def _note_bucket(bucket_bytes: int) -> None:
    """Count the bucket and, with the ledger armed, fire ``mem.alloc``
    ahead of its flat buffer (chaos runs inject a mid-sync allocation
    failure here)."""
    from ..utils import profiler as _prof
    from ..utils import telemetry as _tel

    _tel.counter_inc("comm.allreduce.buckets", 1)
    _prof.counter_max("comm.allreduce.peak_bucket_bytes", bucket_bytes)
    ml = _MEMLEDGER
    if ml is not None:
        ml.alloc_check(bucket_bytes, "comm.allreduce.bucket")


def _ledger_register(flat: torch.Tensor) -> None:
    ml = _MEMLEDGER
    if ml is not None:
        # explicit category: an in-flight sync transient even inside a
        # daso.step span (which would infer opt-state)
        ml.register(flat, op="allreduce.bucket", site="allreduce.bucket", category="transient")


def _ledger_consume(flat: torch.Tensor) -> None:
    ml = _MEMLEDGER
    if ml is not None:
        ml.consume(flat)


def dispatch_bucket_allreduce(comm, tensors, plan: GradBucketPlan, k: int, tele: _Telescope, d: int,
                              op: str = "mean", scale: float = 1.0) -> _GradBucket:
    """Flatten bucket ``k`` of ``tensors`` into one buffer (times
    ``scale``, a number or a 0-d tensor), account its stages and dispatch
    its first collective: the
    flat Allreduce where ``d`` is 1, else the reduce-scatter within the
    domain.  ``op`` is ``'mean'`` or ``'sum'`` over the ranks."""
    p = comm.size
    idxs = plan.buckets[k]
    _note_bucket(plan.bucket_nbytes(k))
    flat = _flatten(tensors, idxs)
    _ledger_register(flat)
    n = flat.numel()
    if isinstance(scale, torch.Tensor) or scale != 1.0:  # a tensor scale stays on the device: no host read
        flat.mul_(scale)
    factors = _hier_stage_factors(p, d)
    _account_stages(comm, tele, plan.bucket_nbytes(k), factors or (2.0 * (p - 1) / p,))
    if factors is None:
        def finish(out):
            return out.div_(p) if op == "mean" else out

        return _GradBucket(flat, n, comm.Iallreduce(flat, account=False), finish)
    intra, inter = _hier_comms(comm, d)
    i = p // d
    pad = (-n) % i
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])

    def finish(chunk):
        # the 1/i shard across the domains, then the allgather back
        chunk = inter.Iallreduce(chunk, account=False).wait()
        if op == "mean":
            chunk.div_(p)
        return intra.Iallgather(chunk, out=flat, account=False).wait()

    return _GradBucket(flat, n, intra.Ireduce_scatter(flat, account=False), finish)


def bucketed_grad_allreduce(comm, tensors, budget=None, domains=None, plan: Optional[GradBucketPlan] = None,
                            op: str = "mean", scale: float = 1.0):
    """Mean- (or sum-) allreduce ``tensors`` (this rank's gradients) over
    ``comm``'s ranks in place, bucketed and, over more than one domain,
    two-level; bucket k+1's collective is in flight while bucket k is
    awaited and unpacked.  ``scale`` multiplies this rank's contribution
    first (a ragged batch's weight).  Returns ``tensors``."""
    tensors = list(tensors)
    if not comm.is_distributed():
        if isinstance(scale, torch.Tensor) or scale != 1.0:
            for t in tensors:
                t.mul_(scale)
        return tensors
    if op not in ("mean", "sum"):
        raise ValueError(f"op must be 'mean' or 'sum', got {op!r}")
    d = _derive_domains(comm, domains)
    if plan is None:
        plan = plan_grad_buckets([t.numel() * t.element_size() for t in tensors], budget)
    tele = _Telescope()
    flight = dispatch_bucket_allreduce(comm, tensors, plan, 0, tele, d, op, scale) if plan.n_buckets else None
    for k in range(plan.n_buckets):
        nxt = (dispatch_bucket_allreduce(comm, tensors, plan, k + 1, tele, d, op, scale)
               if k + 1 < plan.n_buckets else None)
        _unpack(flight.wait(), tensors, plan.buckets[k])
        flight = nxt
    return tensors


# ---------------------------------------------------------------------- #
# DASO: parameter averages over the strided group
# ---------------------------------------------------------------------- #
def dispatch_bucket_averages(comm, leaves, plan: GradBucketPlan, k: int, tele: _Telescope,
                             ici=None) -> _GradBucket:
    """Snapshot bucket ``k`` of the parameters ``leaves`` and dispatch its
    sum over ``comm`` (the d groups).  With ``ici`` (the rank's group of
    i > 1 ranks holding one replica) each rank sends only its 1/i chunk,
    and the wait gathers the average back over ``ici``.  Returns the bucket
    in flight; its ``wait()`` gives the average."""
    d = comm.size
    i = 1 if ici is None else ici.size
    idxs = plan.buckets[k]
    _note_bucket(plan.bucket_nbytes(k))
    flat = _flatten(leaves, idxs)
    _ledger_register(flat)
    n = flat.numel()
    _account_stages(comm, tele, plan.bucket_nbytes(k), _daso_stage_factors(d, i))
    if i == 1:
        return _GradBucket(flat, n, comm.Iallreduce(flat, account=False), lambda out: out.div_(d))
    pad = (-n) % i
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    mine = flat.view(i, -1)[ici.rank].clone()  # the reduce-scatter is a local slice

    def finish(chunk):
        return ici.Iallgather(chunk.div_(d), out=flat, account=False).wait()

    return _GradBucket(flat, n, comm.Iallreduce(mine, account=False), finish)


def consume_bucket_averages(comm, leaves, avg: _GradBucket, plan: GradBucketPlan, k: int, w) -> None:
    """Await bucket ``k``'s average and blend it into the parameters in
    place: ``(1 - w) * p + w * avg``."""
    flat = avg.wait()
    off = 0
    with torch.no_grad():
        for j in plan.buckets[k]:
            p = leaves[j]
            a = flat[off: off + p.numel()].view_as(p)
            p.copy_(a if w == 1.0 else (1.0 - w) * p + w * a)
            off += p.numel()


def _param_plan(leaves, plan, budget) -> GradBucketPlan:
    return plan if plan is not None else plan_grad_buckets([a.numel() * a.element_size() for a in leaves], budget)


def bucketed_param_sync(comm, params, w, plan: Optional[GradBucketPlan] = None, budget=None, ici=None):
    """DASO's immediate cross-group sync: each bucket's average over
    ``comm`` blended into ``params`` (in place) with weight ``w`` (1.0: the
    full average), bucket k+1 in flight while bucket k blends.  Returns
    ``params``."""
    leaves = list(params)
    if comm.size <= 1:
        return leaves  # one group: the average is the identity
    plan = _param_plan(leaves, plan, budget)
    tele = _Telescope()
    flight = dispatch_bucket_averages(comm, leaves, plan, 0, tele, ici) if plan.n_buckets else None
    for k in range(plan.n_buckets):
        nxt = dispatch_bucket_averages(comm, leaves, plan, k + 1, tele, ici) if k + 1 < plan.n_buckets else None
        consume_bucket_averages(comm, leaves, flight, plan, k, w)
        flight = nxt
    return leaves


def dispatch_all_bucket_averages(comm, params, plan: Optional[GradBucketPlan] = None, budget=None, ici=None):
    """Dispatch every bucket's average of a snapshot of ``params`` without
    consuming (DASO's stale path: blended ``stale_steps`` later).  Returns
    ``(plan, [buckets in flight])``, or None where ``comm`` has one group."""
    leaves = list(params)
    if comm.size <= 1:
        return None
    plan = _param_plan(leaves, plan, budget)
    tele = _Telescope()
    return plan, [dispatch_bucket_averages(comm, leaves, plan, k, tele, ici) for k in range(plan.n_buckets)]


def consume_bucket_averages_all(comm, params, pending, w):
    """Blend a :func:`dispatch_all_bucket_averages` result into ``params``
    in place, bucket by bucket.  Returns ``params``."""
    leaves = list(params)
    if pending is None:
        return leaves
    plan, flights = pending
    for k in range(plan.n_buckets):
        consume_bucket_averages(comm, leaves, flights[k], plan, k, w)
    return leaves


# the memory ledger may have been env-armed (HEAT_TPU_MEMLEDGER=1) before
# this module finished importing: its poke then missed this module
def _rearm_memledger() -> None:
    global _MEMLEDGER
    import sys

    ml = sys.modules.get("heat_tpu_torch.utils.memledger")
    if ml is not None and getattr(ml, "enabled", lambda: False)():
        _MEMLEDGER = ml


_rearm_memledger()
