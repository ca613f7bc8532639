"""Multi-world federation: ingress-fed dispatch across N supervised worlds.

The scheduler (``parallel.scheduler``) is in-process and single-world:
one ``Scheduler`` serves one SPMD world, and when that world dies for good
the only degradation mode is :meth:`Scheduler.drain`.  This module is the
layer above — the federator the ROADMAP's "serving at internet scale"
item names — turning world loss into a *degradation* instead of an outage:

1. **Ingress-fed admission.**  Jobs arrive through
   ``utils/monitor.py``'s HTTP ingress (``POST /submit``) or in-process
   :meth:`Federation.submit`.  Trace ids are minted at the edge (the
   HT109 choke-point contract), every acceptance/shed lands in a
   **federation-level journal** (the same crash-durable
   ``scheduler.JobJournal`` format), and rejection is synchronous and
   structured (:class:`scheduler.JobRejected` — surfaced as HTTP 429/413
   by the monitor).

2. **Memory-aware admission.**  :class:`AdmissionPredictor` keeps a
   persisted per-kind device-memory peak history (fed by
   ``serving.make_executor`` measuring each batch inside a
   ``memledger.peak_window``).  At submit time the job's predicted
   footprint (max observed peak × a safety factor) is checked against
   every healthy world's memledger headroom (capacity − heartbeat-carried
   live bytes): a job no world can fit is shed ``mem_infeasible`` *at the
   edge* — the memory ledger's OOM post-mortem turned into a prevented
   admission.

3. **Health-driven world state machine.**  Each world is
   ``healthy → draining → quarantined → retired``, driven by postmortem
   verdicts (:meth:`Federation.note_verdict`: a world that repeatedly
   reads ``straggler`` drains — no new assignments; one that reads
   ``oom`` is quarantined — its jobs are stolen) and by world death
   (:meth:`Federation.world_lost`).  Transitions are journaled and only
   move forward.

4. **Work-stealing dispatch + zero-loss stealing.**  Queued jobs go to
   the least-loaded healthy world (:meth:`Federation.assign` — an idle
   world steals the next job by having the smallest per-rank load).
   When a world is lost, every job it held that never reached a terminal
   record is requeued (``requeue`` records, journal-first) and
   reassigned: the chaos lane's proof is ``FED worlds=N lost=0`` after
   SIGKILLing an entire world mid-queue.

5. **Elastic resize.**  :func:`resize_target` /
   :meth:`Federation.resize_plan` derive per-world rank targets from the
   journal-visible queue depth; the supervisor applies them *between
   generations* (``Supervisor(resize=...)``) where the checkpoint
   world-reshaping path already guarantees state survives a world-size
   change.

Like ``supervisor.py``/``scheduler.py`` this module is stdlib-only and
standalone-loadable (``importlib.util.spec_from_file_location`` — the
launcher federates worlds without importing torch).  The sibling
``scheduler.py`` provides ``Job``/``JobJournal``/``JobRejected`` and the
journal idiom; it is imported in-package and spec-loaded standalone.
Every federation mutation inherits the **journal-before-mutation
contract** (heatlint HT112): the journal append comes first, and a failed
append propagates with nothing mutated.
"""

from __future__ import annotations

import copy
import json
import math
import os
import sys
import time
import weakref
from typing import Any, Callable, Dict, List, Optional

__all__ = [
    "HEALTHY",
    "DRAINING",
    "QUARANTINED",
    "RETIRED",
    "MEM_INFEASIBLE",
    "AdmissionPredictor",
    "WorldHandle",
    "Federation",
    "replay_federation",
    "requeue_set",
    "fed_summary",
    "attestation_line",
    "resize_target",
    "counters",
    "reset_counters",
]


def _scheduler_mod():
    """The sibling ``scheduler.py`` — in-package when this module was
    imported as part of ``heat_tpu_torch``, spec-loaded standalone otherwise
    (both paths are stdlib-only; the standalone load is what keeps the
    federating launcher torch-free)."""
    if __package__:
        from . import scheduler as s

        return s
    import importlib.util

    name = "heat_federation_scheduler"
    if name in sys.modules:
        return sys.modules[name]
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scheduler.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


_sched = _scheduler_mod()
Job = _sched.Job
JobJournal = _sched.JobJournal
JobRejected = _sched.JobRejected
job_trace_id = _sched.job_trace_id

# scheduler record types reused verbatim (one journal idiom repo-wide)
SUBMITTED = _sched.SUBMITTED
DISPATCHED = _sched.DISPATCHED
DONE = _sched.DONE
FAILED = _sched.FAILED
SHED = _sched.SHED
QUEUE_FULL = _sched.QUEUE_FULL

# federation-only record types
ASSIGNED = "assigned"  # job → world assignment
WORLD = "world"  # world state transition

# world states (the health state machine — transitions only move forward)
HEALTHY = "healthy"
DRAINING = "draining"
QUARANTINED = "quarantined"
RETIRED = "retired"
_STATE_ORDER = {HEALTHY: 0, DRAINING: 1, QUARANTINED: 2, RETIRED: 3}

# admission rejection reason introduced at this layer
MEM_INFEASIBLE = "mem_infeasible"


# ---------------------------------------------------------------------- #
# counters — module-local (standalone loads), mirrored into utils.profiler
# as the pre-prefixed "fed" provider when that is loaded
# ---------------------------------------------------------------------- #
_counters: Dict[str, int] = {}
_provider_registered = False


def counter_inc(name: str, n: int = 1) -> None:
    _counters[name] = _counters.get(name, 0) + int(n)
    _ensure_provider()


def counters() -> Dict[str, int]:
    return dict(_counters)


def reset_counters() -> None:
    _counters.clear()


def _ensure_provider() -> None:
    global _provider_registered
    if _provider_registered:
        return
    prof = sys.modules.get("heat_tpu_torch.utils.profiler")
    if prof is None:
        return
    prof.register_counter_provider("fed", lambda: dict(_counters))
    _provider_registered = True


# ---------------------------------------------------------------------- #
# memory-aware admission: per-kind peak history → footprint prediction
# ---------------------------------------------------------------------- #
class AdmissionPredictor:
    """Persisted per-kind device-memory peak history.

    ``observe(kind, peak_bytes)`` records the memledger-measured
    *incremental* peak of one executed batch of ``kind`` (see
    ``serving.make_executor``'s ``memledger.peak_window`` bracket) and
    keeps the per-kind maximum; ``predict(kind)`` returns that maximum ×
    ``safety``, or ``None`` for a kind never observed.

    **Honesty caveats** (also in design.md): the prediction is a *recorded
    worst case*, not a bound — a payload larger than anything in history
    under-predicts (first ``n=4096`` matmul after a history of ``n=16``),
    and an unobserved kind predicts nothing at all (admitted
    optimistically; its first execution seeds the history).  The safety
    factor absorbs allocator slack, not payload growth.  What the
    predictor guarantees is only this: a job whose kind is KNOWN to peak
    beyond every world's headroom is shed at the edge instead of OOMing a
    world.

    Persistence is a tmp+rename JSON file — crash-safe, last-writer-wins
    (the per-kind max makes concurrent writers converge)."""

    def __init__(self, path: Optional[str] = None, safety: float = 1.2):
        self.path = path
        self.safety = float(safety)
        self.peaks: Dict[str, int] = {}
        if path and os.path.exists(path):
            try:
                with open(path) as fh:
                    data = json.load(fh)
                if isinstance(data, dict):
                    self.peaks = {
                        str(k): int(v)
                        for k, v in data.items()
                        if isinstance(v, (int, float)) and v >= 0
                    }
            except (OSError, ValueError):
                self.peaks = {}  # a torn history is an empty history

    def observe(self, kind: str, peak_bytes: int) -> None:
        """Record one measured peak; keeps the per-kind maximum and
        persists (atomic tmp+rename) when a path is configured."""
        peak_bytes = int(peak_bytes)
        if peak_bytes < 0:
            return
        prev = self.peaks.get(str(kind), -1)
        if peak_bytes <= prev:
            return
        self.peaks[str(kind)] = peak_bytes
        if self.path:
            tmp = f"{self.path}.tmp.{os.getpid()}"
            try:
                with open(tmp, "w") as fh:
                    json.dump(self.peaks, fh, sort_keys=True)
                os.replace(tmp, self.path)
            except OSError:
                pass  # history is advisory; never fail the serving path

    def predict(self, kind: str) -> Optional[int]:
        """Predicted footprint in bytes, or None for an unobserved kind
        (admitted optimistically — see the honesty caveats above)."""
        peak = self.peaks.get(str(kind))
        if peak is None:
            return None
        return int(math.ceil(peak * self.safety))


# ---------------------------------------------------------------------- #
# world handle: the federation-side view of one supervised world
# ---------------------------------------------------------------------- #
class WorldHandle:
    """One supervised world as the federator sees it: a name, a rank
    count, an optional device-memory capacity, an optional heartbeat dir
    (liveness + ``mem_live`` gauges ride the beacons), an optional
    scheduler-journal path (reconciliation + stealing evidence), and an
    optional in-process ``submit(job)`` hook for worlds living in the
    same process (tests, single-host serving)."""

    def __init__(
        self,
        name: str,
        *,
        n_ranks: int = 1,
        capacity_bytes: Optional[int] = None,
        heartbeat_dir: Optional[str] = None,
        journal_path: Optional[str] = None,
        submit: Optional[Callable[[Job], Any]] = None,
    ):
        self.name = str(name)
        self.n_ranks = max(1, int(n_ranks))
        self.capacity_bytes = None if capacity_bytes is None else int(capacity_bytes)
        self.heartbeat_dir = heartbeat_dir
        self.journal_path = journal_path
        self.submit = submit
        self.state = HEALTHY
        self.state_reason: Optional[str] = None
        self.verdicts: List[str] = []  # newest last
        self.assigned: set = set()  # job ids assigned, not yet terminal
        self.generation = 0

    # -- memory view ------------------------------------------------- #
    def live_bytes(self) -> Optional[int]:
        """Sum of the ranks' beacon-carried ``mem_live`` gauges (the
        memledger's live bytes riding the heartbeats), or None when no
        beacon carries one — the federation's read-only view of a
        world's device memory."""
        if not self.heartbeat_dir or not os.path.isdir(self.heartbeat_dir):
            return None
        total, seen = 0, False
        for fname in os.listdir(self.heartbeat_dir):
            if not (fname.startswith("rank") and fname.endswith(".json")):
                continue
            try:
                with open(os.path.join(self.heartbeat_dir, fname)) as fh:
                    payload = json.load(fh)
            except (OSError, ValueError):
                continue
            v = payload.get("mem_live") if isinstance(payload, dict) else None
            if isinstance(v, int):
                total += v
                seen = True
        return total if seen else None

    def headroom_bytes(self) -> Optional[int]:
        """capacity − live (None = unbounded: no capacity configured).
        With a capacity but no beacon-visible live bytes, the full
        capacity is the headroom (optimistic, like an unobserved kind)."""
        if self.capacity_bytes is None:
            return None
        return max(0, self.capacity_bytes - (self.live_bytes() or 0))

    def heartbeat_row(self, stale_after: float = 120.0) -> dict:
        """Per-world liveness summary from the beacons (rank count, worst
        age, min seq) — {} when no dir is configured."""
        if not self.heartbeat_dir or not os.path.isdir(self.heartbeat_dir):
            return {}
        now = time.time()
        ages, seqs = [], []
        for fname in os.listdir(self.heartbeat_dir):
            if not (fname.startswith("rank") and fname.endswith(".json")):
                continue
            path = os.path.join(self.heartbeat_dir, fname)
            try:
                ages.append(now - os.path.getmtime(path))
            except OSError:
                continue
            try:
                with open(path) as fh:
                    payload = json.load(fh)
                if isinstance(payload, dict) and isinstance(payload.get("seq"), int):
                    seqs.append(payload["seq"])
            except (OSError, ValueError):
                pass
        if not ages:
            return {}
        row = {
            "ranks_beating": len(ages),
            "worst_age_s": round(max(ages), 3),
            "stale": max(ages) > stale_after,
        }
        if seqs:
            row["min_seq"] = min(seqs)
            row["seq_lag"] = max(seqs) - min(seqs)
        return row


# ---------------------------------------------------------------------- #
# the federator
# ---------------------------------------------------------------------- #
class Federation:
    """Dispatch across N supervised worlds (see module docstring).

    The federation owns its OWN journal (``scheduler.JobJournal`` format)
    recording every acceptance, shed, world assignment, steal and
    terminal outcome — the cross-world truth the zero-loss proof replays.
    Per-world scheduler journals stay the per-world truth;
    :meth:`reconcile_world_journal` folds their terminal records up into
    the federation journal.

    Every mutation is journal-first (heatlint HT112): the
    ``self.journal.append`` happens before the state change it describes,
    so a failed append propagates with nothing mutated."""

    def __init__(
        self,
        journal: Optional[object] = None,  # path or JobJournal or None
        *,
        max_queue: int = 256,
        predictor: Optional[AdmissionPredictor] = None,
        straggler_drain_after: int = 2,
        stale_after: float = 120.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        if isinstance(journal, str):
            journal = JobJournal(journal)
        self.journal = journal
        self.max_queue = int(max_queue)
        self.predictor = predictor
        self.straggler_drain_after = max(1, int(straggler_drain_after))
        self.stale_after = float(stale_after)
        self.clock = clock
        self.worlds: Dict[str, WorldHandle] = {}
        self._jobs: Dict[str, Job] = {}  # every job ever seen (incl. shed)
        self._queue: List[Job] = []
        self._assignment: Dict[str, str] = {}  # job id → world name
        self._order = 0
        self._ingress_seq = 0
        self._register_monitor_sources()

    # -- observability wiring ---------------------------------------- #
    def _register_monitor_sources(self) -> None:
        """Expose the federation view to ``utils.monitor`` iff loaded
        (``sys.modules`` only — this file must stay standalone-loadable):
        the ``/healthz`` federation rows + the ``fed_worlds_*`` gauges
        both read :meth:`health_report` through a weak reference, so a
        discarded federation is pruned at the next scrape."""
        mon = sys.modules.get("heat_tpu_torch.utils.monitor")
        if mon is None:
            return
        ref = weakref.ref(self)

        def report():
            f = ref()
            return f.health_report() if f is not None else None

        try:
            mon.set_federation_source(report)
        except Exception:
            pass

    # -- worlds ------------------------------------------------------- #
    def add_world(
        self,
        name: str,
        *,
        n_ranks: int = 1,
        capacity_bytes: Optional[int] = None,
        heartbeat_dir: Optional[str] = None,
        journal_path: Optional[str] = None,
        submit: Optional[Callable[[Job], Any]] = None,
    ) -> WorldHandle:
        if name in self.worlds:
            raise ValueError(f"duplicate world {name!r}")
        w = WorldHandle(
            name,
            n_ranks=n_ranks,
            capacity_bytes=capacity_bytes,
            heartbeat_dir=heartbeat_dir,
            journal_path=journal_path,
            submit=submit,
        )
        # journal the birth too: replay then knows the full roster, so
        # `FED worlds=N` is derivable from the journal alone
        if self.journal is not None:
            self.journal.append({"type": WORLD, "world": w.name,
                                 "state": HEALTHY, "reason": "added",
                                 "ranks": w.n_ranks})
        self.worlds[name] = w
        return w

    def _transition(self, w: WorldHandle, state: str, reason: str) -> bool:
        """Move ``w`` forward in the state machine (never backward);
        journal-first.  Returns True when a transition happened."""
        if _STATE_ORDER.get(state, 0) <= _STATE_ORDER.get(w.state, 0):
            return False
        if self.journal is not None:
            self.journal.append({"type": WORLD, "world": w.name,
                                 "state": state, "reason": reason})
        w.state = state
        w.state_reason = reason
        counter_inc(f"fed.worlds.{state}")
        return True

    def note_verdict(self, world: str, verdict: Any) -> str:
        """Feed one postmortem verdict (a string or the analyzer's
        verdict dict) into ``world``'s health: ``oom`` quarantines
        immediately (its jobs are stolen — an OOMing world would convict
        whatever it runs next); ``straggler`` repeated
        ``straggler_drain_after`` times drains (in-flight work finishes,
        nothing new is assigned).  Returns the world's (possibly new)
        state."""
        w = self.worlds[world]
        v = verdict.get("verdict") if isinstance(verdict, dict) else verdict
        v = str(v or "inconclusive")
        w.verdicts.append(v)
        if v == "oom":
            if self._transition(w, QUARANTINED, "verdict:oom"):
                self._steal(w, reason="quarantined:oom")
        elif v == "straggler":
            tail = w.verdicts[-self.straggler_drain_after:]
            if (
                len(tail) == self.straggler_drain_after
                and all(t == "straggler" for t in tail)
            ):
                self._transition(
                    w, DRAINING,
                    f"verdict:straggler x{self.straggler_drain_after}",
                )
        return w.state

    def world_lost(self, world: str, reason: str = "world died") -> int:
        """An entire world is gone (supervisor gave up / every rank
        SIGKILLed): quarantine it and steal every non-terminal job it
        held.  Returns the number of jobs stolen back into the queue."""
        w = self.worlds[world]
        self._transition(w, QUARANTINED, reason)
        return self._steal(w, reason=reason)

    def retire(self, world: str) -> None:
        """Terminal: the world was torn down deliberately after draining/
        quarantine; it stops counting toward any health gate."""
        w = self.worlds[world]
        if w.assigned:
            self._steal(w, reason="retired with work in flight")
        self._transition(w, RETIRED, "retired")

    def _steal(self, w: WorldHandle, reason: str = "stolen") -> int:
        """Requeue every job assigned to ``w`` that never reached a
        terminal record — journal-first per job, so a crash mid-steal
        loses nothing (the un-stolen remainder is still journal-visibly
        assigned to ``w`` and a recovery steals it again)."""
        n = 0
        for jid in sorted(w.assigned):
            job = self._jobs.get(jid)
            if job is None or job.state in (DONE, FAILED, SHED):
                continue
            if self.journal is not None:
                self.journal.append({"type": "requeue", "id": jid,
                                     "world": w.name, "tid": job.trace_id})
            job.state = SUBMITTED
            self._assignment.pop(jid, None)
            self._queue.append(job)
            counter_inc("fed.stolen")
            n += 1
        w.assigned.clear()
        return n

    # -- admission ----------------------------------------------------- #
    def _shed(self, job: Job, reason: str, detail: str = "") -> JobRejected:
        # journal FIRST (the scheduler._shed ordering): a failed append
        # propagates with nothing mutated
        if self.journal is not None:
            self.journal.append({
                "type": SHED, "id": job.job_id, "kind": job.kind,
                "tenant": job.tenant, "reason": reason, "tid": job.trace_id,
            })
        job.state = SHED
        job.reason = reason
        self._jobs[job.job_id] = job
        counter_inc("fed.offered")
        counter_inc("fed.shed")
        counter_inc(f"fed.shed.{reason}")
        return JobRejected(reason, job.job_id, job.tenant, detail)

    def _mem_infeasible(self, job: Job) -> Optional[str]:
        """The admission prediction: detail string when NO healthy world's
        headroom fits the job's predicted footprint; None when feasible
        (or unpredictable — an unobserved kind admits optimistically, and
        a world with no capacity configured fits anything)."""
        if self.predictor is None:
            return None
        predicted = self.predictor.predict(job.kind)
        if predicted is None:
            return None
        rooms = [
            w.headroom_bytes()
            for w in self.worlds.values()
            if w.state == HEALTHY
        ]
        if not rooms or any(r is None for r in rooms):
            return None  # no healthy world yet / an uncapped world fits it
        best = max(rooms)
        if predicted <= best:
            return None
        return (
            f"predicted {predicted} B ({job.kind!r} peak history × "
            f"{self.predictor.safety}) exceeds every healthy world's "
            f"headroom (best {best} B)"
        )

    def submit(self, job: Job) -> str:
        """Admit ``job`` into the federation or raise
        :class:`JobRejected` synchronously (reasons: ``queue_full``,
        ``mem_infeasible``).  Trace identity is minted here — the edge —
        before any admission outcome, so even a shed job's record carries
        the id the client correlates on."""
        existing = self._jobs.get(job.job_id)
        if existing is not None and existing.state != SHED:
            raise ValueError(f"duplicate job id {job.job_id!r}")
        if job.trace_id is None:
            job.trace_id = job_trace_id(job.job_id, job.kind, job.tenant)
        if len(self._queue) >= self.max_queue:
            raise self._shed(
                job, QUEUE_FULL, f"federation queue at its {self.max_queue}-job bound"
            )
        detail = self._mem_infeasible(job)
        if detail is not None:
            raise self._shed(job, MEM_INFEASIBLE, detail)
        job.state = SUBMITTED
        job.submit_t = self.clock()
        self._order += 1
        job._order = self._order
        # journal BEFORE mutating (the submit() contract): a job the
        # journal never saw must not exist in federation state either
        if self.journal is not None:
            self.journal.append(job.to_submit_record())
        self._jobs[job.job_id] = job
        self._queue.append(job)
        counter_inc("fed.offered")
        counter_inc("fed.accepted")
        return job.job_id

    # -- ingress backend (utils/monitor.py HTTP protocol) -------------- #
    def _mint_id(self) -> str:
        while True:
            self._ingress_seq += 1
            jid = f"req{self._ingress_seq:06d}"
            if jid not in self._jobs:
                return jid

    def ingress_submit(self, payload: dict) -> dict:
        """``POST /submit`` backend: build a Job from the request body,
        admit it, answer ``{"id", "trace_id", "state"}``.  Raises
        ``ValueError`` for a malformed body (→ HTTP 400) and
        ``JobRejected`` for a shed (→ HTTP 429, structured)."""
        if not isinstance(payload, dict):
            raise ValueError("request body must be a JSON object")
        kind = payload.get("kind")
        if not kind or not isinstance(kind, str):
            raise ValueError("missing required field 'kind'")
        body = payload.get("payload")
        if body is not None and not isinstance(body, dict):
            raise ValueError("'payload' must be a JSON object")
        job = Job(
            job_id=str(payload.get("id") or self._mint_id()),
            kind=kind,
            tenant=str(payload.get("tenant", "default")),
            priority=int(payload.get("priority", 0) or 0),
            deadline_s=(
                float(payload["deadline_s"])
                if payload.get("deadline_s") is not None
                else None
            ),
            retry_budget=int(payload.get("retry_budget", 2) or 0),
            payload=dict(body or {}),
        )
        self.submit(job)
        return {"id": job.job_id, "trace_id": job.trace_id, "state": job.state}

    def ingress_status(self, job_id: str) -> Optional[dict]:
        """``GET /status/<id>`` backend: the job's current federation
        view, or None (→ 404) for an unknown id."""
        job = self._jobs.get(job_id)
        if job is None:
            return None
        return {
            "id": job.job_id,
            "kind": job.kind,
            "tenant": job.tenant,
            "state": job.state,
            "reason": job.reason,
            "world": self._assignment.get(job.job_id),
            "trace_id": job.trace_id,
        }

    def ingress_result(self, job_id: str) -> Optional[dict]:
        """``GET /result/<id>`` backend: terminal outcome + result when
        the job finished; a pending view otherwise; None (→ 404) for an
        unknown id."""
        job = self._jobs.get(job_id)
        if job is None:
            return None
        out = {"id": job.job_id, "state": job.state, "trace_id": job.trace_id}
        if job.state == DONE:
            out["result"] = job.result
        elif job.state in (FAILED, SHED):
            out["reason"] = job.reason
        else:
            out["detail"] = "not terminal yet; poll /status"
        return out

    # -- dispatch: least-loaded work-stealing assignment ---------------- #
    def assign(self) -> Dict[str, List[Job]]:
        """Assign every queued job to the least-loaded healthy world
        (assigned-per-rank, name tiebreak — deterministic) and return
        ``{world: [jobs newly assigned]}``.  An idle world steals the
        next job by construction; with no healthy world the queue simply
        holds (jobs shed later by deadline, never silently dropped).
        In-process worlds (``submit=`` hook) receive a copy immediately;
        file-fed worlds read their slice from the returned mapping."""
        out: Dict[str, List[Job]] = {}
        self._queue.sort(key=lambda j: (-j.priority, j._order))
        remaining: List[Job] = []
        for job in self._queue:
            # queue hygiene making assign() idempotent under recovery and
            # retry: a job folded up terminal by reconcile_world_journal
            # AFTER recover() requeued it must never dispatch again, and a
            # job a journal-faulted partial pass already assigned (state
            # flipped, still in the queue) must not be handed out twice —
            # it is tracked in its world's `assigned` set; both just leave
            # the queue
            if job.state in (DONE, FAILED, SHED, ASSIGNED):
                continue
            healthy = [w for w in self.worlds.values() if w.state == HEALTHY]
            if not healthy:
                remaining.append(job)
                continue
            w = min(
                healthy,
                key=lambda h: (len(h.assigned) / float(h.n_ranks), h.name),
            )
            if self.journal is not None:
                self.journal.append({"type": ASSIGNED, "id": job.job_id,
                                     "world": w.name, "tid": job.trace_id})
            job.state = ASSIGNED
            w.assigned.add(job.job_id)
            self._assignment[job.job_id] = w.name
            counter_inc("fed.assigned")
            out.setdefault(w.name, []).append(job)
            if w.submit is not None:
                # hand the world its own copy: an in-process scheduler
                # mutating the shared Job would flip federation state to
                # DONE without a federation journal record, so replay
                # would count the job lost and reconcile would skip it
                w.submit(copy.copy(job))
        self._queue = remaining
        return out

    # -- reconciliation: fold world journals up into the federation ----- #
    def reconcile_world_journal(self, world: str, path: Optional[str] = None) -> dict:
        """Replay ``world``'s scheduler journal and fold every terminal
        outcome of a federation-assigned job up into the federation
        journal (journal-first per record).  Jobs the world journal shows
        DONE carry their journaled result; everything the world accepted
        but never finished stays assigned — :meth:`world_lost` steals it.
        Returns ``{"done": n, "failed": n}``."""
        w = self.worlds[world]
        path = path or w.journal_path
        done = failed = 0
        if not path or not os.path.exists(path):
            return {"done": 0, "failed": 0}
        replay = _sched.replay_journal(path)
        for jid, view in replay["jobs"].items():
            job = self._jobs.get(jid)
            if job is None or job.state in (DONE, FAILED, SHED):
                continue
            state = view.get("state")
            if state == DONE:
                if self.journal is not None:
                    rec = {"type": DONE, "id": jid, "world": w.name,
                           "exec_s": view.get("exec_s"), "tid": job.trace_id}
                    if "result" in view:
                        rec["result"] = view.get("result")
                    self.journal.append(rec)
                job.state = DONE
                job.result = view.get("result")
                w.assigned.discard(jid)
                counter_inc("fed.done")
                done += 1
            elif state == FAILED:
                if self.journal is not None:
                    self.journal.append({"type": FAILED, "id": jid,
                                         "world": w.name,
                                         "reason": view.get("reason"),
                                         "tid": job.trace_id})
                job.state = FAILED
                job.reason = view.get("reason")
                w.assigned.discard(jid)
                counter_inc("fed.failed")
                failed += 1
        return {"done": done, "failed": failed}

    # -- recovery: the epoch-scoped anchor discipline, federation-level - #
    def recover(self, path: Optional[str] = None,
                epoch: Optional[int] = None) -> int:
        """Replay a federation journal after the federator itself
        restarted and requeue every accepted-but-unfinished job exactly
        once — :func:`requeue_set` is the shared derivation, so every
        replica replaying the same journal (the two-worlds determinism
        test) requeues the identical set in the identical order with the
        identical charged deadlines.  Assignments are NOT restored: the
        worlds behind them may be gone, and re-assignment through
        :meth:`assign` is idempotent at the journal level."""
        path = path or (self.journal.path if self.journal is not None else None)
        if path is None or not os.path.exists(path):
            return 0
        replay = replay_federation(path)
        now = self.clock()
        n = 0
        for view in requeue_set(replay, epoch=epoch):
            jid = str(view["id"])
            if jid in self._jobs:
                continue  # already live here: never duplicate
            job = Job.from_record(view)
            job.state = SUBMITTED
            job.deadline_s = view.get("deadline_remaining", job.deadline_s)
            job.submit_t = now
            self._order += 1
            job._order = self._order
            if self.journal is not None:
                self.journal.append({"type": "requeue", "id": jid,
                                     "tid": job.trace_id})
            self._jobs[jid] = job
            self._queue.append(job)
            counter_inc("fed.requeued")
            n += 1
        for jid, view in replay["jobs"].items():
            if view.get("state") == DONE and jid not in self._jobs:
                job = Job.from_record(view)
                job.state = DONE
                job.result = view.get("result")
                self._jobs[jid] = job
        self._ingress_seq = max(
            [self._ingress_seq]
            + [
                int(j[3:]) for j in replay["jobs"]
                if j.startswith("req") and j[3:].isdigit()
            ]
        )
        return n

    # -- reporting ------------------------------------------------------ #
    def health_report(self) -> dict:
        """The federation view ``/healthz`` renders and ``/metrics``
        gauges: one row per world (state, ranks, assigned load, recent
        verdicts, beacon liveness, memory headroom) plus the state
        census.  ``ok`` is the satellite's gate: True iff every world
        that is NOT quarantined/retired is healthy — a draining world is
        a 503, a quarantined one is handled degradation."""
        rows = []
        census = {HEALTHY: 0, DRAINING: 0, QUARANTINED: 0, RETIRED: 0}
        for name in sorted(self.worlds):
            w = self.worlds[name]
            census[w.state] = census.get(w.state, 0) + 1
            row = {
                "world": w.name,
                "state": w.state,
                "ranks": w.n_ranks,
                "assigned": len(w.assigned),
                "verdicts": w.verdicts[-3:],
            }
            if w.state_reason:
                row["reason"] = w.state_reason
            hb = w.heartbeat_row(self.stale_after)
            if hb:
                row.update(hb)
            room = w.headroom_bytes()
            if room is not None:
                row["headroom_bytes"] = room
            rows.append(row)
        ok = all(
            w.state == HEALTHY
            for w in self.worlds.values()
            if w.state not in (QUARANTINED, RETIRED)
        )
        return {
            "ok": ok,
            "worlds": rows,
            "healthy": census[HEALTHY],
            "draining": census[DRAINING],
            "quarantined": census[QUARANTINED],
            "retired": census[RETIRED],
            "queue_depth": len(self._queue),
        }

    # -- elastic capacity ----------------------------------------------- #
    def resize_plan(self, *, jobs_per_rank: int = 4, min_ranks: int = 1,
                    max_ranks: Optional[int] = None) -> Dict[str, int]:
        """Per-world rank targets from the current journal-derived load:
        each healthy world's share of the queue plus what it already
        holds, at ``jobs_per_rank`` jobs per rank (see
        :func:`resize_target`).  Applied between generations via
        ``Supervisor(resize=...)`` — the checkpoint world-reshaping path
        owns state across the size change."""
        healthy = [w for w in self.worlds.values() if w.state == HEALTHY]
        plan: Dict[str, int] = {}
        for w in healthy:
            depth = len(w.assigned) + int(
                math.ceil(len(self._queue) / float(len(healthy)))
            )
            plan[w.name] = resize_target(
                depth, w.n_ranks, jobs_per_rank=jobs_per_rank,
                min_ranks=min_ranks, max_ranks=max_ranks,
            )
        return plan

    def attestation(self) -> str:
        """The launcher's greppable ``FED ...`` line, derived from the
        journal alone (the same replay a post-hoc auditor would run)."""
        if self.journal is None:
            summary = fed_summary({"jobs": {}, "worlds": {}, "records": []})
        else:
            summary = fed_summary(replay_federation(self.journal.path))
        return attestation_line(summary)


# ---------------------------------------------------------------------- #
# pure functions: replay / requeue derivation / summary / attestation
# ---------------------------------------------------------------------- #
def resize_target(queue_depth: int, current_ranks: int, *,
                  jobs_per_rank: int = 4, min_ranks: int = 1,
                  max_ranks: Optional[int] = None) -> int:
    """The elastic-capacity formula: ranks to serve ``queue_depth`` jobs
    at ``jobs_per_rank`` jobs per rank, clamped to
    ``[min_ranks, max_ranks]``.  Pure — unit-testable and identical on
    every replica deriving it from the same journal depth."""
    want = int(math.ceil(max(0, int(queue_depth)) / float(max(1, jobs_per_rank))))
    want = max(int(min_ranks), want)
    if max_ranks is not None:
        want = min(int(max_ranks), want)
    return want


def replay_federation(path: str) -> dict:
    """Replay a federation journal into its last-state-wins view:
    ``{"schema", "jobs": {id: view}, "worlds": {name: {"state",
    "transitions"}}, "epochs", "torn", "records"}``.  Job views carry the
    submit fields plus ``state`` (``submitted``/``assigned``/terminal),
    ``world`` (last assignment), ``stolen`` (requeue count) and
    ``result`` for journaled DONE answers.  Built on the scheduler's
    journal format: same header/schema discipline, torn-line tolerance
    via the same reader contract."""
    jobs: Dict[str, dict] = {}
    worlds: Dict[str, dict] = {}
    epochs: List[int] = []
    records: List[dict] = []
    torn = 0
    epoch = 0
    schema_checked = False
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                torn += 1
                continue
            if not isinstance(rec, dict):
                torn += 1
                continue
            kind = rec.get("type")
            if kind == "meta":
                schema = int(rec.get("schema", 0) or 0)
                if schema > _sched.SCHEMA_VERSION:
                    raise _sched.JournalSchemaError(
                        f"federation journal {path!r} was written by schema "
                        f"{schema}; this reader understands <= "
                        f"{_sched.SCHEMA_VERSION}"
                    )
                schema_checked = True
                epoch = int(rec.get("epoch", 0) or 0)
                if epoch not in epochs:
                    epochs.append(epoch)
                records.append(rec)
                continue
            if not schema_checked:
                raise _sched.JournalSchemaError(
                    f"federation journal {path!r} has records before any "
                    "schema header"
                )
            rec.setdefault("epoch", epoch)
            if kind == WORLD:
                name = str(rec.get("world", "?"))
                wv = worlds.setdefault(name, {"state": HEALTHY, "transitions": []})
                wv["state"] = str(rec.get("state", HEALTHY))
                wv["transitions"].append(
                    {"state": wv["state"], "reason": rec.get("reason"),
                     "t": rec.get("t"), "epoch": rec.get("epoch")}
                )
                if rec.get("ranks") is not None:
                    wv["ranks"] = rec.get("ranks")
                records.append(rec)
                continue
            rid = rec.get("id")
            if rid is None:
                torn += 1
                continue
            rid = str(rid)
            records.append(rec)
            view = jobs.get(rid)
            if kind == SUBMITTED:
                if view is None or view.get("state") == SHED:
                    view = dict(rec)
                    view["state"] = SUBMITTED
                    view["submit_t"] = rec.get("t")
                    view["stolen"] = 0
                    jobs[rid] = view
                else:
                    view.setdefault("submit_t", rec.get("t"))
            elif kind == SHED:
                view = jobs.setdefault(rid, dict(rec))
                if view.get("state") != DONE:
                    view["state"] = SHED
                    view["reason"] = rec.get("reason")
            elif view is not None:
                if kind == ASSIGNED:
                    if view.get("state") not in (DONE, FAILED, SHED):
                        view["state"] = ASSIGNED
                        view["world"] = rec.get("world")
                elif kind == "requeue":
                    if view.get("state") not in (DONE, FAILED, SHED):
                        view["state"] = SUBMITTED
                        view.pop("world", None)
                    view["stolen"] = int(view.get("stolen", 0)) + 1
                elif kind == DONE:
                    view["state"] = DONE
                    view["finish_t"] = rec.get("t")
                    view["exec_s"] = rec.get("exec_s")
                    view["world"] = rec.get("world", view.get("world"))
                    if "result" in rec:
                        view["result"] = rec.get("result")
                elif kind == FAILED:
                    if view.get("state") != DONE:
                        view["state"] = FAILED
                        view["reason"] = rec.get("reason")
                        view["finish_t"] = rec.get("t")
    return {
        "schema": _sched.SCHEMA_VERSION,
        "jobs": jobs,
        "worlds": worlds,
        "epochs": epochs,
        "torn": torn,
        "records": records,
    }


def requeue_set(replay: dict, epoch: Optional[int] = None) -> List[dict]:
    """The deterministic requeue derivation every replica must agree on:
    from a :func:`replay_federation` view, the ordered list of job views
    that were accepted but never reached a terminal record —
    priority-desc, then first journal appearance.  Each returned view
    carries ``deadline_remaining``: the original ``deadline_s`` charged
    for the journal-visible elapsed time under the SAME epoch-scoped
    anchor discipline as ``Scheduler.recover`` — only records of
    generations strictly before ``epoch`` (default
    ``HEAT_TPU_RESTART_EPOCH``) move the anchor, so a replica racing
    another replica's fresh epoch-N appends still derives the identical
    budgets."""
    if epoch is None:
        try:
            epoch = int(os.environ.get("HEAT_TPU_RESTART_EPOCH", "0") or 0)
        except ValueError:
            epoch = 0
    pending = [
        v for v in replay["jobs"].values()
        if v.get("state") in (SUBMITTED, ASSIGNED)
    ]
    first_seen: Dict[str, int] = {}
    for i, rec in enumerate(replay["records"]):
        rid = rec.get("id")
        if rid is not None and str(rid) not in first_seen:
            first_seen[str(rid)] = i
    pending.sort(
        key=lambda v: (-int(v.get("priority", 0) or 0),
                       first_seen.get(str(v["id"]), 0))
    )
    anchor = max(
        (rec.get("t") for rec in replay["records"]
         if isinstance(rec.get("t"), (int, float))
         and int(rec.get("epoch", 0) or 0) < epoch),
        default=None,
    )
    out = []
    for v in pending:
        view = dict(v)
        deadline = view.get("deadline_s")
        if deadline is not None and anchor is not None:
            st = view.get("submit_t")
            if isinstance(st, (int, float)):
                deadline = deadline - max(0.0, anchor - st)
        view["deadline_remaining"] = deadline
        out.append(view)
    return out


def fed_summary(replay: dict) -> dict:
    """Aggregate a :func:`replay_federation` view into the attestation's
    numbers.  ``lost`` counts accepted jobs with no terminal record —
    the zero the chaos lane asserts after killing an entire world."""
    jobs = replay["jobs"]
    by_state = {s: 0 for s in (SUBMITTED, ASSIGNED, DONE, FAILED, SHED)}
    stolen = 0
    for v in jobs.values():
        s = v.get("state", SUBMITTED)
        by_state[s] = by_state.get(s, 0) + 1
        stolen += int(v.get("stolen", 0))
    worlds = replay.get("worlds", {})
    quarantined = sum(
        1 for w in worlds.values() if w.get("state") in (QUARANTINED, RETIRED)
    )
    total = len(jobs)
    return {
        "jobs": total,
        "worlds": len(worlds),
        "accepted": total - by_state[SHED],
        "done": by_state[DONE],
        "failed": by_state[FAILED],
        "shed": by_state[SHED],
        "stolen": stolen,
        "lost": by_state[SUBMITTED] + by_state[ASSIGNED],
        "quarantined": quarantined,
        "torn": replay.get("torn", 0),
    }


def attestation_line(summary: dict) -> str:
    """The launcher's one-line federation accounting (the chaos lane
    greps ``FED worlds=N lost=0``)."""
    return (
        f"FED worlds={summary['worlds']} lost={summary['lost']} "
        f"jobs={summary['jobs']} done={summary['done']} "
        f"failed={summary['failed']} shed={summary['shed']} "
        f"stolen={summary['stolen']} quarantined={summary['quarantined']}"
    )
