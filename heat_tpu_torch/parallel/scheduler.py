"""Elastic multi-tenant job scheduler: the serving front end of the runtime.

The supervisor (``parallel.supervisor``) can detect a dead rank, tear the world down, relaunch
it and resume — but nothing feeds it work: every survival guarantee so far
is proven for ONE long-running training job.  This module is the missing
front end for the "heavy traffic from millions of users" scenario: a queue
of heterogeneous jobs (KMeans fits, matmul/solve requests, NN forward
batches), each carrying a tenant, a priority, a deadline and a retry
budget, served *through* rank failures with an explicit contract:

    every job the scheduler ACCEPTS ends DONE, or FAILED with a named
    reason — never silently lost, never wedged, however many times the
    world underneath restarts.

Robustness is enforced at four layers:

1. **Admission control** — the queue is bounded; a submit that cannot be
   admitted raises a structured :class:`JobRejected`
   (``reason=queue_full | deadline_infeasible | tenant_cap``) *immediately*
   — load is shed, never buffered into a hang.  Per-tenant in-flight caps
   keep one chatty tenant from starving the rest of the bounded queue.

2. **Per-job deadline + retry enforcement** — every dispatch runs under
   the collective deadline machinery (``comm.deadline`` /
   ``health.deadline`` — the same contextvar; see design.md): a wedged
   collective trips ``CollectiveTimeoutError`` at the *offending job*,
   which is retried via ``faults.call_with_retries`` while its remaining
   wall budget lasts.  Attempts and give-ups are visible as
   ``sched.<kind>.retries`` / ``sched.<kind>.exhausted`` counters.

3. **Crash-durable job state** — an append-only job journal (one JSON
   record per line, created via tmp+rename so a header is never torn,
   flushed per record but NOT fsynced: like the flight recorder, the page
   cache outlives the process, so the journal survives SIGKILL/OOM but
   not kernel panic / power loss).  The record stream per job is
   ``submit → dispatch(seq, attempt)* → done | failed(reason)`` (plus
   ``shed`` for admission rejections and ``requeue`` for recoveries).
   After a world restart, :meth:`Scheduler.recover` replays the journal
   and requeues every accepted-but-unfinished job exactly once —
   idempotent by job id, so a DONE job is never executed twice.

4. **Graceful degradation** — when the world is gone for good (restart
   budget exhausted, generation draining), :meth:`Scheduler.drain` fails
   the remaining queue in priority order with reason
   ``world_unavailable``; :meth:`Scheduler.report` names every job's
   outcome either way.

Compatible requests (same :func:`Job.batch_key`) micro-batch into one
shared dispatch (in the reference, repeated shapes reuse its program
cache; the port runs eagerly and caches none); every finished job leaves a ``sched.job``
telemetry event (tenant, kind, queue wait, attempts, outcome) from which
``scripts/telemetry_report.py`` renders the per-tenant latency/SLO table.

Like ``supervisor.py``, this module is stdlib-only and standalone-loadable
(``importlib.util.spec_from_file_location``) — the supervising launcher
replays journals without importing torch.  Integration with the runtime is
via ``sys.modules`` hooks only: ``utils.faults`` (fault sites
``sched.dispatch`` / ``sched.journal.write`` + ``call_with_retries``),
``utils.health`` (deadline + watchdog), ``utils.telemetry`` (job events)
and ``utils.profiler`` (counter mirror) are used when loaded and silently
absent otherwise.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import sys
import time
import weakref
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

__all__ = [
    "Job",
    "JobRejected",
    "JobJournal",
    "JournalSchemaError",
    "WorldBroken",
    "Scheduler",
    "replay_journal",
    "jobs_summary",
    "attestation_line",
    "SCHEMA_VERSION",
    "counters",
    "reset_counters",
    "job_trace_id",
    "trace_continuity",
]

SCHEMA_VERSION = 1

# job states (journal record types double as the state names)
SUBMITTED = "submitted"
DISPATCHED = "dispatched"
DONE = "done"
FAILED = "failed"
SHED = "shed"

_TERMINAL = (DONE, FAILED, SHED)

# admission rejection reasons
QUEUE_FULL = "queue_full"
DEADLINE_INFEASIBLE = "deadline_infeasible"
TENANT_CAP = "tenant_cap"

# failure reasons
DEADLINE_EXPIRED = "deadline_expired"
RETRIES_EXHAUSTED = "retries_exhausted"
WORLD_UNAVAILABLE = "world_unavailable"
WORLD_BROKEN = "world_broken"


# ---------------------------------------------------------------------- #
# counters — module-local (this file must load standalone), mirrored into
# utils.profiler as the pre-prefixed "sched" provider when that is loaded
# (the health.py pattern: the supervisor process never pays a torch import)
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
    # keys are emitted pre-prefixed ("sched.*"): passed through verbatim
    prof.register_counter_provider("sched", lambda: dict(_counters))
    _provider_registered = True


def _faults():
    """``utils.faults`` iff loaded (in-package runs); None standalone."""
    return sys.modules.get("heat_tpu_torch.utils.faults")


def _health():
    return sys.modules.get("heat_tpu_torch.utils.health")


def _telemetry():
    tel = sys.modules.get("heat_tpu_torch.utils.telemetry")
    if tel is None or not getattr(tel, "_ENABLED", False):
        return None
    return tel


def _fire(site: str, path: Optional[str] = None) -> None:
    flt = _faults()
    if flt is not None:
        flt.fire(site, path=path)


def _flightrec():
    """``utils.flightrec`` iff loaded AND armed; None standalone."""
    fr = sys.modules.get("heat_tpu_torch.utils.flightrec")
    if fr is None or not getattr(fr, "enabled", lambda: False)():
        return None
    return fr


# ---------------------------------------------------------------------- #
# trace identity — minted HERE, at job submission: the one choke point
# that owns a job's trace id (heatlint HT109's contract).  Everything
# downstream — dispatch spans, collective seq-stamps, retry attempts,
# journal records across generations — carries it, so postmortem and the
# SLO tables can reconstruct one job's full causal path.
# ---------------------------------------------------------------------- #
def job_trace_id(job_id: str, kind: str = "", tenant: str = "") -> str:
    """Deterministic 16-hex trace id for a job: derived from the job's
    IDENTITY, not from process entropy — every rank of an SPMD world (and
    every restarted generation replaying the journal) derives the
    IDENTICAL id, which is what makes it a cross-rank, cross-generation
    join key.  The journal carries it verbatim anyway; this derivation
    only matters for the first mint."""
    return hashlib.sha1(f"job|{job_id}|{kind}|{tenant}".encode()).hexdigest()[:16]


def _tracing(trace_id: Optional[str]):
    """``telemetry.tracing(trace_id)`` when the runtime is loaded (spans,
    dispatch records and flight-recorder collective stamps inside the
    block then carry the job's id); a null context standalone.  Via
    ``sys.modules`` — this file must never import the package.  Note the
    telemetry module need not be ENABLED: trace identity is a contextvar,
    and the crash-durable flight ring stamps it independently of the span
    ring."""
    tel = sys.modules.get("heat_tpu_torch.utils.telemetry")
    if tel is None or trace_id is None:
        return contextlib.nullcontext()
    try:
        return tel.tracing(trace_id=trace_id)
    except Exception:
        return contextlib.nullcontext()


# ---------------------------------------------------------------------- #
# job model
# ---------------------------------------------------------------------- #
class JobRejected(Exception):
    """Admission control shed this job.  Structured: ``reason`` is one of
    ``queue_full`` / ``deadline_infeasible`` / ``tenant_cap``; ``job_id``
    and ``tenant`` name the victim.  Raised synchronously from
    :meth:`Scheduler.submit` — a rejected submit returns control
    immediately, it never blocks waiting for capacity."""

    def __init__(self, reason: str, job_id: str, tenant: str, detail: str = ""):
        self.reason = reason
        self.job_id = job_id
        self.tenant = tenant
        self.detail = detail
        msg = f"JobRejected{{reason={reason}, job={job_id}, tenant={tenant}}}"
        if detail:
            msg += f": {detail}"
        super().__init__(msg)


class JournalSchemaError(Exception):
    """The journal was written by a NEWER schema than this reader
    understands — refusing loudly beats misparsing someone else's records
    into silently dropped jobs."""


class WorldBroken(Exception):
    """The distributed WORLD died under a dispatch — not the job's fault.

    Executors raise this (``serving.make_executor`` converts torch.distributed transport
    runtime errors) when the failure is the machinery, not the work: a
    peer died mid-collective and gloo surfaced a connection error instead
    of hanging.  The scheduler treats it categorically differently from a
    job failure: the in-flight batch goes BACK on the queue (its journal
    state stays ``DISPATCHED``, so the post-restart replay requeues it)
    and the error propagates out of :meth:`Scheduler.run` to whoever owns
    the process — under the supervisor, that process exits and the world
    restarts.  Without this distinction a dying world would race the
    supervisor's teardown: ranks whose collectives raised fast would
    terminally fail jobs that ranks whose collectives hung would have
    recovered."""


@dataclass
class Job:
    """One unit of work.  ``kind`` selects the executor's program;
    ``payload`` parameterizes it (JSON-able scalars only — it is journaled
    verbatim so a recovery can reconstruct the job).  ``deadline_s`` is a
    wall-clock budget measured from submit; ``retry_budget`` bounds
    re-dispatches after a transient failure."""

    job_id: str
    kind: str
    tenant: str = "default"
    priority: int = 0
    deadline_s: Optional[float] = None
    retry_budget: int = 2
    payload: dict = field(default_factory=dict)
    batch_key: Optional[str] = None
    # causal join key: minted at submit (deterministically from the job
    # identity — see job_trace_id) unless the client supplied one;
    # journaled with every record, preserved by replay across restarts
    trace_id: Optional[str] = None

    # runtime state (owned by the scheduler)
    state: str = SUBMITTED
    reason: Optional[str] = None
    attempts: int = 0
    result: Any = None
    submit_t: float = 0.0
    dispatch_t: float = 0.0
    finish_t: float = 0.0
    _order: int = 0  # FIFO tiebreak within a priority class

    def effective_batch_key(self) -> str:
        """Jobs with equal keys may share one dispatch.  Default: kind +
        the full payload signature — identical requests batch; executors
        with a looser compatibility notion (same shapes, different data)
        supply an explicit ``batch_key``."""
        if self.batch_key is not None:
            return self.batch_key
        try:
            sig = json.dumps(self.payload, sort_keys=True)
        except (TypeError, ValueError):
            # keys AND values: a keys-only signature would batch jobs whose
            # payloads differ in value, handing an executor incompatible work
            sig = repr(sorted(self.payload.items(), key=lambda kv: kv[0]))
        return f"{self.kind}|{sig}"

    def remaining(self, now: float) -> Optional[float]:
        """Seconds of deadline budget left at ``now`` (None = unbounded)."""
        if self.deadline_s is None:
            return None
        return self.deadline_s - (now - self.submit_t)

    def to_submit_record(self) -> dict:
        return {
            "type": SUBMITTED,
            "id": self.job_id,
            "kind": self.kind,
            "tenant": self.tenant,
            "priority": self.priority,
            "deadline_s": self.deadline_s,
            "retry_budget": self.retry_budget,
            "payload": self.payload,
            "tid": self.trace_id,
        }

    @classmethod
    def from_record(cls, rec: dict) -> "Job":
        return cls(
            job_id=str(rec["id"]),
            kind=str(rec.get("kind", "?")),
            tenant=str(rec.get("tenant", "default")),
            priority=int(rec.get("priority", 0)),
            deadline_s=rec.get("deadline_s"),
            retry_budget=int(rec.get("retry_budget", 0)),
            payload=dict(rec.get("payload") or {}),
            trace_id=rec.get("tid"),
        )


# ---------------------------------------------------------------------- #
# journal
# ---------------------------------------------------------------------- #
class JobJournal:
    """Append-only, crash-durable job journal (one JSON record per line).

    Created via tmp+rename with the schema header INSIDE the initial file,
    so a reader never sees a headerless journal; every append fires the
    ``sched.journal.write`` fault site, writes one full line and flushes.
    No fsync on the append path (the flightrec durability matrix: the page
    cache survives SIGKILL/OOM — the crash class the supervisor produces —
    but not kernel panic / power loss).  A process killed mid-``write``
    leaves at most one torn FINAL line, which :func:`replay_journal`
    tolerates (counted, never fatal).

    Re-opening an existing journal (the restarted generation) appends a
    fresh header line carrying the new ``epoch``, so per-generation
    accounting falls out of the record stream."""

    def __init__(self, path: str, epoch: Optional[int] = None):
        self.path = path
        self.epoch = int(
            os.environ.get("HEAT_TPU_RESTART_EPOCH", "0") or 0
        ) if epoch is None else int(epoch)
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        header = {
            "type": "meta",
            "schema": SCHEMA_VERSION,
            "pid": os.getpid(),
            "epoch": self.epoch,
            "t": time.time(),
        }
        if not os.path.exists(path):
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as fh:
                fh.write(json.dumps(header) + "\n")
                fh.flush()
                os.fsync(fh.fileno())  # the header IS the format contract
            os.replace(tmp, path)
        else:
            self.append(header)

    def append(self, rec: dict) -> None:
        _fire("sched.journal.write", path=self.path)
        rec = dict(rec)
        rec.setdefault("t", time.time())
        rec.setdefault("epoch", self.epoch)
        with open(self.path, "a") as fh:
            fh.write(json.dumps(rec) + "\n")
            fh.flush()
        counter_inc("sched.journal.writes")


def replay_journal(path: str) -> dict:
    """Replay a journal into its last-state-wins view.

    Returns ``{"schema": v, "jobs": {id: job_view}, "epochs": [..],
    "torn": n, "records": [...]}`` where each ``job_view`` carries the
    submit-record fields plus ``state``/``reason``/``attempts``/``seq``
    and per-record timestamps (``submit_t``/``dispatch_t``/``finish_t``)
    for latency accounting.  A journal from a NEWER schema raises
    :class:`JournalSchemaError` — named, loud, and before any record is
    interpreted.  A torn final line (SIGKILL mid-append) is tolerated and
    counted; so is foreign garbage mid-file (the reader's job is to
    salvage, not to validate)."""
    jobs: Dict[str, dict] = {}
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
                if schema > SCHEMA_VERSION:
                    raise JournalSchemaError(
                        f"journal {path!r} was written by schema {schema}; "
                        f"this reader understands <= {SCHEMA_VERSION} — "
                        "refusing to misparse a newer format"
                    )
                schema_checked = True
                epoch = int(rec.get("epoch", 0) or 0)
                if epoch not in epochs:
                    epochs.append(epoch)
                records.append(rec)
                continue
            if not schema_checked:
                # headerless journal: never written by this code (the
                # header rides the tmp+rename creation), so refuse loudly
                # rather than guess at the format
                raise JournalSchemaError(
                    f"journal {path!r} has records before any schema header"
                )
            rid = rec.get("id")
            if rid is None:
                torn += 1
                continue
            rid = str(rid)
            rec.setdefault("epoch", epoch)
            records.append(rec)
            view = jobs.get(rid)
            if kind == SUBMITTED:
                # a submit AFTER a shed is a NEW acceptance (the runtime
                # explicitly permits resubmitting a shed id): the fresh
                # view replaces the shed one, or recovery would silently
                # drop an accepted job while reporting it merely shed
                if view is None or view.get("state") == SHED:
                    view = dict(rec)
                    view["state"] = SUBMITTED
                    view["attempts"] = 0
                    view["submit_t"] = rec.get("t")
                    jobs[rid] = view
                else:  # duplicate submit of a live id: keep the first identity
                    view.setdefault("submit_t", rec.get("t"))
            elif kind == SHED:
                view = jobs.setdefault(rid, dict(rec))
                if view.get("state") != DONE:  # never erase completed work
                    view["state"] = SHED
                    view["reason"] = rec.get("reason")
            elif view is not None:
                if kind == DISPATCHED:
                    # a DONE/FAILED job never regresses to DISPATCHED (a
                    # duplicated requeue-then-crash must not resurrect it)
                    if view.get("state") not in (DONE, FAILED, SHED):
                        view["state"] = DISPATCHED
                    view["attempts"] = int(view.get("attempts", 0)) + 1
                    view["seq"] = rec.get("seq")
                    view["dispatch_t"] = rec.get("t")
                elif kind == DONE:
                    view["state"] = DONE
                    view["finish_t"] = rec.get("t")
                    view["exec_s"] = rec.get("exec_s")
                    if "result" in rec:  # journaled answer (serving digest)
                        view["result"] = rec.get("result")
                elif kind == FAILED:
                    if view.get("state") != DONE:
                        view["state"] = FAILED
                        view["reason"] = rec.get("reason")
                        view["finish_t"] = rec.get("t")
                elif kind == "requeue":
                    view["requeued"] = int(view.get("requeued", 0)) + 1
            # records for unknown ids (dispatch before submit: torn head)
            # are kept in `records` but cannot build a job view
    return {
        "schema": SCHEMA_VERSION,
        "jobs": jobs,
        "epochs": epochs,
        "torn": torn,
        "records": records,
    }


def jobs_summary(replay: dict) -> dict:
    """Aggregate a :func:`replay_journal` view into the supervisor's
    ``jobs`` report section: totals plus per-generation accounting.  A job
    is LOST when it was accepted but has no terminal state — the number
    the chaos lane asserts is zero."""
    jobs = replay["jobs"]
    total = len(jobs)
    by_state = {s: 0 for s in (SUBMITTED, DISPATCHED, DONE, FAILED, SHED)}
    retried = 0
    requeued = 0
    by_gen: Dict[int, Dict[str, int]] = {}
    for v in jobs.values():
        by_state[v.get("state", SUBMITTED)] = by_state.get(v.get("state", SUBMITTED), 0) + 1
        if int(v.get("attempts", 0)) > 1:
            retried += 1
        requeued += int(v.get("requeued", 0))
    for rec in replay["records"]:
        kind = rec.get("type")
        if kind not in (SUBMITTED, DISPATCHED, DONE, FAILED, SHED, "requeue"):
            continue
        g = by_gen.setdefault(int(rec.get("epoch", 0)), {
            "accepted": 0, "dispatched": 0, "completed": 0,
            "failed": 0, "shed": 0, "requeued": 0,
        })
        if kind == SUBMITTED:
            g["accepted"] += 1
        elif kind == DISPATCHED:
            g["dispatched"] += 1
        elif kind == DONE:
            g["completed"] += 1
        elif kind == FAILED:
            g["failed"] += 1
        elif kind == SHED:
            g["shed"] += 1
        elif kind == "requeue":
            g["requeued"] += 1
    accepted = total - by_state[SHED]
    lost = by_state[SUBMITTED] + by_state[DISPATCHED]
    return {
        "jobs": total,
        "accepted": accepted,
        "done": by_state[DONE],
        "failed": by_state[FAILED],
        "shed": by_state[SHED],
        "retried": retried,
        "requeued": requeued,
        "lost": lost,
        "torn": replay.get("torn", 0),
        "generations": {str(k): v for k, v in sorted(by_gen.items())},
    }


def execution_witness(replay: dict) -> dict:
    """Per-job execution accountability over a :func:`replay_journal`
    view: the generations that journaled a DISPATCHED record for each job
    and the first generation that journaled it DONE.

    This is the exactly-once contract rendered as data — an execution a
    worker witnessed is legitimate iff its generation appears in
    ``dispatch_epochs``, and NO legitimate execution can postdate
    ``first_done_epoch`` (recovery registers DONE jobs in ``_done_ids``
    precisely so they never dispatch again).  The chaos exactly-once
    oracle audits worker-side execution logs against this view."""
    out: Dict[str, dict] = {}
    for rec in replay.get("records", ()):
        jid = rec.get("id")
        if jid is None:
            continue
        w = out.setdefault(
            str(jid), {"dispatch_epochs": [], "first_done_epoch": None}
        )
        epoch = int(rec.get("epoch", 0) or 0)
        t = rec.get("type")
        if t == DISPATCHED:
            w["dispatch_epochs"].append(epoch)
        elif t == DONE and w["first_done_epoch"] is None:
            w["first_done_epoch"] = epoch
    return out


def attestation_line(summary: dict) -> str:
    """The launcher's one-line job accounting (tests assert on it)."""
    return (
        f"SCHED jobs={summary['jobs']} done={summary['done']} "
        f"requeued={summary['requeued']} shed={summary['shed']} "
        f"failed={summary['failed']} lost={summary['lost']}"
    )


def trace_continuity(replay: dict) -> dict:
    """Trace-id continuity audit over a :func:`replay_journal` view: every
    journaled record of one job — submit, dispatch attempts, requeues
    across however many generations, the terminal record — must carry the
    SAME trace id (replay preserves it; a requeue that re-minted would
    sever the causal chain exactly where it matters most, across the
    crash).  Returns ``{"jobs": n_with_tids, "ok": bool, "violations":
    [job ids whose records disagree]}`` — the launcher prints this as the
    ``SCHED-TRACE-CONTINUITY`` attestation and the chaos lane asserts it
    across a SIGKILL restart.  A record that DROPS the tid on a job whose
    other records carry one is a violation too — the likeliest severed
    chain is a write path that forgot the field, not one that re-minted
    (a wholly tid-less journal — pre-trace schema — is simply untraced:
    ``jobs`` = 0, ok)."""
    tids: Dict[str, set] = {}
    missing: Dict[str, int] = {}
    for rec in replay.get("records", []):
        rid = rec.get("id")
        if rid is None:
            continue
        rid = str(rid)
        tid = rec.get("tid")
        if tid:
            tids.setdefault(rid, set()).add(str(tid))
        else:
            missing[rid] = missing.get(rid, 0) + 1
    violations = sorted(
        rid for rid, ts in tids.items()
        if len(ts) > 1 or missing.get(rid, 0)
    )
    return {"jobs": len(tids), "ok": not violations, "violations": violations}


# ---------------------------------------------------------------------- #
# scheduler
# ---------------------------------------------------------------------- #
class _DeadlineExpired(Exception):
    """Internal: a job's wall budget ran out before/while dispatching.
    NOT retryable (there is no budget left to retry inside)."""


class Scheduler:
    """Multi-tenant elastic job scheduler (see module docstring).

    ``executor(jobs)`` receives a batch of jobs sharing one
    ``batch_key`` and returns one result per job (it may raise — transient
    errors are retried, anything else fails the batch's jobs with the
    exception's name as the reason).  ``batch_key(job)`` optionally
    overrides compatibility grouping (``serving.batch_key`` keys on
    shapes, not data, so same-shape requests from different tenants share
    one SPMD dispatch).

    The dispatch loop is deliberately synchronous and deterministic: in a
    multi-process SPMD world every rank runs the identical scheduler over
    the identical submissions, so every rank stages the identical
    collectives in the identical order — scheduling divergence would be a
    desync, and determinism is what makes journal replay (and the chaos
    lane) exact.

    **Deadline margin caveat (multi-process).**  The LIVE expiry checks at
    dispatch time read each rank's local monotonic clock; a
    ``deadline_s`` within clock-skew distance of the actual queue wait
    can therefore expire on one rank and dispatch (staging collectives)
    on another — a desync the flight-recorder post-mortem names but the
    scheduler cannot prevent without a per-dispatch consensus collective.
    Size multi-process deadlines with real margin over the expected
    service time (the serve worker uses 300 s for sub-second jobs);
    recovery's journal-anchored budget charging keeps the REPLAYED side
    of this deterministic (see :meth:`recover`)."""

    def __init__(
        self,
        executor: Optional[Callable[[List[Job]], List[Any]]] = None,
        *,
        max_queue: int = 64,
        tenant_cap: Optional[int] = None,
        max_batch: int = 8,
        journal: Optional[object] = None,  # path or JobJournal or None
        batch_key: Optional[Callable[[Job], str]] = None,
        min_exec_estimate: Optional[Dict[str, float]] = None,
        retry_base_delay: float = 0.02,
        retry_max_delay: float = 0.5,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.executor = executor
        self.max_queue = int(max_queue)
        self.tenant_cap = None if tenant_cap is None else int(tenant_cap)
        self.max_batch = max(1, int(max_batch))
        self.batch_key = batch_key
        self.min_exec_estimate = dict(min_exec_estimate or {})
        self.retry_base_delay = float(retry_base_delay)
        self.retry_max_delay = float(retry_max_delay)
        self.clock = clock
        if isinstance(journal, str):
            journal = JobJournal(journal)
        self.journal: Optional[JobJournal] = journal
        self._queue: List[Job] = []  # kept sorted at pop time
        self._jobs: Dict[str, Job] = {}  # every job ever seen (incl. shed)
        self._tenant_inflight: Dict[str, int] = {}
        self._order = 0
        self._dispatch_seq = 0
        self._done_ids: set = set()  # executed-to-DONE in THIS process or replay
        self._register_monitor_gauges()

    def _register_monitor_gauges(self) -> None:
        """Expose live queue state to ``utils.monitor`` (iff loaded — via
        ``sys.modules``, this file must stay standalone-loadable): queue
        depth and per-tenant in-flight counts as scrape-time gauges.  The
        reference is weak, so a discarded scheduler is pruned at the next
        scrape instead of being pinned alive by the monitor."""
        mon = sys.modules.get("heat_tpu_torch.utils.monitor")
        if mon is None:
            return
        ref = weakref.ref(self)

        def gauges():
            s = ref()
            if s is None:
                return None  # owner collected: monitor prunes this source
            out = {"sched.queue_depth": len(s._queue)}
            for tenant, n in sorted(s._tenant_inflight.items()):
                out[f"sched.inflight.{tenant}"] = int(n)
            return out

        try:
            mon.register_gauge_source("sched_live", gauges)
        except Exception:
            pass

    # ------------------------------------------------------------------ #
    # admission
    # ------------------------------------------------------------------ #
    def _shed(self, job: Job, reason: str, detail: str = "") -> JobRejected:
        # journal FIRST: if the append fails, the fault propagates with
        # NOTHING mutated — a record the journal never saw must not exist
        # in this scheduler's state either (same ordering as submit)
        if self.journal is not None:
            self.journal.append({
                "type": SHED, "id": job.job_id, "kind": job.kind,
                "tenant": job.tenant, "reason": reason, "tid": job.trace_id,
            })
        job.state = SHED
        job.reason = reason
        self._jobs[job.job_id] = job
        # offered counts at the SAME point as its outcome (after the journal
        # append): a sched.journal.write failure leaves offered, accepted
        # and shed all untouched, so the /metrics reconciliation
        # offered = accepted + shed survives journal faults
        counter_inc("sched.offered")
        counter_inc("sched.shed")
        counter_inc(f"sched.shed.{reason}")
        return JobRejected(reason, job.job_id, job.tenant, detail)

    def submit(self, job: Job) -> str:
        """Admit ``job`` or raise :class:`JobRejected` — synchronously,
        never blocking on a full queue (load-shedding IS the backpressure
        signal).  Admission checks, in order: queue bound, per-tenant
        in-flight cap, deadline feasibility (a deadline below the kind's
        configured minimum service estimate can only expire in the queue —
        reject it now, while the client can still retry elsewhere)."""
        if job.job_id in self._jobs and self._jobs[job.job_id].state not in (SHED,):
            raise ValueError(f"duplicate job id {job.job_id!r}")
        # trace identity is minted HERE (or adopted from the client), before
        # any admission outcome: a shed job's rejection record carries the
        # same id the client can correlate on
        if job.trace_id is None:
            job.trace_id = job_trace_id(job.job_id, job.kind, job.tenant)
        now = self.clock()
        if len(self._queue) >= self.max_queue:
            raise self._shed(
                job, QUEUE_FULL, f"queue at its {self.max_queue}-job bound"
            )
        if (
            self.tenant_cap is not None
            and self._tenant_inflight.get(job.tenant, 0) >= self.tenant_cap
        ):
            raise self._shed(
                job, TENANT_CAP,
                f"tenant {job.tenant!r} at its {self.tenant_cap}-job in-flight cap",
            )
        if job.deadline_s is not None:
            floor = self.min_exec_estimate.get(job.kind, 0.0)
            if job.deadline_s <= floor:
                raise self._shed(
                    job, DEADLINE_INFEASIBLE,
                    f"deadline {job.deadline_s}s <= {floor}s minimum for {job.kind!r}",
                )
        job.state = SUBMITTED
        job.submit_t = now
        self._order += 1
        job._order = self._order
        # journal BEFORE mutating queue/counters: when the append fails the
        # raise means what it says — the job was NOT accepted.  The reverse
        # order would leave a queued, runnable job the journal (and hence
        # every crash recovery) knows nothing about: a silently-accepted,
        # unaccounted execution, the exact contract violation the loud
        # failure exists to prevent.
        if self.journal is not None:
            self.journal.append(job.to_submit_record())
        self._jobs[job.job_id] = job
        self._queue.append(job)
        self._tenant_inflight[job.tenant] = self._tenant_inflight.get(job.tenant, 0) + 1
        counter_inc("sched.offered")  # paired with accepted — see _shed
        counter_inc("sched.accepted")
        return job.job_id

    # ------------------------------------------------------------------ #
    # recovery
    # ------------------------------------------------------------------ #
    def recover(self, path: Optional[str] = None,
                epoch: Optional[int] = None) -> int:
        """Replay a journal after a world restart and requeue every
        accepted-but-unfinished job EXACTLY once (idempotent by job id:
        last state wins, a DONE job is never re-queued, a job with three
        dispatch records requeues once).  Requeued jobs keep their
        identity and priority, and their deadline budget is CHARGED for
        the journal-visible elapsed time: remaining = original deadline −
        (latest PRE-restart journal timestamp − the job's submit
        timestamp).  Both ends come from the journal itself and only
        records of generations BEFORE ``epoch`` (default: the
        ``HEAT_TPU_RESTART_EPOCH`` this process was relaunched with) feed
        the anchor — the restarted generation's own header/requeue/
        dispatch appends, which race a peer rank's replay of the shared
        file, never move it.  Every rank of an SPMD world therefore
        derives the IDENTICAL remaining budget (a per-rank wall-clock
        read, or an anchor that saw rank 0's fresh appends, would let
        ranks disagree about whether a borderline job is alive — a
        scheduling desync), and the downtime between the crash and the
        relaunch is deliberately not charged.  A job whose budget is
        already gone is still requeued — it fails ``deadline_expired`` at
        dispatch, a NAMED outcome, rather than vanishing.  Returns the
        number requeued and journals a ``requeue`` record for each (so the
        attestation and the supervisor's jobs section count recoveries)."""
        path = path or (self.journal.path if self.journal is not None else None)
        if path is None or not os.path.exists(path):
            return 0
        replay = replay_journal(path)
        requeue: List[dict] = [
            v for v in replay["jobs"].values()
            if v.get("state") in (SUBMITTED, DISPATCHED)
        ]
        # deterministic order: priority desc, then original journal order
        # (records list is journal-ordered; build an index)
        first_seen = {}
        for i, rec in enumerate(replay["records"]):
            rid = rec.get("id")
            if rid is not None and rid not in first_seen:
                first_seen[rid] = i
        requeue.sort(key=lambda v: (-int(v.get("priority", 0)), first_seen.get(v["id"], 0)))
        # the deadline charge anchor: the latest wall timestamp among
        # records of PRE-restart generations — identical on every rank
        # however the replay interleaves with rank 0's fresh epoch-N
        # appends (see docstring); with no restart context (epoch 0),
        # nothing qualifies and no time is charged
        if epoch is None:
            try:
                epoch = int(os.environ.get("HEAT_TPU_RESTART_EPOCH", "0") or 0)
            except ValueError:
                epoch = 0
        anchor = max(
            (rec.get("t") for rec in replay["records"]
             if isinstance(rec.get("t"), (int, float))
             and int(rec.get("epoch", 0) or 0) < epoch),
            default=None,
        )
        # per-job dispatch counts, same pre-restart scoping as the anchor
        pre_attempts: Dict[str, int] = {}
        for rec in replay["records"]:
            if (
                rec.get("type") == DISPATCHED
                and int(rec.get("epoch", 0) or 0) < epoch
                and rec.get("id") is not None
            ):
                rid = str(rec["id"])
                pre_attempts[rid] = pre_attempts.get(rid, 0) + 1
        n = 0
        now = self.clock()
        for view in requeue:
            job = Job.from_record(view)
            if job.job_id in self._jobs:
                continue  # already live in this scheduler: never duplicate
            job.state = SUBMITTED
            # dispatch attempts accumulate ACROSS generations (this is
            # what lets the WorldBroken handler retire a poison job
            # instead of crash-looping the world) — but, like the anchor,
            # counted from PRE-restart records only: a peer rank replaying
            # the shared file mid-race against rank 0's fresh epoch-N
            # dispatch appends must derive the identical count
            job.attempts = pre_attempts.get(job.job_id, 0)
            if job.deadline_s is not None and anchor is not None:
                st = view.get("submit_t")
                if isinstance(st, (int, float)):
                    job.deadline_s -= max(0.0, anchor - st)
            job.submit_t = now  # monotonic re-anchor (clocks don't span processes)
            self._order += 1
            job._order = self._order
            if self.journal is not None:
                # journal first — same no-phantom-state ordering as submit;
                # the tid restored from the submit record rides along, so
                # the requeue is journal-visibly the SAME causal chain
                self.journal.append({"type": "requeue", "id": job.job_id,
                                     "tid": job.trace_id})
            self._jobs[job.job_id] = job
            self._queue.append(job)
            self._tenant_inflight[job.tenant] = (
                self._tenant_inflight.get(job.tenant, 0) + 1
            )
            counter_inc("sched.requeued")
            n += 1
        for rid, view in replay["jobs"].items():
            if view.get("state") == DONE:
                self._done_ids.add(rid)  # exactly-once: replayed DONE never re-runs
                if rid not in self._jobs:
                    # register the completed job too: submit()'s duplicate
                    # check then rejects a client reusing a DONE id after a
                    # restart (in-process behavior), instead of the id
                    # slipping through and being phantom-attested DONE with
                    # a None result by the _done_ids close-out
                    done_job = Job.from_record(view)
                    done_job.state = DONE
                    done_job.attempts = int(view.get("attempts", 0) or 0)
                    self._jobs[rid] = done_job
        return n

    # ------------------------------------------------------------------ #
    # dispatch
    # ------------------------------------------------------------------ #
    def _pop_batch(self) -> List[Job]:
        """Highest-priority job plus up to ``max_batch - 1`` queued jobs
        sharing its batch key (micro-batching: one shared dispatch, one
        cached program)."""
        if not self._queue:
            return []
        self._queue.sort(key=lambda j: (-j.priority, j._order))
        head = self._queue.pop(0)
        key = (self.batch_key or Job.effective_batch_key)(head)
        batch = [head]
        rest: List[Job] = []
        for job in self._queue:
            if (
                len(batch) < self.max_batch
                and (self.batch_key or Job.effective_batch_key)(job) == key
            ):
                batch.append(job)
            else:
                rest.append(job)
        self._queue = rest
        return batch

    def _finish(self, job: Job, state: str, reason: Optional[str] = None,
                result: Any = None) -> None:
        finish_t = self.clock()
        # journal FIRST — the same no-phantom ordering as submit()/_shed():
        # a failed append must propagate with the job's state, the tenant
        # accounting and the outcome counters ALL untouched.  The reverse
        # order (the pre-fix drain() bug) left a job FAILED in memory that
        # the journal — and hence every crash recovery and the attestation
        # line — never saw: a phantom terminal state.
        if self.journal is not None:
            if state == DONE:
                rec = {
                    "type": DONE, "id": job.job_id,
                    "exec_s": round(finish_t - job.dispatch_t, 6)
                    if job.dispatch_t else None,
                    "tid": job.trace_id,
                }
                # the result rides the DONE record when it is JSON-able
                # (the serving digests are) — a crash-surviving answer the
                # federation ingress can serve from the replay alone
                try:
                    json.dumps(result)
                except (TypeError, ValueError):
                    pass
                else:
                    if result is not None:
                        rec["result"] = result
                self.journal.append(rec)
            else:
                self.journal.append({"type": FAILED, "id": job.job_id,
                                     "reason": reason, "tid": job.trace_id})
        job.state = state
        job.reason = reason
        job.result = result
        job.finish_t = finish_t
        t = self._tenant_inflight.get(job.tenant, 0)
        self._tenant_inflight[job.tenant] = max(0, t - 1)
        if state == DONE:
            counter_inc("sched.done")
            self._done_ids.add(job.job_id)
        else:
            counter_inc("sched.failed")
            counter_inc(f"sched.failed.{reason}" if reason else "sched.failed.error")
        fr = _flightrec()
        if fr is not None:
            # the crash-durable side of the causal path: the terminal state
            # lands in THIS rank's ring next to the collective stamps that
            # share the job's tid
            fr.record_event("job", id=job.job_id, state=state,
                            tid=job.trace_id)
        tel = _telemetry()
        if tel is not None:
            exec_s = (job.finish_t - job.dispatch_t) if job.dispatch_t else 0.0
            wait_s = (job.dispatch_t - job.submit_t) if job.dispatch_t else (
                job.finish_t - job.submit_t
            )
            tel.record_event(
                "sched.job", max(exec_s, 0.0),
                attrs={
                    "id": job.job_id,
                    "tenant": job.tenant,
                    "kind": job.kind,
                    "outcome": state if state == DONE else (reason or state),
                    "queue_wait_s": round(max(wait_s, 0.0), 9),
                    "attempts": job.attempts,
                    "trace_id": job.trace_id,
                },
            )

    def _attempt(self, batch: List[Job]) -> List[Any]:
        """One dispatch attempt of ``batch`` under the jobs' remaining
        wall budget: the whole attempt (fault site + executor) runs inside
        an armed collective deadline and the blocking-call watchdog, so a
        wedged collective raises ``CollectiveTimeoutError`` here — at the
        offending job — instead of wedging the queue."""
        now = self.clock()
        budgets = [r for r in (j.remaining(now) for j in batch) if r is not None]
        remaining = min(budgets) if budgets else None
        if remaining is not None and remaining <= 0:
            raise _DeadlineExpired()

        def call():
            _fire("sched.dispatch")
            if self.executor is None:
                raise RuntimeError("scheduler has no executor configured")
            return self.executor(list(batch))

        h = _health()
        if h is None or remaining is None:
            return call()
        kind = batch[0].kind
        with h.deadline(remaining):
            return h.guard_blocking(call, f"sched.dispatch.{kind}")

    def _dispatch(self, batch: List[Job]) -> None:
        kind = batch[0].kind
        now = self.clock()
        # individually expired jobs fail alone — they must not drag live
        # batch-mates down, nor be dispatched with a blown budget
        live: List[Job] = []
        for job in batch:
            r = job.remaining(now)
            if r is not None and r <= 0:
                self._finish(job, FAILED, DEADLINE_EXPIRED)
            else:
                live.append(job)
        if not live:
            return
        self._dispatch_seq += 1
        seq = self._dispatch_seq
        fr = _flightrec()
        for job in live:
            job.attempts += 1
            job.dispatch_t = self.clock()
            job.state = DISPATCHED
            if self.journal is not None:
                self.journal.append({
                    "type": DISPATCHED, "id": job.job_id,
                    "seq": seq, "attempt": job.attempts, "tid": job.trace_id,
                })
            if fr is not None:
                # dispatch marker in the crash-durable ring: a SIGKILL
                # mid-dispatch leaves the job's tid as evidence even when
                # the cached program staged no fresh collectives
                fr.record_event("job", id=job.job_id, state=DISPATCHED,
                                tid=job.trace_id, attempt=job.attempts)
        if len(live) > 1:
            counter_inc("sched.batched", len(live) - 1)
        counter_inc("sched.dispatches")

        # conservative shared retry count: the batch retries together, so
        # the smallest member budget governs (a retry executes everyone)
        retries = min(j.retry_budget for j in live)
        attempt_no = {"n": 0}

        def one_attempt():
            # an expired job fails ALONE, even mid-retry: shed it from the
            # batch here so the survivors' re-attempt runs without it and
            # its blown budget never drags live batch-mates down
            now2 = self.clock()
            for job in [j for j in live
                        if (r := j.remaining(now2)) is not None and r <= 0]:
                live.remove(job)
                self._finish(job, FAILED, DEADLINE_EXPIRED)
            if not live:
                raise _DeadlineExpired()
            attempt_no["n"] += 1
            if attempt_no["n"] > 1:
                counter_inc(f"sched.{kind}.retries")
                for job in live:
                    job.attempts += 1
                    if self.journal is not None:
                        self.journal.append({
                            "type": DISPATCHED, "id": job.job_id,
                            "seq": seq, "attempt": job.attempts,
                            "tid": job.trace_id,
                        })
            return self._attempt(live)

        # the retry WINDOW is the longest member budget (each attempt sheds
        # whoever expired, so retries keep serving the members still alive)
        now = self.clock()
        budgets = [j.remaining(now) for j in live]
        total_budget = (
            None if any(b is None for b in budgets)
            else (max(budgets) if budgets else None)
        )
        try:
            # the whole dispatch — executor, retries, blocking waits — runs
            # under the batch head's trace context: every span, dispatch
            # record and flight-recorder collective stamp inside carries
            # its trace id (contextvars flow into call_with_retries and the
            # guard_blocking worker thread); batch-mates' own ids ride
            # their journal records and sched.job events
            with _tracing(live[0].trace_id):
                results = self._call_with_retries(
                    one_attempt, site=f"sched.{kind}", retries=retries,
                    deadline=total_budget,
                )
        except _DeadlineExpired:
            for job in live:
                self._finish(job, FAILED, DEADLINE_EXPIRED)
            return
        except WorldBroken:
            # transport death is not a job outcome: requeue in-memory (the
            # journal still says DISPATCHED, so a restarted world replays
            # and requeues these too) and let the process owner decide —
            # under the supervisor that means die, restart, resume serving.
            # EXCEPT a job that has already been dispatched more times than
            # its retry budget allows: a POISON job (one whose payload
            # deterministically kills the runtime — a device OOM classified
            # as a world error) would otherwise crash every restarted
            # generation forever, burning the restart budget and losing
            # every job behind it.  Such a job fails NAMED (`world_broken`)
            # — the journaled failure survives the imminent crash, so the
            # next generation retires it and serves the rest.
            for job in live:
                if job.attempts > job.retry_budget + 1:
                    self._finish(job, FAILED, WORLD_BROKEN)
                else:
                    job.state = SUBMITTED
                    self._queue.append(job)
            counter_inc("sched.world_broken")
            raise
        except Exception as e:
            if isinstance(e, OSError) and attempt_no["n"] > retries:
                counter_inc(f"sched.{kind}.exhausted")
                reason = RETRIES_EXHAUSTED
            elif isinstance(e, TimeoutError):
                # deadline trip with no budget left to retry inside
                reason = DEADLINE_EXPIRED
            elif isinstance(e, OSError):
                # retryable failure whose WALL budget (not attempt budget)
                # ran out: the job died of its deadline, say so
                reason = DEADLINE_EXPIRED
            else:
                reason = f"error:{type(e).__name__}"
            for job in live:
                self._finish(job, FAILED, reason)
            return
        if not isinstance(results, (list, tuple)):
            if len(live) == 1:
                results = [results]  # scalar convenience for a 1-job batch
            else:
                for job in live:
                    self._finish(job, FAILED, "error:ResultShapeMismatch")
                return
        elif len(results) != len(live):
            # a wrong-length result list is an executor BUG: fail the batch
            # loudly rather than attest every job DONE with someone else's
            # (or everyone's) result
            for job in live:
                self._finish(job, FAILED, "error:ResultLengthMismatch")
            return
        for job, res in zip(live, results):
            self._finish(job, DONE, result=res)

    def _call_with_retries(self, fn, *, site: str, retries: int,
                           deadline: Optional[float]):
        """``faults.call_with_retries`` when the runtime is loaded (its
        ``retry.<site>`` counters and jittered backoff are the tested
        path); a minimal bounded loop standalone.  Retryable: transient
        faults and OSErrors — which includes ``CollectiveTimeoutError``
        (TimeoutError ⊂ OSError): a wedged collective is retried while
        the job's wall budget lasts, then fails as deadline_expired."""
        flt = _faults()
        if flt is not None:
            return flt.call_with_retries(
                fn, site, retries=retries,
                base_delay=self.retry_base_delay,
                max_delay=self.retry_max_delay,
                retry_on=(OSError,),
                deadline=deadline,
                clock=self.clock,
            )
        attempt = 0
        t0 = self.clock()
        while True:
            try:
                return fn()
            except OSError:
                if attempt >= retries:
                    raise
                if deadline is not None and self.clock() - t0 >= deadline:
                    raise
                attempt += 1
                time.sleep(min(self.retry_max_delay,
                               self.retry_base_delay * (2 ** (attempt - 1))))

    # ------------------------------------------------------------------ #
    # serving loop
    # ------------------------------------------------------------------ #
    def step(self) -> bool:
        """Dispatch one batch; False when the queue is empty."""
        batch = self._pop_batch()
        if not batch:
            return False
        # exactly-once: a job replayed as DONE must never execute again —
        # it can only be queued here through a duplicated recovery, so
        # close it out as DONE without a dispatch
        fresh = []
        for job in batch:
            if job.job_id in self._done_ids and job.state != DONE:
                self._finish(job, DONE, result=None)
            else:
                fresh.append(job)
        if fresh:
            self._dispatch(fresh)
        return True

    def run(self, beat: Optional[Callable[[], None]] = None) -> dict:
        """Drain the queue (one batch per step, ``beat()`` between steps —
        the serve worker's heartbeat hook) and return :meth:`report`."""
        while self.step():
            if beat is not None:
                beat()
        return self.report()

    def drain(self, reason: str = WORLD_UNAVAILABLE) -> int:
        """Graceful degradation: fail every queued job with ``reason``, in
        priority order (the report then names the outcome of EVERY job the
        scheduler ever accepted — highest-priority victims listed first in
        the journal, so a post-hoc reader sees what was sacrificed in the
        order it mattered).

        A journal-append failure mid-drain propagates LOUDLY with the
        failing job (and everything behind it) still queued and still
        SUBMITTED — ``_finish`` journals before mutating, and each job
        leaves the queue only after its terminal record landed, so a
        faulted drain can simply be retried: the already-failed prefix is
        gone from the queue, and no job ever holds a terminal state the
        journal never saw."""
        self._queue.sort(key=lambda j: (-j.priority, j._order))
        n = 0
        while self._queue:
            self._finish(self._queue[0], FAILED, reason)
            self._queue.pop(0)
            n += 1
        return n

    # ------------------------------------------------------------------ #
    # introspection
    # ------------------------------------------------------------------ #
    def pending(self) -> int:
        return len(self._queue)

    def result(self, job_id: str) -> Any:
        return self._jobs[job_id].result

    def outcome(self, job_id: str) -> dict:
        j = self._jobs[job_id]
        return {
            "id": j.job_id, "kind": j.kind, "tenant": j.tenant,
            "state": j.state, "reason": j.reason, "attempts": j.attempts,
            "priority": j.priority,
            "queue_wait_s": round(max(j.dispatch_t - j.submit_t, 0.0), 6)
            if j.dispatch_t else None,
            "exec_s": round(max(j.finish_t - j.dispatch_t, 0.0), 6)
            if j.dispatch_t and j.finish_t else None,
        }

    def counters_reconcile(self) -> bool:
        """The accounting invariant the acceptance test asserts: every
        offered job is accepted or shed, and every accepted job is done,
        failed, or still pending — nothing lost, nothing double-counted."""
        c = counters()
        accepted = c.get("sched.accepted", 0) + c.get("sched.requeued", 0)
        terminal = c.get("sched.done", 0) + c.get("sched.failed", 0)
        # requeued jobs re-enter `accepted`, so a job spanning generations
        # counts once per admission — compare against THIS scheduler's view
        mine = [j for j in self._jobs.values() if j.state != SHED]
        done = sum(1 for j in mine if j.state == DONE)
        failed = sum(1 for j in mine if j.state == FAILED)
        pending = len(self._queue)
        return (
            len(mine) == done + failed + pending
            and terminal <= accepted
        )

    def report(self) -> dict:
        """Every job's outcome + the scheduler counters.  ``jobs`` names
        every job ever offered (including shed ones) — the "final report
        names every job's outcome" contract."""
        by_state: Dict[str, int] = {}
        jobs = {}
        for jid, j in sorted(self._jobs.items()):
            jobs[jid] = self.outcome(jid)
            by_state[j.state] = by_state.get(j.state, 0) + 1
        return {
            "jobs": jobs,
            "by_state": by_state,
            "pending": len(self._queue),
            "counters": {k: v for k, v in sorted(counters().items())
                         if k.startswith("sched.")},
            "reconciled": self.counters_reconcile(),
        }
