"""Deterministic fault injection + bounded retry (the failure-hardening core).

The reference's ``utils/faults.py``: the same sites, modes, grammar
(``HEAT_TPU_FAULTS``) and retry schedule.

A production run survives torn writes, flaky storage and slow coordinators
only if every recovery path is *testable on CPU*; this module provides the
two halves of that story:

- **fault sites**: named points threaded through the runtime where a test
  (or a chaos job) can deterministically inject a failure.  The catalog
  lives in ``doc/source/design.md`` ("Failure model & recovery"):

  ========================  ====================================================
  site                      fired from
  ========================  ====================================================
  ``io.write``              every durable checkpoint file write (chunk files,
                            ``meta.json``, ``LATEST`` tmp, pytree ``.npz``)
  ``io.read``               checkpoint verification/assembly reads
  ``io.fsync``              every fsync of a checkpoint file or directory
  ``comm.host_fetch``       ``Communication.host_fetch`` (device→host fetches)
  ``comm.collective``       every ``Communication`` collective staging point
                            (``_account``) and the blocking waits
                            (``Wait``/``Barrier``) — ``delay``/``hang`` here
                            model a slow or dead peer, the case the
                            ``comm.deadline`` watchdog exists for
  ``proc.exit``             once per training step (``DASO.step``) and per
                            dryrun-worker section — ``exit=N`` SIGKILLs the
                            process on the Nth firing, the deterministic
                            "rank dies mid-training" the supervisor lane
                            recovers from
  ``dist.init``             each ``torch.distributed.init_process_group``
                            attempt in ``bootstrap.init_distributed``
  ``sched.dispatch``        every scheduler dispatch attempt
                            (``parallel.scheduler.Scheduler``), fired inside
                            the armed per-job deadline — ``fail``/``delay``
                            exercise the retry path, ``hang`` proves a wedged
                            dispatch trips as THAT job's failure (not a
                            wedged queue), ``exit`` SIGKILLs a serving rank
                            mid-queue (the chaos lane's journal-replay
                            scenario)
  ``sched.journal.write``   every append to the scheduler's crash-durable
                            job journal — makes torn-record and
                            journal-loss recovery deterministically testable
  ========================  ====================================================

- **retry with backoff**: :func:`call_with_retries` — capped, jittered
  exponential backoff around transient faults, with attempt counters pushed
  into ``utils.profiler`` (``retry.<site>``) so recoveries are observable.

Faults are armed either in-process::

    with faults.inject("io.write", fail=2):
        ht.save_array_checkpoint(x, d)   # first two chunk writes fail, then heal

or across a process boundary via the environment (the chaos lane's SIGKILL
tests configure the victim subprocess this way)::

    HEAT_TPU_FAULTS="io.write:delay=0.3;io.fsync:fail=1"

Modes per site (combinable):

- ``fail=N``     raise :class:`TransientFault` on the first N firings
  (``N=-1``: every firing); ``exc=`` overrides the exception type.
- ``delay=S``    sleep S seconds on every firing — widens crash windows so a
  SIGKILL deterministically lands inside a write loop.
- ``corrupt=N``  flip one byte of the file passed as ``fire(..., path=)`` on
  the first N firings — models bit rot / torn sectors *after* the writer
  computed its checksum.
- ``hang=N``     block forever on the first N firings (``-1``: every) —
  models a dead peer's collective; only a deadline watchdog or a kill
  reclaims the caller.
- ``exit=N``     SIGKILL the *own* process on the Nth firing — models rank
  death at a deterministic point (the supervisor chaos lane arms this on
  one rank's ``proc.exit``).

Everything here is stdlib-only on purpose: the registry is imported from the
innermost I/O and bootstrap paths, where a heavy import would be a cycle.
"""

from __future__ import annotations

import contextlib
import contextvars
import hashlib
import os
import time
from typing import Callable, Dict, Iterator, Optional, Tuple

__all__ = [
    "InjectedFault",
    "TransientFault",
    "FaultSpec",
    "inject",
    "fire",
    "trip_count",
    "reset_trips",
    "trips",
    "parse_spec",
    "render_spec",
    "catalog",
    "catalog_sites",
    "MODES",
    "jitter_unit",
    "backoff_schedule",
    "call_with_retries",
]

# every mode ``parse_spec`` accepts, in the order ``fire`` applies them
MODES = ("delay", "hang", "corrupt", "exit", "fail")

# ---------------------------------------------------------------------- #
# the machine-readable fault catalog
# ---------------------------------------------------------------------- #
# One entry per registered site: where it fires from (the layer owning the
# ``fire(...)`` call) and which modes are *meaningful* there — every mode
# mechanically works at every site, but e.g. ``corrupt`` needs a firing
# that passes ``path=`` and ``hang`` is only survivable under a watchdog.
# This tuple is the single source of truth the chaos schedule generator
# enumerates, the coverage test greps the repo against, and heatlint HT113
# checks fire/inject literals against — a typo'd site can no longer
# silently never fire.
_CATALOG = (
    {
        "site": "io.write",
        "modes": ("fail", "delay", "corrupt", "exit"),
        "layer": "core/io.py",
        "fires": "every durable checkpoint file write (chunk files, "
                 "meta.json, LATEST tmp, pytree .npz); fired with path=",
    },
    {
        "site": "io.read",
        "modes": ("fail", "delay", "corrupt"),
        "layer": "core/io.py",
        "fires": "checkpoint verification/assembly reads; fired with path=",
    },
    {
        "site": "io.fsync",
        "modes": ("fail", "delay", "corrupt"),
        "layer": "core/io.py",
        "fires": "every fsync of a checkpoint file or directory; "
                 "fired with path=",
    },
    {
        "site": "comm.host_fetch",
        "modes": ("fail", "delay"),
        "layer": "core/communication.py",
        "fires": "Communication.host_fetch (device→host fetches)",
    },
    {
        "site": "comm.collective",
        "modes": ("fail", "delay", "hang", "exit"),
        "layer": "core/communication.py",
        "fires": "every collective staging point (_account) and the "
                 "blocking waits (Wait/Barrier) — hang models a dead peer, "
                 "the case the comm.deadline watchdog exists for",
    },
    {
        "site": "proc.exit",
        "modes": ("exit", "delay"),
        "layer": "optim/dp_optimizer.py",
        "fires": "once per training step (DASO.step) and per dryrun-worker "
                 "section — exit=N is the deterministic rank death the "
                 "supervisor lane recovers from",
    },
    {
        "site": "dist.init",
        "modes": ("fail", "delay"),
        "layer": "core/bootstrap.py",
        "fires": "each torch.distributed.init_process_group attempt in "
                 "bootstrap.init_distributed",
    },
    {
        "site": "sched.dispatch",
        "modes": ("fail", "delay", "hang", "exit"),
        "layer": "parallel/scheduler.py",
        "fires": "every scheduler dispatch attempt, inside the armed "
                 "per-job deadline — fail/delay exercise retries, hang "
                 "proves a wedged dispatch fails the job not the queue, "
                 "exit SIGKILLs a serving rank mid-queue",
    },
    {
        "site": "sched.journal.write",
        "modes": ("fail", "delay"),
        "layer": "parallel/scheduler.py",
        "fires": "every append to a crash-durable job journal (scheduler "
                 "and federation share the format); fired with path=",
    },
    {
        "site": "mem.alloc",
        "modes": ("fail", "delay"),
        "layer": "utils/memledger.py",
        "fires": "every ledger-registered device allocation — fail models "
                 "a deterministic OOM at the registration choke point",
    },
)


def catalog() -> Tuple[Dict[str, object], ...]:
    """The machine-readable fault-site registry: one dict per site with
    ``site`` (the string ``fire`` is called with), ``modes`` (the modes
    that are meaningful there), ``layer`` (the module owning the firing)
    and ``fires`` (prose: which operations trip it).  Returns fresh copies
    — mutating the result never poisons the registry."""
    return tuple(dict(e) for e in _CATALOG)


def catalog_sites() -> frozenset:
    """Just the registered site names (membership checks: HT113, the
    schedule generator's validation, the coverage test)."""
    return frozenset(e["site"] for e in _CATALOG)


class InjectedFault(Exception):
    """Base class of every injected failure."""


class TransientFault(InjectedFault, OSError):
    """An injected failure that models a *transient* condition (flaky disk,
    slow coordinator) — the retry layer treats it as retryable.  Subclasses
    ``OSError`` so code with real-world ``except OSError`` handling exercises
    the same path the genuine failure would take."""


class FaultSpec:
    """Armed behavior of one site.  ``fail``/``corrupt``/``hang`` are
    countdowns (mutated as the site fires; ``-1`` = unlimited); ``delay``
    applies to every firing; ``exit`` counts DOWN to the fatal firing."""

    __slots__ = ("site", "fail", "delay", "corrupt", "hang", "exit", "exc")

    def __init__(
        self,
        site: str,
        fail: int = 0,
        delay: float = 0.0,
        corrupt: int = 0,
        hang: int = 0,
        exit: int = 0,
        exc: type = TransientFault,
    ):
        self.site = site
        self.fail = int(fail)
        self.delay = float(delay)
        self.corrupt = int(corrupt)
        self.hang = int(hang)
        self.exit = int(exit)
        self.exc = exc

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (
            f"FaultSpec({self.site!r}, fail={self.fail}, delay={self.delay}, "
            f"corrupt={self.corrupt}, hang={self.hang}, exit={self.exit})"
        )


def parse_spec(text: str) -> Dict[str, FaultSpec]:
    """Parse the ``HEAT_TPU_FAULTS`` grammar:
    ``site:key=val,key=val;site2:key=val`` with keys
    fail/delay/corrupt/hang/exit."""
    specs: Dict[str, FaultSpec] = {}
    for entry in filter(None, (e.strip() for e in text.split(";"))):
        site, _, kvs = entry.partition(":")
        site = site.strip()
        if not site:
            raise ValueError(f"empty fault site in {text!r}")
        kw: Dict[str, float] = {}
        for kv in filter(None, (p.strip() for p in kvs.split(","))):
            k, _, v = kv.partition("=")
            k = k.strip()
            if k not in ("fail", "delay", "corrupt", "hang", "exit"):
                raise ValueError(f"unknown fault mode {k!r} for site {site!r}")
            kw[k] = float(v) if k == "delay" else int(v)
        specs[site] = FaultSpec(site, **kw)
    return specs


def render_spec(specs: Dict[str, FaultSpec]) -> str:
    """Inverse of :func:`parse_spec`: render armed specs back into the
    ``HEAT_TPU_FAULTS`` grammar (sorted by site for a stable string — the
    chaos engine puts the result in reproducer lines, which must compare
    equal across runs).  Round-trips: ``parse_spec(render_spec(s))``
    arms identically."""
    parts = []
    for site in sorted(specs):
        s = specs[site]
        kvs = []
        for mode in MODES:
            v = getattr(s, mode)
            if v:
                kvs.append(f"{mode}={v:g}" if mode == "delay" else f"{mode}={v}")
        parts.append(f"{site}:{','.join(kvs)}" if kvs else site)
    return ";".join(parts)


# env-armed specs (subprocess chaos tests) parsed once at import; in-process
# tests use the contextvar so parallel/nested scopes stay isolated
_ENV: Dict[str, FaultSpec] = parse_spec(os.environ.get("HEAT_TPU_FAULTS", ""))
_ctx: contextvars.ContextVar[Optional[Dict[str, FaultSpec]]] = contextvars.ContextVar(
    "heat_tpu_faults", default=None
)
_trips: Dict[str, int] = {}


@contextlib.contextmanager
def inject(
    site: str,
    *,
    fail: int = 0,
    delay: float = 0.0,
    corrupt: int = 0,
    hang: int = 0,
    exit: int = 0,
    exc: type = TransientFault,
) -> Iterator[FaultSpec]:
    """Arm ``site`` for the duration of the block (nests; yields the live
    spec so tests can inspect the remaining countdown)."""
    spec = FaultSpec(
        site, fail=fail, delay=delay, corrupt=corrupt, hang=hang, exit=exit, exc=exc
    )
    current = dict(_ctx.get() or {})
    current[site] = spec
    token = _ctx.set(current)
    try:
        yield spec
    finally:
        _ctx.reset(token)


def _flip_byte(path: str) -> None:
    size = os.path.getsize(path)
    if size == 0:
        return
    offset = size // 2
    with open(path, "r+b") as fh:
        fh.seek(offset)
        b = fh.read(1)
        fh.seek(offset)
        fh.write(bytes([b[0] ^ 0xFF]))


def fire(site: str, path: Optional[str] = None) -> None:
    """Trip ``site`` if armed: delay, then hang, then corrupt ``path``,
    then exit, then fail.  A disarmed site is a dict miss — cheap enough
    for hot paths."""
    ctx = _ctx.get()
    if ctx is None and not _ENV:
        return
    spec = (ctx or {}).get(site) or _ENV.get(site)
    if spec is None:
        return
    _trips[site] = _trips.get(site, 0) + 1
    if spec.delay:
        time.sleep(spec.delay)
    if spec.hang != 0:
        if spec.hang > 0:
            spec.hang -= 1
        while True:  # a dead peer never returns; only a watchdog/kill ends this
            time.sleep(3600.0)
    if spec.corrupt != 0 and path is not None:
        if spec.corrupt > 0:
            spec.corrupt -= 1
        _flip_byte(path)
    if spec.exit > 0:
        spec.exit -= 1
        if spec.exit == 0:
            import signal

            os.kill(os.getpid(), signal.SIGKILL)  # rank death, not an exception
    if spec.fail != 0:
        if spec.fail > 0:
            spec.fail -= 1
        raise spec.exc(f"injected fault at site {site!r}")


def trip_count(site: str) -> int:
    """How many times ``site`` fired while armed (since :func:`reset_trips`)."""
    return _trips.get(site, 0)


def reset_trips() -> None:
    _trips.clear()


def trips() -> Dict[str, int]:
    """Every site's firing count since :func:`reset_trips` — the chaos
    engine's *injection evidence*: an armed site whose count stays zero
    means the schedule never actually tested what it claims (the runtime
    twin of the HT113 static check)."""
    return dict(_trips)


# ---------------------------------------------------------------------- #
# bounded retry with jittered exponential backoff
# ---------------------------------------------------------------------- #
def jitter_unit(site: str, attempt: int) -> float:
    """A uniform draw in [0, 1) derived *deterministically* from
    ``(site, attempt)`` — the backoff jitter source.  Process entropy here
    would make lockstep SPMD ranks sleep differently after the same
    transient fault (the HT105 rationale: divergent sleeps skew the
    collective timing the flight recorder fingerprints), and would make a
    replayed chaos schedule time differently than the run it reproduces.
    sha256 is stable across processes, platforms and PYTHONHASHSEED;
    distinct sites and attempts still decorrelate (the reason jitter
    exists) because they hash apart."""
    digest = hashlib.sha256(f"backoff|{site}|{int(attempt)}".encode()).digest()
    return int.from_bytes(digest[:8], "big") / 2.0**64


def backoff_schedule(
    retries: int,
    base_delay: float = 0.05,
    factor: float = 2.0,
    max_delay: float = 2.0,
    jitter: float = 0.5,
    rand: Optional[Callable[[], float]] = None,
    site: str = "",
) -> Iterator[float]:
    """The delays slept between attempts: ``min(max_delay, base*factor**i)``
    stretched by up to ``jitter``× a uniform draw (decorrelates the retry
    storms of many writers hitting one flaky store).  The draw is seeded
    per ``(site, attempt)`` (:func:`jitter_unit`) — deterministic, so two
    replayed ranks derive identical sleep sequences; distinct *sites*
    retrying concurrently still spread out.  ``rand`` remains injectable
    so tests pin the schedule without sleeping."""
    for i in range(retries):
        u = rand() if rand is not None else jitter_unit(site, i)
        yield min(max_delay, base_delay * factor**i) * (1.0 + jitter * u)


def call_with_retries(
    fn: Callable,
    site: str,
    retries: int = 4,
    base_delay: float = 0.05,
    factor: float = 2.0,
    max_delay: float = 2.0,
    jitter: float = 0.5,
    retry_on: Tuple[type, ...] = (TransientFault, OSError),
    retry_if: Optional[Callable[[BaseException], bool]] = None,
    sleep: Callable[[float], None] = time.sleep,
    rand: Optional[Callable[[], float]] = None,
    deadline: Optional[float] = None,
    clock: Callable[[], float] = time.monotonic,
):
    """Run ``fn()`` with up to ``retries`` backoff retries on transient
    failures.  Each retry increments the ``retry.<site>`` counter in
    ``utils.profiler`` so recovered faults stay visible.  ``retry_if``
    narrows ``retry_on`` (e.g. only coordinator-unreachable RuntimeErrors);
    ``sleep``/``rand``/``clock`` are injectable for fake-clock tests.

    ``deadline`` is a TOTAL-time budget in seconds: cumulative time spent
    (attempts + backoff sleeps, measured on ``clock``) never exceeds it —
    a backoff sleep that would overrun the budget is not taken and the
    last failure re-raises instead.  This caps tail latency where the
    attempt count alone cannot (attempt durations vary; a slow NFS mount
    can eat the whole budget in one try).

    Every give-up — attempts exhausted OR deadline overrun — increments
    ``retry.<site>.exhausted`` before re-raising, so abandoned recoveries
    are visible post-hoc, not just the successful ones."""
    delays = None
    attempt = 0
    t0 = clock()
    while True:
        try:
            return fn()
        except retry_on as e:
            if retry_if is not None and not retry_if(e):
                raise
            # profiler pulls in torch; a standalone-loaded consumer (the
            # supervisor's tools) keeps the bounded retry and merely loses
            # the profiler's retry.<site> counters
            try:
                from . import profiler
            except ImportError:
                profiler = None

            def _count(name: str) -> None:
                if profiler is not None:
                    profiler.counter_inc(name)

            if attempt >= retries:
                _count(f"retry.{site}.exhausted")
                raise
            if delays is None:
                delays = list(
                    backoff_schedule(
                        retries, base_delay, factor, max_delay, jitter, rand,
                        site=site,
                    )
                )
            if deadline is not None:
                elapsed = clock() - t0
                if elapsed + delays[attempt] >= deadline:
                    _count(f"retry.{site}.exhausted")
                    raise
            _count(f"retry.{site}")
            sleep(delays[attempt])
            attempt += 1
