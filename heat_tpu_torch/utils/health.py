"""Health protocol: heartbeats, deadlines, and the collective watchdog.

HeAT's MPI heritage assumes a fixed, immortal world: one hung or killed
rank deadlocks every collective forever.  This module is the *detection*
half of the elastic runtime (the *recovery* half is
``heat_tpu_torch.parallel.supervisor``): it lets every process prove liveness
cheaply, and lets blocking collective waits fail fast instead of hanging.

Three pieces:

- **Heartbeat** — a per-process beacon file, atomically rewritten
  (tmp + rename) with a monotonic step counter, an epoch timestamp, the
  pid and the current restart epoch.  A supervisor reads *only* the file
  mtime/payload — no signal, no socket — so heartbeats survive every
  transport failure short of a dead filesystem.  Writes count under
  ``health.heartbeat.writes``.

- **Deadline** — a monotonic-clock budget with ``remaining()`` /
  ``expired()`` / ``check()``.  :func:`deadline` (also exposed as
  ``Communication.deadline``) arms one for a block via a contextvar;
  collective staging points check it and blocking waits are guarded by
  it.

- **guard_blocking** — the watchdog around a blocking call (``Wait``,
  ``Barrier``, ``host_fetch``): with a deadline armed, the call runs on a
  daemon worker thread joined with the remaining budget; on expiry every
  thread's stack is dumped via :mod:`faulthandler` (the same dump the
  multiprocess watchdog wires) and :class:`CollectiveTimeoutError` is
  raised — the abandoned worker thread is the supervisor's problem, which
  is exactly the point: *this* process stops pretending the collective
  will complete.  Trips count under ``health.deadline.trips``.

Counters live in a module-local store mirrored into ``utils.profiler``
(when loaded) via a counter provider, so ``telemetry.report()`` carries
``health.*`` next to ``comm.*``/``retry.*`` — but nothing here imports
torch: the supervisor process reads heartbeats without paying a backend
import.

Stdlib-only on purpose.
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import os
import sys
import threading
import time
from typing import Any, Callable, Dict, Iterator, Optional

__all__ = [
    "CollectiveTimeoutError",
    "Deadline",
    "Heartbeat",
    "deadline",
    "active_deadline",
    "guard_blocking",
    "write_heartbeat",
    "read_heartbeat",
    "heartbeat_age",
    "restart_epoch",
    "counters",
    "counter_inc",
    "reset_counters",
]


class CollectiveTimeoutError(TimeoutError):
    """A collective (or other guarded blocking call) exceeded its armed
    deadline.  Raised *instead of hanging forever* — the surviving process
    can tear down cleanly and let the supervisor restart the world."""


def restart_epoch() -> int:
    """The current restart generation: 0 on a fresh launch, incremented by
    the supervisor on every world restart (``HEAT_TPU_RESTART_EPOCH``).
    Workers branch on this to resume from the newest verified checkpoint."""
    try:
        return int(os.environ.get("HEAT_TPU_RESTART_EPOCH", "0") or 0)
    except ValueError:
        return 0


# ---------------------------------------------------------------------- #
# counters — module-local so the supervisor never imports torch; mirrored
# into utils.profiler (as a provider) when that module is loaded
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
    """Register the ``health`` provider with ``utils.profiler`` — but only
    if profiler is ALREADY loaded (importing it pulls torch, which the
    supervisor process must never pay)."""
    global _provider_registered
    if _provider_registered:
        return
    prof = sys.modules.get("heat_tpu_torch.utils.profiler")
    if prof is None:
        return
    # keys are emitted pre-prefixed ("health.*"), so the provider namespace
    # rule passes them through verbatim
    prof.register_counter_provider("health", lambda: dict(_counters))
    _provider_registered = True


# ---------------------------------------------------------------------- #
# heartbeat beacon
# ---------------------------------------------------------------------- #
def write_heartbeat(
    path: str, step: int, status: str = "ok", extra: Optional[dict] = None
) -> None:
    """Atomically (re)write the heartbeat file at ``path``.

    The payload is one JSON object: ``pid``, monotonic ``step``, epoch
    ``time``, the process's ``restart_epoch`` and a free-form ``status``.
    tmp-then-rename so a reader never sees a torn write; the parent
    directory must exist.  The tmp name is unique per pid AND thread —
    the ``start_beacon`` daemon thread writes concurrently with the train
    loop's ``beat()`` by design, and a shared tmp would let one writer's
    ``os.replace`` consume the file out from under the other's."""
    rec = {
        "pid": os.getpid(),
        "step": int(step),
        "time": time.time(),
        "restart_epoch": restart_epoch(),
        "status": status,
    }
    # fold the flight recorder's latest collective into the beacon: the
    # supervisor then sees live SEMANTIC progress ("rank 2 stuck at seq 417
    # Alltoall while peers are at 423"), not just mtime staleness.  Via
    # sys.modules — this module must stay importable without the package.
    fr = sys.modules.get("heat_tpu_torch.utils.flightrec")
    if fr is not None:
        try:
            last = fr.last_collective()
        except Exception:
            last = None
        if last is not None:
            rec["seq"], rec["collective"] = int(last[0]), str(last[1])
    # fold the memory ledger's live bytes in the same way: the supervisor's
    # staleness lines then report memory alongside seq progress, and the
    # /metrics heartbeat gauges get a per-rank memory view for free
    ml = sys.modules.get("heat_tpu_torch.utils.memledger")
    if ml is not None:
        try:
            if ml.enabled():
                rec["mem_live"] = int(ml.live_bytes())
        except Exception:
            pass
    if extra:
        rec.update(extra)
    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
    with open(tmp, "w") as fh:
        json.dump(rec, fh)
    os.replace(tmp, path)
    counter_inc("health.heartbeat.writes")


def read_heartbeat(path: str) -> Optional[dict]:
    """The last complete heartbeat record, or None (missing/torn file —
    a torn read can only happen for a non-atomic foreign writer, but the
    supervisor must never crash on one)."""
    try:
        with open(path) as fh:
            return json.load(fh)
    except (OSError, ValueError):
        return None


def heartbeat_age(path: str, now: Optional[float] = None) -> Optional[float]:
    """Seconds since the beacon at ``path`` was last rewritten (file mtime —
    cheaper than parsing, and immune to clock skew between writer fields),
    or None when the file does not exist yet."""
    try:
        mtime = os.path.getmtime(path)
    except OSError:
        return None
    return (now if now is not None else time.time()) - mtime


class Heartbeat:
    """Convenience beacon bound to one path: ``beat()`` bumps the monotonic
    step and rewrites the file; ``start_beacon(interval)`` additionally
    spawns a daemon thread re-beating the *current* step every interval —
    liveness proof for long single-step sections (a big compile, a long
    collective that IS making progress)."""

    def __init__(self, path: str):
        self.path = path
        self.step = 0
        self._stop: Optional[threading.Event] = None
        self._thread: Optional[threading.Thread] = None
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)

    def beat(self, step: Optional[int] = None, status: str = "ok", **extra) -> None:
        self.step = self.step + 1 if step is None else int(step)
        write_heartbeat(self.path, self.step, status=status, extra=extra or None)

    def start_beacon(self, interval: float = 5.0) -> None:
        if self._thread is not None:
            return
        self._stop = threading.Event()

        def run() -> None:
            while not self._stop.wait(interval):
                try:
                    write_heartbeat(self.path, self.step, status="beacon")
                except OSError:
                    # a transiently full/contended filesystem must not kill
                    # the beacon silently — missing ONE beat is recoverable,
                    # a dead beacon thread reads as a wedged rank
                    pass

        self._thread = threading.Thread(target=run, name="heat-heartbeat", daemon=True)
        self._thread.start()

    def stop_beacon(self) -> None:
        if self._stop is not None:
            self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=1.0)
        self._thread = None
        self._stop = None

    def __enter__(self) -> "Heartbeat":
        return self

    def __exit__(self, *exc) -> bool:
        self.stop_beacon()
        return False


# ---------------------------------------------------------------------- #
# deadlines
# ---------------------------------------------------------------------- #
class Deadline:
    """A monotonic-clock time budget.  Cheap by design: creation is two
    float reads; ``check()`` is one clock read and a comparison."""

    __slots__ = ("seconds", "_t1")

    def __init__(self, seconds: float):
        self.seconds = float(seconds)
        self._t1 = time.monotonic() + self.seconds

    def remaining(self) -> float:
        """Seconds left (may be negative once expired)."""
        return self._t1 - time.monotonic()

    def expired(self) -> bool:
        return time.monotonic() >= self._t1

    def check(self, what: str = "operation") -> None:
        """Raise :class:`CollectiveTimeoutError` when the budget is gone.
        Collective staging points call this so an already-blown deadline
        stops staging MORE work on a world that is being torn down."""
        if self.expired():
            counter_inc("health.deadline.trips")
            raise CollectiveTimeoutError(
                f"{what} exceeded its {self.seconds:.3f}s deadline"
            )

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Deadline({self.seconds}, remaining={self.remaining():.3f})"


_active: contextvars.ContextVar[Optional[Deadline]] = contextvars.ContextVar(
    "heat_tpu_deadline", default=None
)


def active_deadline() -> Optional[Deadline]:
    return _active.get()


@contextlib.contextmanager
def deadline(seconds: float) -> Iterator[Deadline]:
    """Arm a deadline for the block: guarded blocking waits inside it raise
    :class:`CollectiveTimeoutError` instead of hanging, and collective
    staging checks it.  Nested deadlines: the innermost governs (its budget
    is what the block explicitly asked for)."""
    dl = Deadline(seconds)
    token = _active.set(dl)
    try:
        yield dl
    finally:
        _active.reset(token)


def _dump_stacks() -> None:
    """Every thread's stack to stderr — the same diagnostic the mp-lane
    watchdog produces, so a tripped deadline is debuggable post-hoc."""
    try:
        import faulthandler

        faulthandler.dump_traceback(file=sys.stderr)
    except Exception:  # pragma: no cover - faulthandler is stdlib
        pass


def _wait_observer():
    """The telemetry module iff it is loaded AND armed; None otherwise.
    Via ``sys.modules`` so this module never imports the package (a bare
    supervisor process must keep working without telemetry)."""
    tel = sys.modules.get("heat_tpu_torch.utils.telemetry")
    if tel is None or not getattr(tel, "_ENABLED", False):
        return None
    return tel


def _observe_wait(what: str, seconds: float) -> None:
    """Record an observed blocking-wait duration into the per-collective
    histogram ``<what>.wait`` (e.g. ``comm.Wait.wait``,
    ``comm.host_fetch.wait``, ``comm.resplit.tile.wait``) — the straggler
    evidence ``scripts/postmortem.py`` reads from the telemetry export —
    AND as a ``<what>.wait`` leaf record in the span ring, which is what
    positions the wait INSIDE its enclosing step span: the step-time
    breakdown (``scripts/stepprof.py``) attributes per-step comm-wait from
    these leaf records, the cumulative histogram alone cannot say which
    step paid.  Gated on telemetry being ARMED: disarmed, the observation
    could never reach an export anyway, and doing per-call histogram work
    between back-to-back collectives is exactly the hot-path cost the
    telemetry-off contract forbids (measured: it can perturb rapid
    small-collective streams on slow hosts)."""
    tel = _wait_observer()
    if tel is None:
        return
    try:
        tel.observe(f"{what}.wait", seconds)
        tel.record_event(f"{what}.wait", seconds)
    except Exception:
        pass


def guard_blocking(fn: Callable[[], Any], what: str) -> Any:
    """Run ``fn()`` under the active deadline (plain call when none armed).

    The blocking call runs on a daemon worker thread joined with the
    remaining budget.  On expiry: ``health.deadline.trips`` increments,
    stacks are dumped, and :class:`CollectiveTimeoutError` raises — the
    worker thread is abandoned (it is stuck in uninterruptible C code by
    hypothesis; only a process teardown can reclaim it, and that teardown
    is exactly what the caller's error handling / the supervisor performs).

    Either way the observed wait time lands in the ``<what>.wait``
    histogram (:func:`_observe_wait`) WHEN telemetry is armed: on a trip
    the recorded value is the full burned budget, so a straggler's guard
    sites accumulate visibly long waits — the attribution the post-mortem
    analyzer names.  Telemetry off: the no-deadline path is a bare
    ``fn()`` call — no clocks, no histogram — per the off-cost contract."""
    dl = _active.get()
    if dl is None:
        if _wait_observer() is None:
            return fn()
        t0 = time.monotonic()
        try:
            return fn()
        finally:
            _observe_wait(what, time.monotonic() - t0)
    remaining = dl.remaining()
    if remaining <= 0:
        dl.check(what)  # raises
    box: dict = {}
    # threads do NOT inherit contextvars — copy the caller's context so
    # fault injections (faults.inject is contextvar-scoped) and the armed
    # deadline are visible inside the worker thread
    ctx = contextvars.copy_context()

    def run() -> None:
        try:
            box["value"] = ctx.run(fn)
        except BaseException as e:  # propagate the real failure to the caller
            box["error"] = e

    t = threading.Thread(target=run, name=f"heat-guard:{what}", daemon=True)
    t0 = time.monotonic()
    t.start()
    t.join(remaining)
    _observe_wait(what, time.monotonic() - t0)
    if t.is_alive():
        counter_inc("health.deadline.trips")
        _dump_stacks()
        raise CollectiveTimeoutError(
            f"{what} exceeded its {dl.seconds:.3f}s deadline "
            f"(blocked > {remaining:.3f}s remaining budget)"
        )
    if "error" in box:
        raise box["error"]
    return box.get("value")
