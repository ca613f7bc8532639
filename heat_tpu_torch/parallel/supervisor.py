"""Supervised restart-with-resume: the recovery half of the elastic runtime.

The detection half (``heat_tpu_torch.utils.health``) gives every rank a heartbeat
beacon and every collective a deadline; this module is the process that
*acts* on those signals.  A :class:`Supervisor` owns a world of rank
subprocesses and drives the state machine::

    LAUNCH ──► MONITOR ──(all ranks exit 0)──► DONE(ok)
                  │
                  ├─ rank died (nonzero / signal)
                  ├─ heartbeat went stale (> heartbeat_timeout)
                  └─ generation overran its deadline
                  │
                  ▼
          TEARDOWN: SIGUSR1 every survivor (faulthandler stack dump into
          its log), grace, then SIGKILL
                  │
        restarts < budget? ──no──► DONE(failed, merged diagnostic report)
                  │ yes
                  ▼
          RELAUNCH: fresh coordinator port, HEAT_TPU_RESTART_EPOCH+1,
          back to MONITOR

Workers detect ``HEAT_TPU_RESTART_EPOCH > 0`` at bring-up
(``bootstrap.restart_epoch()``) and resume from the newest verified
checkpoint (``DASO.resume()`` / ``load_array_checkpoint``'s fallback
chain), so one ``kill -9`` costs at most ``checkpoint_every`` steps — not
the run.

Why a fresh port per generation: the coordination service lives inside
rank 0; when the world dies the listener dies with it, and rebinding the
old port races TIME_WAIT.  Why kill *everyone* on one failure: a dead
peer wedges every survivor's next collective forever (the MPI heritage
this layer exists to escape) — waiting for them is pure lost time.

Everything the watchdog does is counted (``watchdog.dumps``,
``watchdog.kills``, ``health.restarts``) and returned in the
:class:`SupervisorResult`, so a post-hoc report shows every silent kill.

Stdlib-only on purpose — no package-relative imports either, so launchers
may load this file standalone (``importlib.util.spec_from_file_location``)
without importing ``heat_tpu_torch`` and hence without importing torch: the
supervisor is the process that outlives the runtime it supervises.  The
heartbeat *reader* here is deliberately just the file mtime — the writer
(``heat_tpu_torch.utils.health.Heartbeat``) rewrites atomically, and mtime is
immune to payload-format drift between supervisor and worker versions.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
import signal
import socket
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

__all__ = [
    "Supervisor",
    "SupervisorResult",
    "free_port",
    "dump_stacks_then_kill",
]


def free_port() -> int:
    """An OS-assigned free TCP port (the next coordinator's address)."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def dump_stacks_then_kill(procs, grace: float = 3.0) -> Dict[str, int]:
    """Watchdog teardown for wedged workers: SIGUSR1 each live process (the
    workers registered a faulthandler stack dump on it, so every thread's
    traceback lands in that rank's output), give them ``grace`` seconds to
    finish dumping, then kill.  Returns ``{"dumps": n, "kills": m}`` — the
    counts the callers fold into the merged telemetry report so silent
    kills stay visible post-hoc (``dumps`` = processes asked for a stack
    dump, ``kills`` = processes that had to be SIGKILLed after the
    grace)."""
    hung = [p for p in procs if p.poll() is None]
    if not hung:
        return {"dumps": 0, "kills": 0}
    print(
        f"watchdog: {len(hung)} process(es) still alive at the deadline; "
        "requesting stack dumps (SIGUSR1) before kill",
        flush=True,
    )
    for p in hung:
        try:
            p.send_signal(signal.SIGUSR1)
        except OSError:
            pass
    t0 = time.monotonic()
    while time.monotonic() - t0 < grace and any(p.poll() is None for p in hung):
        time.sleep(0.1)
    kills = 0
    for p in hung:
        if p.poll() is None:
            p.kill()
            kills += 1
    return {"dumps": len(hung), "kills": kills}


# the two failure shapes _check_failure emits, with the "epoch N:" prefix
# run() stamps on; kept as ONE module-level pattern so post-hoc consumers
# (the chaos blame oracle, log scrapers) parse failures structurally
# instead of each growing its own regex of these strings
_FAILURE_RE = re.compile(
    r"^epoch (?P<epoch>\d+): rank (?P<rank>\d+) "
    r"(?:died with exit code (?P<code>-?\d+)"
    r"|heartbeat stale \((?P<age>[\d.]+)s)"
)


def parse_failure(failure: str) -> Optional[dict]:
    """Parse one ``SupervisorResult.failures`` string into its facts:
    ``{"epoch", "rank", "kind": "died"|"stale", "code"|"age"}`` — None
    for shapes that name no rank (e.g. a generation-deadline overrun).
    This is the read-side contract of the failure strings: a wording
    change here must keep this parser (and its tests) honest."""
    m = _FAILURE_RE.match(failure)
    if not m:
        return None
    out = {"epoch": int(m.group("epoch")), "rank": int(m.group("rank"))}
    if m.group("code") is not None:
        out["kind"] = "died"
        out["code"] = int(m.group("code"))
    else:
        out["kind"] = "stale"
        out["age"] = float(m.group("age"))
    return out


@dataclass
class SupervisorResult:
    """What happened, for the caller and the post-hoc report."""

    ok: bool
    restarts: int
    generations: int
    returncodes: List[Optional[int]]
    counters: Dict[str, int]
    failures: List[str] = field(default_factory=list)
    postmortems: List[dict] = field(default_factory=list)
    jobs: Optional[dict] = None

    def report(self) -> dict:
        """Merged diagnostic structure (printed/JSON-dumped by launchers on
        give-up; the counters slot straight into a telemetry counters
        line).  ``postmortems`` carries one flight-recorder verdict per
        failed generation (``scripts/postmortem.py``): the report no
        longer just says "rank died / went stale", it names the first
        divergent collective sequence or the straggler rank.  ``jobs``
        (when a serving scheduler's journal was configured) accounts every
        accepted job per generation — accepted/completed/retried/shed/
        failed, plus ``lost``, the count the chaos lane pins at zero."""
        rep = {
            "ok": self.ok,
            "restarts": self.restarts,
            "generations": self.generations,
            "returncodes": self.returncodes,
            "counters": dict(self.counters),
            "failures": list(self.failures),
            "postmortems": list(self.postmortems),
        }
        if self.jobs is not None:
            rep["jobs"] = dict(self.jobs)
        return rep


class Supervisor:
    """Supervise ``n_ranks`` subprocesses with liveness + heartbeat
    monitoring and restart-with-resume.

    ``spawn(rank, epoch, port)`` launches one rank of generation ``epoch``
    against a coordinator at ``port`` and returns its ``subprocess.Popen``.
    The callback owns the environment; its contract with this class:

    - export ``HEAT_TPU_RESTART_EPOCH=<epoch>`` so the worker's resume
      path can branch on it;
    - if heartbeat monitoring is wanted, have rank ``r`` beat
      ``<heartbeat_dir>/rank<r>.json`` (``health.Heartbeat``);
    - route stdout/stderr somewhere durable (a log file) — SIGUSR1 stack
      dumps land there.

    Monitoring declares the generation failed when any rank exits nonzero
    (or by signal), any live rank's heartbeat goes staler than
    ``heartbeat_timeout`` (a rank that never beats is measured from the
    generation's start), or the generation exceeds
    ``generation_deadline``.  On failure the remaining world is torn down
    via :func:`dump_stacks_then_kill` and — while ``restart_budget``
    lasts — relaunched on a fresh port with the epoch incremented.
    """

    def __init__(
        self,
        spawn: Callable[[int, int, int], subprocess.Popen],
        n_ranks: int,
        *,
        heartbeat_dir: Optional[str] = None,
        heartbeat_timeout: float = 120.0,
        restart_budget: int = 1,
        generation_deadline: Optional[float] = None,
        poll_interval: float = 0.5,
        grace: float = 3.0,
        flightrec_dir: Optional[str] = None,
        telemetry_dir: Optional[str] = None,
        job_journal: Optional[str] = None,
        monitor_port: Optional[int] = None,
        resize: Optional[Callable[[int], Optional[int]]] = None,
    ):
        self.spawn = spawn
        self.n_ranks = int(n_ranks)
        # elastic capacity: `resize(current_n_ranks)` is
        # consulted at each RELAUNCH boundary — the one point where the
        # world is fully down and the checkpoint world-reshaping path
        # (resume validates topology via the sidecar) owns state across a
        # size change.  Returning a different positive rank count re-sizes
        # the next generation; None / same / nonpositive keeps it.  The
        # federation layer derives the target from journal-visible queue
        # depth (federation.resize_target).
        self.resize = resize
        self.heartbeat_dir = heartbeat_dir
        self.heartbeat_timeout = float(heartbeat_timeout)
        self.restart_budget = int(restart_budget)
        self.generation_deadline = generation_deadline
        self.poll_interval = float(poll_interval)
        self.grace = float(grace)
        # post-mortem inputs: when `flightrec_dir` is set, every TEARDOWN
        # harvests the ranks' crash-durable rings, runs the analyzer
        # (loaded standalone — still no torch) and
        # keeps the verdict; `telemetry_dir` additionally feeds the
        # comm.<name>.wait straggler evidence into it
        self.flightrec_dir = flightrec_dir
        self.telemetry_dir = telemetry_dir
        # serving integration: when the workers run a scheduler journaling
        # to `job_journal`, the final report carries a per-generation jobs
        # section (accepted/completed/retried/shed/failed + lost) merged
        # from that journal — scheduler.py is loaded standalone, so this
        # process still never imports torch
        self.job_journal = job_journal
        self.counters: Dict[str, int] = {
            "watchdog.dumps": 0,
            "watchdog.kills": 0,
            "health.restarts": 0,
        }
        # live observability plane: when monitor_port is given
        # (0 = OS-assigned), the SUPERVISOR hosts the /metrics + /healthz
        # endpoint over the whole world's heartbeat dir — the one process
        # guaranteed to outlive any generation, serving the worst-rank
        # staleness verdict + supervision counters without importing torch
        # (utils/monitor.py is stdlib-only and loaded standalone).
        self.monitor = None
        if monitor_port is not None:
            mon = self._load_tool("heat_monitor", self._MONITOR_PATH)
            if mon is not None:
                try:
                    self.monitor = mon.Monitor(
                        port=int(monitor_port),
                        heartbeat_dir=self.heartbeat_dir,
                        stale_after=self.heartbeat_timeout,
                    )
                except OSError:
                    self.monitor = None  # a busy port must not kill supervision
                else:
                    # weakly held, registered only once the server actually
                    # bound: a dead Supervisor is pruned at the next scrape
                    # instead of pinned alive by the module-global registry
                    import weakref

                    ref = weakref.ref(self)

                    def _sup_counters():
                        s = ref()
                        return dict(s.counters) if s is not None else None

                    mon.register_gauge_source("supervisor", _sup_counters)

    # ------------------------------------------------------------------ #
    def _heartbeat_path(self, rank: int) -> str:
        return os.path.join(self.heartbeat_dir, f"rank{rank}.json")

    def _heartbeat_payload(self, rank: int) -> dict:
        """Last heartbeat JSON of ``rank`` ({} on any problem — the
        monitor must never crash on a torn/missing beacon)."""
        try:
            with open(self._heartbeat_path(rank)) as fh:
                rec = json.load(fh)
            return rec if isinstance(rec, dict) else {}
        except (OSError, ValueError):
            return {}

    def _semantic_progress(self, stale_rank: int) -> str:
        """' (stuck at seq 417 Alltoall; peers at seq 423)' when the
        beacons carry the flight recorder's collective sequence — the
        live semantic-progress view the heartbeat ``seq`` field exists
        for; '' when no beacon has one."""
        mine = self._heartbeat_payload(stale_rank)
        peers = [
            self._heartbeat_payload(r).get("seq")
            for r in range(self.n_ranks)
            if r != stale_rank
        ]
        peers = [s for s in peers if isinstance(s, int)]
        if not isinstance(mine.get("seq"), int):
            return ""
        msg = f" (stuck at seq {mine['seq']} {mine.get('collective', '?')}"
        if peers:
            msg += f"; peers at seq {max(peers)}"
        if isinstance(mine.get("mem_live"), int):
            # memory rides the beacon too (the memory ledger's live bytes):
            # "stuck at seq 4 resplit, 1.9 GB live" tells an OOM-adjacent
            # wedge apart from a plain network stall at a glance
            msg += f"; {mine['mem_live']} B live"
        return msg + ")"

    def _clear_heartbeats(self) -> None:
        """Remove the previous generation's beacons so staleness is always
        measured against THIS generation (a stale leftover file would trip
        the monitor before the new rank's first beat)."""
        if not self.heartbeat_dir:
            return
        os.makedirs(self.heartbeat_dir, exist_ok=True)
        for r in range(self.n_ranks):
            try:
                os.unlink(self._heartbeat_path(r))
            except OSError:
                pass

    def _check_failure(
        self, procs: List[subprocess.Popen], gen_wall_start: float
    ) -> Optional[str]:
        codes = [p.poll() for p in procs]
        for r, c in enumerate(codes):
            if c is not None and c != 0:
                sig = f" (signal {-c})" if c < 0 else ""
                return f"rank {r} died with exit code {c}{sig}"
        if self.heartbeat_dir:
            now = time.time()
            for r, c in enumerate(codes):
                if c is not None:
                    continue  # exited 0: no longer expected to beat
                try:
                    age = now - os.path.getmtime(self._heartbeat_path(r))
                except OSError:
                    age = now - gen_wall_start  # never beat yet
                if age > self.heartbeat_timeout:
                    return (
                        f"rank {r} heartbeat stale ({age:.1f}s > "
                        f"{self.heartbeat_timeout:.1f}s) — hung or wedged"
                        + self._semantic_progress(r)
                    )
        return None

    # ------------------------------------------------------------------ #
    # flight-recorder harvest + post-mortem (TEARDOWN diagnostics)
    # ------------------------------------------------------------------ #
    # the ring analyzer (heat_tpu_torch/analysis/postmortem.py) runs at every
    # teardown with a flight-recorder dir: its verdict lands in the report
    _POSTMORTEM_PATH = os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", "analysis", "postmortem.py"
    )
    _SCHEDULER_PATH = os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "scheduler.py"
    )
    _MONITOR_PATH = os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", "utils", "monitor.py"
    )
    _tool_mods: Dict[str, object] = {}

    @classmethod
    def _load_tool(cls, modname: str, path: str):
        """The ONE standalone-loader for the supervisor's stdlib-only
        diagnostic companions (postmortem analyzer, scheduler journal
        replayer) — this process must never import torch.  None when the
        file is missing (a stripped install): the report then degrades
        gracefully, it never loses the supervision result over a
        diagnostics module."""
        if modname not in cls._tool_mods:
            path = os.path.normpath(path)
            if not os.path.exists(path):
                return None
            spec = importlib.util.spec_from_file_location(modname, path)
            mod = importlib.util.module_from_spec(spec)
            sys.modules[spec.name] = mod
            spec.loader.exec_module(mod)
            cls._tool_mods[modname] = mod
        return cls._tool_mods[modname]

    def _jobs_section(self) -> Optional[dict]:
        """The per-generation job accounting merged from the scheduler
        journal; None when no journal was configured or nothing was
        written.  Diagnostics must never kill the supervisor: a corrupt /
        newer-schema journal — or a scheduler.py that fails to load —
        degrades to an ``error`` entry, not a crash."""
        if not self.job_journal or not os.path.exists(self.job_journal):
            return None
        try:
            sched = self._load_tool("heat_scheduler", self._SCHEDULER_PATH)
            if sched is None:
                return None
            return sched.jobs_summary(sched.replay_journal(self.job_journal))
        except Exception as e:
            return {"error": f"journal replay failed: {e!r}"}

    @classmethod
    def _load_postmortem(cls):
        """scripts/postmortem.py via :meth:`_load_tool` (kept as a named
        entry point — the run loop calls it at every teardown)."""
        return cls._load_tool("heat_postmortem", cls._POSTMORTEM_PATH)

    def _run_postmortem(self, epoch: int, failure: str) -> Optional[dict]:
        """Analyze the dead generation's rings, then HARVEST them (move
        into ``{flightrec_dir}/epoch{epoch}/``) so the relaunched world
        starts a clean black box and the evidence survives next to the
        logs.  Returns the verdict dict (with ``epoch``/``failure``
        attached), or None when no recorder was configured."""
        if not self.flightrec_dir:
            return None
        pm = self._load_postmortem()
        if pm is None:
            return None
        try:
            verdict = pm.analyze_dir(
                self.flightrec_dir,
                heartbeat_dir=self.heartbeat_dir,
                telemetry_dir=self.telemetry_dir,
                expected_ranks=list(range(self.n_ranks)),
            )
        except Exception as e:  # diagnostics must never kill the supervisor
            verdict = {"verdict": "inconclusive", "detail": f"analyzer failed: {e!r}"}
        verdict["epoch"] = epoch
        verdict["failure"] = failure
        harvest = os.path.join(self.flightrec_dir, f"epoch{epoch}")
        try:
            os.makedirs(harvest, exist_ok=True)
            for name in os.listdir(self.flightrec_dir):
                if name.startswith("flight_rank") and name.endswith(".ring"):
                    os.replace(
                        os.path.join(self.flightrec_dir, name),
                        os.path.join(harvest, name),
                    )
        except OSError:
            pass
        return verdict

    def run(self) -> SupervisorResult:
        failures: List[str] = []
        postmortems: List[dict] = []
        epoch = 0
        while True:
            port = free_port()
            self._clear_heartbeats()
            gen_wall_start = time.time()
            gen_t0 = time.monotonic()
            procs = [self.spawn(r, epoch, port) for r in range(self.n_ranks)]
            failure: Optional[str] = None
            while True:
                codes = [p.poll() for p in procs]
                if all(c == 0 for c in codes):
                    return SupervisorResult(
                        ok=True,
                        restarts=epoch,
                        generations=epoch + 1,
                        returncodes=codes,
                        counters=dict(self.counters),
                        failures=failures,
                        postmortems=postmortems,
                        jobs=self._jobs_section(),
                    )
                failure = self._check_failure(procs, gen_wall_start)
                if failure is not None:
                    break
                if (
                    self.generation_deadline is not None
                    and time.monotonic() - gen_t0 > self.generation_deadline
                ):
                    failure = (
                        f"generation {epoch} exceeded its "
                        f"{self.generation_deadline:.0f}s deadline"
                    )
                    break
                time.sleep(self.poll_interval)
            failures.append(f"epoch {epoch}: {failure}")
            print(f"supervisor: {failures[-1]}; tearing the world down", flush=True)
            d = dump_stacks_then_kill(procs, grace=self.grace)
            self.counters["watchdog.dumps"] += d["dumps"]
            self.counters["watchdog.kills"] += d["kills"]
            for p in procs:
                if p.poll() is None:
                    p.wait()
            # every dead rank has stopped moving its ring: analyze + harvest
            # NOW, before a relaunch overwrites the evidence
            pm = self._run_postmortem(epoch, failure)
            if pm is not None:
                postmortems.append(pm)
                mod = self._load_postmortem()
                if mod is not None:
                    print("supervisor: " + mod.summary_line(pm, epoch=epoch), flush=True)
            if epoch >= self.restart_budget:
                return SupervisorResult(
                    ok=False,
                    restarts=epoch,
                    generations=epoch + 1,
                    returncodes=[p.poll() for p in procs],
                    counters=dict(self.counters),
                    failures=failures,
                    postmortems=postmortems,
                    jobs=self._jobs_section(),
                )
            epoch += 1
            self.counters["health.restarts"] += 1
            if self.resize is not None:
                try:
                    want = self.resize(self.n_ranks)
                except Exception:
                    want = None  # a broken resize hook must not kill supervision
                if want is not None and int(want) > 0 and int(want) != self.n_ranks:
                    # beacons are cleared under the OLD count first: a
                    # shrink would otherwise leave high-rank beacons behind
                    # for the staleness monitor to convict
                    self._clear_heartbeats()
                    print(
                        f"supervisor: resizing world {self.n_ranks} -> "
                        f"{int(want)} rank(s) for epoch {epoch}",
                        flush=True,
                    )
                    self.n_ranks = int(want)
                    self.counters["health.resizes"] = (
                        self.counters.get("health.resizes", 0) + 1
                    )
            print(
                f"supervisor: restarting the world (epoch {epoch} of "
                f"<= {self.restart_budget}) on a fresh coordinator port",
                flush=True,
            )
