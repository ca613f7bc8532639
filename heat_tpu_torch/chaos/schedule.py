"""Deterministic fault-schedule generation over the registered catalog.

A *schedule* is one point in the fault space ``sites × modes × timing ×
topology``: a workload shape (train/serve/fed, rank count, job count)
plus a small set of faults, each pinned to a site from
``faults.catalog()``, a legal mode there, a trigger value, a victim rank
and a generation.  Schedules are drawn pseudo-randomly from a seed with
**no process entropy anywhere** — ``(seed, index)`` fully determines the
schedule, so a campaign is resumable by index range and a failing
schedule is reproducible from its ``CHAOS-REPRO`` line alone.

The generator draws only from the *survivable envelope*: every schedule
it emits is one the runtime contracts promise to absorb (fail counts
inside retry budgets, at most one lethal fault covered by the restart
budget, hangs only where a watchdog reclaims them).  A run that breaks
an invariant oracle under such a schedule is therefore a bug, never an
over-aggressive nemesis.  Known-bad schedules — used to exercise the
shrinker — are constructed explicitly, outside the envelope.

Stdlib-only and standalone-loadable (the campaign runner must work on a
supervisor host that never imports torch); the faults module is resolved
in-package when available, by path otherwise.
"""

from __future__ import annotations

import base64
import hashlib
import importlib.util
import json
import os
import sys
from typing import Dict, List, Optional, Tuple

__all__ = [
    "FAST_SITES",
    "LETHAL_MODES",
    "Draw",
    "generate_schedule",
    "generate_campaign",
    "validate_schedule",
    "lethal_count",
    "faults_for",
    "env_for",
    "schedule_digest",
    "schedule_token",
    "schedule_from_token",
    "repro_line",
    "parse_repro",
]


def _faults_mod():
    """``heat_tpu_torch.utils.faults`` in-package; spec-loaded by path when this
    file itself was spec-loaded (the federation dual-mode idiom)."""
    if __package__:
        from ..utils import faults as _f
        return _f
    # the canonical name first: a process that already loaded faults (the
    # chaos worker registers it there so the scheduler's _fire hook sees
    # it) must share that module's armed state, not a twin
    for name in ("heat_tpu_torch.utils.faults", "heat_chaos_faults"):
        if name in sys.modules:
            return sys.modules[name]
    name = "heat_chaos_faults"
    path = os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", "utils", "faults.py"
    )
    spec = importlib.util.spec_from_file_location(name, os.path.normpath(path))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


_flt = _faults_mod()

# modes whose firing takes the process (or its liveness) down — each one
# in a schedule must be covered by a supervisor restart
LETHAL_MODES = frozenset({"exit", "hang"})

# the sites the fast-tier harness workload deterministically reaches at
# least once per generation (see chaos/worker.py) — the campaign sweep
# draws from these so trip evidence is always decidable; the full tier
# (the supervised worlds of chaos/world.py) additionally exercises
# dist.init and the runtime's own firings of the same sites
FAST_SITES = (
    "io.write",
    "io.read",
    "io.fsync",
    "comm.host_fetch",
    "comm.collective",
    "proc.exit",
    "dist.init",
    "sched.dispatch",
    "sched.journal.write",
    "mem.alloc",
)


class Draw:
    """A deterministic uniform stream keyed by a string: sha256 of
    ``key|counter`` — stable across processes, platforms and
    PYTHONHASHSEED, which `random.Random` state-pickling is not required
    to be across versions.  This is the campaign's ONLY randomness."""

    def __init__(self, key: str):
        self.key = str(key)
        self.n = 0

    def unit(self) -> float:
        digest = hashlib.sha256(f"{self.key}|{self.n}".encode()).digest()
        self.n += 1
        return int.from_bytes(digest[:8], "big") / 2.0**64

    def randint(self, lo: int, hi: int) -> int:
        """Inclusive on both ends."""
        return lo + int(self.unit() * (hi - lo + 1))

    def choice(self, seq):
        return seq[int(self.unit() * len(seq))]


# per-mode trigger draw inside the survivable envelope: fail counts stay
# under the harness retry budget (4), delays stay small enough for the
# CI time budget, hang is a single firing (one watchdog trip + restart)
def _draw_value(d: Draw, mode: str, n_jobs: int):
    if mode == "fail":
        return d.randint(1, 3)
    if mode == "delay":
        return round(0.02 + 0.08 * d.unit(), 3)
    if mode == "corrupt":
        return d.randint(1, 2)
    if mode == "hang":
        return 1
    if mode == "exit":
        # fire mid-run — after the first firing, but low enough that EVERY
        # site is guaranteed to reach it (sched.dispatch fires only once
        # per batch, ~3 times in a short serve run); an exit trigger the
        # run never reaches would leave a lethal fault unfired and the
        # blame oracle with nothing to name
        return d.randint(2, 3)
    raise ValueError(f"unknown fault mode {mode!r}")


def generate_schedule(
    seed: int,
    index: int,
    *,
    modes: Tuple[str, ...] = ("train", "serve", "fed"),
    max_faults: int = 3,
    sites: Optional[Tuple[str, ...]] = None,
) -> dict:
    """Schedule ``index`` of campaign ``seed`` — a pure function of its
    arguments (schedule i is identical whatever campaign length it was
    drawn inside, so a resumed campaign re-derives the identical tail).
    """
    d = Draw(f"chaos|{int(seed)}|{int(index)}")
    catalog = {e["site"]: e for e in _flt.catalog()}
    pool = tuple(sites if sites is not None else FAST_SITES)
    workload = d.choice(tuple(modes))
    # fed runs the federation harness in one supervised process; train
    # and serve shard across 1–2 supervised ranks
    ranks = 1 if workload == "fed" else d.randint(1, 2)
    n_jobs = d.randint(6, 10)
    faults: List[dict] = []
    lethal_used = False
    for _ in range(d.randint(1, max_faults)):
        site = d.choice(pool)
        legal = tuple(catalog[site]["modes"])
        mode = d.choice(legal)
        if mode in LETHAL_MODES:
            if lethal_used:
                continue  # the envelope allows one lethal fault
            lethal_used = True
        faults.append({
            "site": site,
            "mode": mode,
            "value": _draw_value(d, mode, n_jobs),
            "rank": d.randint(0, ranks - 1),
            # benign faults of a restarted generation only make sense when
            # a generation-0 lethal fault forces that restart; generation
            # is re-pinned below once lethality is known
            "generation": 0,
        })
    if lethal_used:
        # with a restart guaranteed, benign faults ride the restarted
        # generation: a generation-0 benign fault on a non-victim rank
        # races the teardown (the supervisor SIGKILLs survivors the
        # moment the victim dies), so whether it ever fired would be
        # timing-dependent — exactly the nondeterminism a deterministic
        # campaign must not contain.  Generation 1 runs to completion,
        # so trip evidence there is always decidable.
        for f in faults:
            if f["mode"] not in LETHAL_MODES:
                f["generation"] = 1
    schedule = {
        "seed": int(seed),
        "index": int(index),
        "workload": workload,
        "ranks": ranks,
        "jobs": n_jobs,
        "faults": faults,
    }
    validate_schedule(schedule)
    return schedule


def generate_campaign(seed: int, count: int, **kw) -> List[dict]:
    return [generate_schedule(seed, i, **kw) for i in range(int(count))]


def validate_schedule(schedule: dict) -> None:
    """Reject schedules outside the catalog (the runtime would silently
    never fire a typo'd site — exactly the failure class the catalog
    exists to kill)."""
    known = _flt.catalog_sites()
    catalog = {e["site"]: e for e in _flt.catalog()}
    if schedule.get("workload") not in ("train", "serve", "fed"):
        raise ValueError(f"unknown workload {schedule.get('workload')!r}")
    for f in schedule.get("faults", ()):
        if f["site"] not in known:
            raise ValueError(f"fault site {f['site']!r} not in faults.catalog()")
        if f["mode"] not in catalog[f["site"]]["modes"]:
            raise ValueError(
                f"mode {f['mode']!r} not legal at site {f['site']!r} "
                f"(legal: {catalog[f['site']]['modes']})"
            )
        if f["mode"] not in _flt.MODES:
            raise ValueError(f"unknown fault mode {f['mode']!r}")


def lethal_count(schedule: dict) -> int:
    """Restarts this schedule forces — the restart budget the runner must
    grant (exit fires once at its trigger; hang=N wedges N generations)."""
    n = 0
    for f in schedule.get("faults", ()):
        if f["mode"] == "exit":
            n += 1
        elif f["mode"] == "hang":
            n += max(1, int(f["value"]))
    return n


def faults_for(schedule: dict, rank: int, generation: int) -> List[dict]:
    return [
        f for f in schedule.get("faults", ())
        if int(f["rank"]) == int(rank) and int(f["generation"]) == int(generation)
    ]


def env_for(schedule: dict, rank: int, generation: int) -> str:
    """The ``HEAT_TPU_FAULTS`` string arming this schedule's faults for
    one ``(rank, generation)`` — the existing env plumbing is the ONE
    arming mechanism; the engine never reaches into a worker."""
    specs: Dict[str, object] = {}
    for f in faults_for(schedule, rank, generation):
        spec = specs.get(f["site"])
        if spec is None:
            spec = _flt.FaultSpec(f["site"])
            specs[f["site"]] = spec
        setattr(spec, f["mode"], f["value"])
    return _flt.render_spec(specs)


# ---------------------------------------------------------------------- #
# identity, reproducer lines
# ---------------------------------------------------------------------- #
def _canonical(schedule: dict) -> str:
    return json.dumps(schedule, sort_keys=True, separators=(",", ":"))


def schedule_digest(schedule: dict) -> str:
    return hashlib.sha256(_canonical(schedule).encode()).hexdigest()[:16]


def schedule_token(schedule: dict) -> str:
    """URL-safe, grep-safe, whitespace-free encoding of the full schedule
    — what rides a ``CHAOS-REPRO`` line and what ``chaoscamp.py --replay``
    accepts verbatim."""
    return base64.urlsafe_b64encode(_canonical(schedule).encode()).decode()


def schedule_from_token(token: str) -> dict:
    schedule = json.loads(base64.urlsafe_b64decode(token.encode()))
    validate_schedule(schedule)
    return schedule


def repro_line(schedule: dict, failure: str) -> str:
    """The greppable minimal-reproducer line: identity, the failed
    oracle, the schedule itself, and the ready-to-run arming strings
    (one ``rank/gen`` clause per armed pair — for a single-rank
    generation-0 schedule the env is directly pasteable)."""
    envs = []
    for r in range(int(schedule["ranks"])):
        for g in range(0, lethal_count(schedule) + 1):
            s = env_for(schedule, r, g)
            if s:
                envs.append(f"rank{r}/gen{g}:HEAT_TPU_FAULTS={s}")
    return (
        f"CHAOS-REPRO seed={schedule['seed']} idx={schedule['index']} "
        f"digest={schedule_digest(schedule)} fail={failure} "
        f"schedule={schedule_token(schedule)} "
        f"env=[{' '.join(envs)}] "
        f"replay='python heat_tpu_torch/chaos/campaign.py --replay {schedule_token(schedule)}'"
    )


def parse_repro(line: str) -> dict:
    """Recover the schedule from a ``CHAOS-REPRO`` line (grep a CI log,
    paste the line, replay locally)."""
    for part in line.split():
        if part.startswith("schedule="):
            return schedule_from_token(part[len("schedule="):])
    raise ValueError(f"no schedule= field in {line!r}")
