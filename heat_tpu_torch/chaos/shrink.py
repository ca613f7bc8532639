"""Auto-shrinking of failing fault schedules to minimal reproducers.

Greedy delta-debugging over a fixed candidate order — fully
deterministic, no randomness anywhere: (1) drop each fault in turn (a
1-fault schedule is already positionally minimal); (2) lower every
trigger to its floor (fail→1, corrupt→1, exit→2, hang→1, delay→0.02);
(3) collapse to one rank, re-pinning fault victims to rank 0; (4) shrink
the job count to the generator's floor.  A candidate is accepted iff the
run STILL fails **the same oracle** — failing differently is a different
bug, and chasing it would make the reproducer lie about what it
reproduces.  The accepted minimum is re-confirmed twice before it is
allowed to call itself a reproducer (a flaky minimum is worse than a fat
one).

The output rides a ``CHAOS-REPRO`` line (see :func:`schedule.repro_line`)
with the ready-to-run ``HEAT_TPU_FAULTS`` strings inline.
"""

from __future__ import annotations

import copy
import importlib.util
import os
import sys
from typing import Callable, List, Optional, Tuple

__all__ = ["shrink", "candidates"]


def _schedule_mod():
    if __package__:
        from . import schedule as s
        return s
    for name in ("heat_chaos_schedule",):
        if name in sys.modules:
            return sys.modules[name]
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "schedule.py")
    spec = importlib.util.spec_from_file_location("heat_chaos_schedule", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


# trigger floors per mode: the smallest value that still *means* the
# fault (0 firings would delete it, which step (1) already tries);
# exit's floor is 2 because trigger 1 kills the very first firing —
# before the workload has any state worth recovering, a strictly easier
# and therefore less faithful reproduction
_FLOORS = {"fail": 1, "corrupt": 1, "exit": 2, "hang": 1}
_DELAY_FLOOR = 0.02
_JOBS_FLOOR = 6


def candidates(schedule: dict) -> List[Tuple[str, dict]]:
    """The fixed-order shrink candidates for one step: each is a
    ``(description, schedule)`` strictly simpler than the input."""
    out: List[Tuple[str, dict]] = []
    faults = schedule.get("faults", ())
    # (1) drop each fault
    if len(faults) > 1:
        for i, f in enumerate(faults):
            c = copy.deepcopy(schedule)
            del c["faults"][i]
            out.append((f"drop {f['site']}:{f['mode']}", c))
    # (2) lower each trigger to its floor
    for i, f in enumerate(faults):
        floor = _DELAY_FLOOR if f["mode"] == "delay" else _FLOORS.get(f["mode"])
        if floor is not None and f["value"] > floor:
            c = copy.deepcopy(schedule)
            c["faults"][i]["value"] = floor
            out.append((f"floor {f['site']}:{f['mode']}={floor}", c))
    # (3) collapse to one rank (victims re-pinned to the survivor)
    if schedule.get("ranks", 1) > 1:
        c = copy.deepcopy(schedule)
        c["ranks"] = 1
        for f in c["faults"]:
            f["rank"] = 0
        out.append(("ranks->1", c))
    # (4) fewer jobs
    if schedule.get("jobs", _JOBS_FLOOR) > _JOBS_FLOOR:
        c = copy.deepcopy(schedule)
        c["jobs"] = _JOBS_FLOOR
        out.append((f"jobs->{_JOBS_FLOOR}", c))
    return out


def shrink(
    schedule: dict,
    run_fn: Callable[[dict], List[str]],
    *,
    confirm: int = 2,
    max_probes: int = 40,
    log: Callable[[str], None] = lambda s: None,
) -> Tuple[dict, str]:
    """Minimize ``schedule`` while ``run_fn`` keeps reporting the same
    first failing oracle.

    ``run_fn(schedule) -> [failing oracle names]`` (empty = run passed).
    Returns ``(minimal_schedule, failing_oracle)``; the minimum has been
    re-confirmed ``confirm`` extra times.  If the ORIGINAL schedule does
    not fail under ``run_fn`` (a flake the campaign caught but the probe
    cannot reproduce), ValueError — a reproducer that does not reproduce
    must never be printed.
    """
    sched_mod = _schedule_mod()
    probes = 0

    def probe(s: dict) -> List[str]:
        nonlocal probes
        probes += 1
        return run_fn(s)

    fails = probe(schedule)
    if not fails:
        raise ValueError(
            "schedule does not fail under the probe — refusing to emit a "
            "non-reproducing reproducer"
        )
    target = fails[0]
    current = copy.deepcopy(schedule)
    improved = True
    while improved and probes < max_probes:
        improved = False
        for desc, cand in candidates(current):
            if probes >= max_probes:
                break
            sched_mod.validate_schedule(cand)
            got = probe(cand)
            if got and got[0] == target:
                log(f"CHAOS-SHRINK accept {desc} (still fails {target})")
                current = cand
                improved = True
                break  # restart candidate enumeration from the new minimum
    for _ in range(int(confirm)):
        got = probe(current)
        if not got or got[0] != target:
            raise ValueError(
                f"shrunk schedule is flaky: expected {target}, got {got} on "
                "re-confirmation — keeping it would print a lying reproducer"
            )
    log(
        f"CHAOS-SHRINK minimal faults={len(current.get('faults', ()))} "
        f"probes={probes} fail={target}"
    )
    return current, target
