"""Invariant oracles: what must hold after EVERY chaos schedule.

Each oracle is a pure function over the run's durable evidence — the
journals (replayed post-hoc), the per-rank execution logs, the trips
files, the per-generation reports, the scratch directories, and the
supervisor's result dict.  Nothing here inspects live state: if an
invariant can't be proven from what survived the crashes, the runtime's
recovery story has a hole and the oracle should fail.

The suite (the table in design.md "Chaos engineering" mirrors this):

==================  ====================================================
oracle              invariant (owing subsystem)
==================  ====================================================
workload_completed  the supervised run converged within its restart
                    budget and every rank attested (supervisor)
no_lost_jobs        every accepted job reached a terminal state —
                    ``lost=0`` from the journal replay (scheduler /
                    federation journals + recovery)
replay_determinism  replaying a journal is a pure function of the file:
                    two independent replays agree, and the worker's
                    in-process summary equals the post-hoc one
exactly_once        a job journaled DONE never executes again in a later
                    generation, and every execution has a same-epoch
                    DISPATCHED record (scheduler ``_done_ids`` + replay)
counters_reconcile  ``offered = accepted + shed`` and the scheduler's
                    own ``counters_reconcile()`` held in every
                    generation's process (metrics plane)
trace_continuity    every record of one job carries one trace id across
                    requeues and generations (tracing)
mem_drained         zero live transient bytes at every clean exit — the
                    scratch dir is empty and the final beacon's
                    ``mem_live`` is 0 (memory ledger discipline)
blame               the run NAMES what was injected: lethal faults
                    appear in the supervisor's failure strings as the
                    victim rank in the victim generation (post-mortem
                    verdicts, when they name a rank, agree), and benign
                    faults left trip evidence at the armed site — a
                    survived-but-undiagnosed fault is a DIAGNOSIS
                    failure (postmortem / failure attribution)
==================  ====================================================
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
import sys
from typing import Dict, List, Optional

__all__ = ["run_oracles", "failing", "ORACLES"]

_HERE = os.path.dirname(os.path.abspath(__file__))
_PKG = os.path.normpath(os.path.join(_HERE, ".."))  # the heat_tpu_torch package

ORACLES = (
    "workload_completed",
    "no_lost_jobs",
    "replay_determinism",
    "exactly_once",
    "counters_reconcile",
    "trace_continuity",
    "mem_drained",
    "blame",
)


def _load(name: str, relpath: str):
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(_PKG, relpath)
    )
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _sched():
    for name in ("heat_tpu_torch.parallel.scheduler", "heat_federation_scheduler"):
        if name in sys.modules:
            return sys.modules[name]
    if __package__:
        from ..parallel import scheduler as s
        return s
    return _load(
        "heat_federation_scheduler",
        os.path.join("parallel", "scheduler.py"),
    )


def _fed():
    if "heat_tpu_torch.parallel.federation" in sys.modules:
        return sys.modules["heat_tpu_torch.parallel.federation"]
    if __package__:
        from ..parallel import federation as f
        return f
    return _load(
        "heat_chaos_federation",
        os.path.join("parallel", "federation.py"),
    )


def _sup_mod():
    for name in ("heat_tpu_torch.parallel.supervisor", "heat_chaos_supervisor"):
        if name in sys.modules:
            return sys.modules[name]
    if __package__:
        from ..parallel import supervisor as s
        return s
    return _load(
        "heat_chaos_supervisor",
        os.path.join("parallel", "supervisor.py"),
    )


def _pm():
    for name in ("heat_chaos_postmortem",):
        if name in sys.modules:
            return sys.modules[name]
    return _load(
        "heat_chaos_postmortem", os.path.join("analysis", "postmortem.py")
    )


# ---------------------------------------------------------------------- #
# evidence collection
# ---------------------------------------------------------------------- #
class Evidence:
    """Everything the oracles read, gathered once per run."""

    def __init__(self, run_dir: str, schedule: dict, sup: dict):
        self.dir = run_dir
        self.schedule = schedule
        self.sup = sup  # SupervisorResult.report() dict
        self.workload = schedule["workload"]
        self.ranks = int(schedule["ranks"])
        sched = _sched()
        self.journals: Dict[str, dict] = {}  # path -> replay
        self.summaries: Dict[str, dict] = {}
        if self.workload == "fed":
            fed = _fed()
            p = os.path.join(run_dir, "fed.jsonl")
            if os.path.exists(p):
                self.journals[p] = fed.replay_federation(p)
                self.summaries[p] = fed.fed_summary(self.journals[p])
            for w in ("w0", "w1"):
                wp = os.path.join(run_dir, f"fed_{w}.jsonl")
                if os.path.exists(wp):
                    self.journals[wp] = sched.replay_journal(wp)
                    self.summaries[wp] = sched.jobs_summary(self.journals[wp])
        else:
            for r in range(self.ranks):
                p = os.path.join(run_dir, f"journal_rank{r}.jsonl")
                if os.path.exists(p):
                    self.journals[p] = sched.replay_journal(p)
                    self.summaries[p] = sched.jobs_summary(self.journals[p])
        # executions: list of (epoch, job_id) per rank, journal-ordered
        self.execs: Dict[int, List] = {}
        for r in range(self.ranks):
            path = os.path.join(run_dir, f"exec_rank{r}.log")
            rows = []
            if os.path.exists(path):
                with open(path) as fh:
                    for line in fh:
                        parts = line.split()
                        if len(parts) == 2:
                            rows.append((int(parts[0]), parts[1]))
            self.execs[r] = rows
        # trips: {f"e{epoch}:{site}": count} per rank
        self.trips: Dict[int, dict] = {}
        for r in range(self.ranks):
            path = os.path.join(run_dir, f"trips_rank{r}.json")
            try:
                with open(path) as fh:
                    self.trips[r] = json.load(fh)
            except (OSError, ValueError):
                self.trips[r] = {}
        # per-generation reports (clean exits only — a killed generation
        # writes none, by design)
        self.reports: Dict[tuple, dict] = {}
        for name in sorted(os.listdir(run_dir)):
            m = re.match(r"report_rank(\d+)_epoch(\d+)\.json$", name)
            if m:
                try:
                    with open(os.path.join(run_dir, name)) as fh:
                        self.reports[(int(m.group(1)), int(m.group(2)))] = (
                            json.load(fh)
                        )
                except (OSError, ValueError):
                    pass


# ---------------------------------------------------------------------- #
# the oracles
# ---------------------------------------------------------------------- #
def _o_workload_completed(ev: Evidence) -> Optional[str]:
    if not ev.sup.get("ok"):
        return (
            f"supervisor gave up: restarts={ev.sup.get('restarts')} "
            f"failures={ev.sup.get('failures')}"
        )
    final = ev.sup.get("generations", 1) - 1
    for r in range(ev.ranks):
        if (r, final) not in ev.reports:
            return f"rank {r} wrote no final report for generation {final}"
    if not ev.journals:
        return "no journal found — nothing to audit"
    return None


def _o_no_lost_jobs(ev: Evidence) -> Optional[str]:
    sched = _sched()
    # in fed runs the FEDERATION journal is the ground truth for job
    # fates: a job left non-terminal in a world journal because the
    # restarted federator requeued it and reassigned it to the OTHER
    # world is accounted there, not lost.  Only a job non-terminal at
    # BOTH levels fell through the recovery story.
    fed_states = {}
    if ev.workload == "fed":
        fed_replay = ev.journals.get(os.path.join(ev.dir, "fed.jsonl"))
        if fed_replay:
            fed_states = {
                jid: v.get("state") for jid, v in fed_replay["jobs"].items()
            }
    terminal = (sched.DONE, sched.FAILED, sched.SHED)
    for path, summary in sorted(ev.summaries.items()):
        if summary.get("lost", 0) == 0:
            continue
        name = os.path.basename(path)
        if ev.workload == "fed" and name.startswith("fed_w"):
            replay = ev.journals[path]
            orphans = sorted(
                jid for jid, v in replay["jobs"].items()
                if v.get("state") not in terminal
                and fed_states.get(jid) not in terminal
            )
            if orphans:
                return (
                    f"{name}: {len(orphans)} job(s) non-terminal in the "
                    f"world journal AND unaccounted by the federation: "
                    f"{orphans[:5]}"
                )
            continue
        return f"{name}: lost={summary['lost']}"
    return None


def _o_replay_determinism(ev: Evidence) -> Optional[str]:
    sched = _sched()
    fed = _fed() if ev.workload == "fed" else None
    for path, replay in sorted(ev.journals.items()):
        # replay twice: identical views (pure function of the file)
        again = (
            fed.replay_federation(path)
            if fed is not None and os.path.basename(path) == "fed.jsonl"
            else sched.replay_journal(path)
        )
        if again["jobs"] != replay["jobs"] or again["torn"] != replay["torn"]:
            return f"{os.path.basename(path)}: two replays disagree"
    # the worker's in-process summary (written pre-exit) must equal the
    # post-hoc derivation — replay is the one source of truth
    final = ev.sup.get("generations", 1) - 1
    for r in range(ev.ranks):
        rep = ev.reports.get((r, final))
        if not rep or "summary" not in rep:
            continue
        if ev.workload == "fed":
            path = os.path.join(ev.dir, "fed.jsonl")
        else:
            path = os.path.join(ev.dir, f"journal_rank{r}.jsonl")
        post = ev.summaries.get(path)
        if post is not None and rep["summary"] != post:
            return (
                f"rank {r}: in-process summary {rep['summary']} != "
                f"post-hoc replay {post}"
            )
    return None


def _o_exactly_once(ev: Evidence) -> Optional[str]:
    sched = _sched()
    # merge each scheduler journal's execution-accountability view (the
    # fed meta-journal carries assignments, not dispatches — skip it)
    witness: Dict[str, dict] = {}
    for path, rep in sorted(ev.journals.items()):
        if os.path.basename(path) == "fed.jsonl":
            continue
        for jid, w in sched.execution_witness(rep).items():
            m = witness.setdefault(
                jid, {"dispatch_epochs": set(), "first_done_epoch": None}
            )
            m["dispatch_epochs"].update(w["dispatch_epochs"])
            d = w["first_done_epoch"]
            if d is not None and (
                m["first_done_epoch"] is None or d < m["first_done_epoch"]
            ):
                m["first_done_epoch"] = d
    for r, rows in sorted(ev.execs.items()):
        for epoch, jid in rows:
            w = witness.get(jid)
            if w is None or epoch not in w["dispatch_epochs"]:
                return (
                    f"rank {r} executed {jid} in generation {epoch} with no "
                    f"same-generation DISPATCHED record — an unjournaled "
                    f"execution"
                )
            first_done = w["first_done_epoch"]
            if first_done is not None and epoch > first_done:
                return (
                    f"{jid} was journaled DONE in generation {first_done} "
                    f"but executed again in generation {epoch}"
                )
    return None


def _o_counters_reconcile(ev: Evidence) -> Optional[str]:
    if not ev.reports:
        return "no per-generation report to audit"
    for (r, e), rep in sorted(ev.reports.items()):
        c = rep.get("counters", {})
        for prefix in (("sched",) if ev.workload != "fed" else ("sched", "fed")):
            offered = c.get(f"{prefix}.offered", 0)
            accepted = c.get(f"{prefix}.accepted", 0)
            shed = c.get(f"{prefix}.shed", 0)
            if offered != accepted + shed:
                return (
                    f"rank {r} gen {e}: {prefix}.offered={offered} != "
                    f"accepted={accepted} + shed={shed}"
                )
        if rep.get("reconciled") is False:
            return f"rank {r} gen {e}: scheduler counters_reconcile() was False"
    return None


def _o_trace_continuity(ev: Evidence) -> Optional[str]:
    sched = _sched()
    for path, replay in sorted(ev.journals.items()):
        audit = sched.trace_continuity(replay)
        if not audit.get("ok", True):
            return (
                f"{os.path.basename(path)}: trace chain severed — "
                f"{audit.get('violations')}"
            )
    return None


def _o_mem_drained(ev: Evidence) -> Optional[str]:
    for r in range(ev.ranks):
        scratch = os.path.join(ev.dir, f"scratch_rank{r}")
        leftovers = sorted(os.listdir(scratch)) if os.path.isdir(scratch) else []
        if leftovers:
            return f"rank {r} leaked transients at exit: {leftovers[:5]}"
        hb = os.path.join(ev.dir, "hb", f"rank{r}.json")
        try:
            with open(hb) as fh:
                beacon = json.load(fh)
            if beacon.get("mem_live"):
                return f"rank {r} final beacon mem_live={beacon['mem_live']}"
        except (OSError, ValueError):
            pass
    return None


def _o_blame(ev: Evidence) -> Optional[str]:
    sched_mod = _sched()
    sup_mod = _sup_mod()
    pm_mod = _pm()
    # the supervisor's failure strings, parsed structurally (the
    # supervisor module owns the string shapes AND the parser — the
    # oracle never regexes them itself)
    parsed = [
        p for p in (
            sup_mod.parse_failure(s) for s in ev.sup.get("failures", ())
        ) if p is not None
    ]
    lethal = [f for f in ev.schedule.get("faults", ())
              if f["mode"] in ("exit", "hang")]
    benign = [f for f in ev.schedule.get("faults", ())
              if f["mode"] not in ("exit", "hang")]
    for f in lethal:
        gen, rank = int(f["generation"]), int(f["rank"])
        want = "died" if f["mode"] == "exit" else "stale"
        named = any(
            p["epoch"] == gen and p["rank"] == rank and p["kind"] == want
            and (want != "died" or p.get("code") == -9)
            for p in parsed
        )
        if not named:
            return (
                f"injected {f['mode']} at {f['site']} "
                f"(rank {rank}, gen {gen}) but no supervisor failure names "
                f"it as kind={want}: {ev.sup.get('failures')}"
            )
        # diagnosis agreement: a post-mortem verdict that convicts a rank
        # for this generation must convict the victim
        for pm in ev.sup.get("postmortems", ()):
            if pm.get("epoch") != gen:
                continue
            convicted = pm_mod.verdict_rank(pm)
            if convicted is not None and convicted != rank:
                return (
                    f"post-mortem for gen {gen} blamed rank {convicted}, "
                    f"but the injected victim was rank {rank}"
                )
    for f in benign:
        gen, rank, site = int(f["generation"]), int(f["rank"]), f["site"]
        count = ev.trips.get(rank, {}).get(f"e{gen}:{site}", 0)
        if count < 1:
            return (
                f"armed {site}:{f['mode']}={f['value']} on rank {rank} "
                f"gen {gen} but the site never fired there — the schedule "
                f"tested nothing (runtime twin of HT113)"
            )
    # injected benign faults must also not have broken attribution: any
    # FAILED job's reason must be a NAMED outcome, never a bare crash
    for path, replay in sorted(ev.journals.items()):
        if os.path.basename(path) == "fed.jsonl":
            continue
        for jid, view in sorted(replay["jobs"].items()):
            if view.get("state") == sched_mod.FAILED and not view.get("reason"):
                return f"{jid} FAILED with no journaled reason"
    return None


_IMPL = {
    "workload_completed": _o_workload_completed,
    "no_lost_jobs": _o_no_lost_jobs,
    "replay_determinism": _o_replay_determinism,
    "exactly_once": _o_exactly_once,
    "counters_reconcile": _o_counters_reconcile,
    "trace_continuity": _o_trace_continuity,
    "mem_drained": _o_mem_drained,
    "blame": _o_blame,
}


def run_oracles(run_dir: str, schedule: dict, sup: dict) -> List[dict]:
    """Run the full suite over one finished run; returns one
    ``{"oracle", "ok", "detail"}`` row per invariant (detail '' when it
    held).  An oracle that cannot even gather its evidence reports that
    as its failure — a chaos engine must never crash on the wreckage it
    exists to audit."""
    ev = Evidence(run_dir, schedule, sup)
    out = []
    for name in ORACLES:
        try:
            detail = _IMPL[name](ev)
        except Exception as e:
            detail = f"oracle crashed on evidence: {type(e).__name__}: {e}"
        out.append({"oracle": name, "ok": detail is None,
                    "detail": detail or ""})
    return out


def failing(results: List[dict]) -> List[str]:
    return [r["oracle"] for r in results if not r["ok"]]
