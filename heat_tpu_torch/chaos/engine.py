"""The chaos campaign engine: run schedules under the real Supervisor,
judge them with the invariant oracles, journal the verdicts.

One *run* = one schedule armed (via ``HEAT_TPU_FAULTS``, computed per
``(rank, generation)`` by :func:`schedule.env_for`) against the fast-tier
harness workload (``chaos/worker.py``) supervised by the REAL
``parallel.supervisor.Supervisor`` — real process death, real heartbeat
staleness detection, real restart-with-resume, real journal recovery.
After the supervisor returns, the oracle suite audits the run directory
and the verdict (which oracles failed, if any) is appended to a
crash-durable campaign journal.

One *campaign* = ``count`` schedules drawn from ``(seed, 0..count-1)``.
The journal header pins the seed; records are keyed by index, so a
killed campaign resumes by replaying the journal and skipping finished
indices — re-running any index reproduces the identical schedule and,
modulo wall-clock noise in timing fields the verdict deliberately
excludes, the identical verdict row.

Stdlib-only, standalone-loadable, never imports torch.
"""

from __future__ import annotations

import importlib.util
import json
import os
import shutil
import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional

__all__ = [
    "run_schedule",
    "CampaignJournal",
    "run_campaign",
    "verdict_table",
    "VERDICT_FIELDS",
]

_HERE = os.path.dirname(os.path.abspath(__file__))
_PKG = os.path.normpath(os.path.join(_HERE, ".."))  # the heat_tpu_torch package
_WORKER = os.path.join(_HERE, "worker.py")


def _load(name: str, relpath: str):
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(_PKG, relpath)
    )
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


if __package__:
    from . import oracles as _oracles
    from . import schedule as _schedule
    from ..parallel import supervisor as _sup_mod
else:  # spec-loaded standalone (heat_tpu_torch/chaos/campaign.py)
    _schedule = _load("heat_chaos_schedule", "chaos/schedule.py")
    _oracles = _load("heat_chaos_oracles", "chaos/oracles.py")
    _sup_mod = _load("heat_chaos_supervisor", "parallel/supervisor.py")


# ---------------------------------------------------------------------- #
# one schedule -> one supervised run -> one oracle verdict
# ---------------------------------------------------------------------- #
# the verdict row is DETERMINISTIC: same (seed, index) -> byte-identical
# row on any two runs.  Timing, pids, paths and other wall-clock noise
# are deliberately excluded — two same-seed campaigns must produce
# identical verdict tables (the acceptance bar for the whole engine).
VERDICT_FIELDS = (
    "index", "seed", "digest", "workload", "ranks", "jobs",
    "faults", "ok", "fails",
)

# fast-tier supervision envelope: the harness beats after every job, so
# 2.5 s of silence IS a wedge (a hang fault parks the rank forever); the
# generation deadline is a backstop against pathologies the heartbeat
# cannot see, sized generously above the worst legal schedule (delays
# are capped at ~0.1 s/firing by the generator's envelope).
_HB_TIMEOUT = 2.5
_GEN_DEADLINE = 90.0


def _fault_tokens(schedule: dict) -> List[str]:
    return [
        f"{f['site']}:{f['mode']}={f['value']}@r{f['rank']}g{f['generation']}"
        for f in schedule.get("faults", ())
    ]


def run_schedule(
    schedule: dict,
    run_dir: str,
    *,
    keep: bool = False,
    python: Optional[str] = None,
) -> dict:
    """Execute one schedule under the Supervisor and judge it.

    Returns the verdict row: ``ok`` is True iff every oracle passed;
    ``fails`` lists the failing oracle names; ``oracles`` carries each
    oracle's detail string (True, or the failure explanation).  The run
    directory (journals, per-rank logs, flight rings, reports) survives
    for failing runs — it IS the evidence — and is deleted for passing
    runs unless ``keep``.
    """
    _schedule.validate_schedule(schedule)
    # the run dir is this run's scratch: stale evidence from a previous
    # run of the same schedule (a kept replay dir, a re-run index) would
    # feed the recovery path and the oracles someone ELSE's journals —
    # every run starts from nothing, or replays aren't independent
    shutil.rmtree(run_dir, ignore_errors=True)
    os.makedirs(run_dir, exist_ok=True)
    hb_dir = os.path.join(run_dir, "hb")
    fr_dir = os.path.join(run_dir, "fr")
    exe = python or sys.executable

    def spawn(rank: int, epoch: int, port: int) -> subprocess.Popen:
        env = {
            k: v for k, v in os.environ.items()
            if k != "HEAT_TPU_FAULTS" and not k.startswith("CHAOS_")
        }
        env["CHAOS_DIR"] = run_dir
        env["CHAOS_WORKLOAD"] = schedule["workload"]
        env["CHAOS_JOBS"] = str(schedule["jobs"])
        env["HEAT_TPU_RESTART_EPOCH"] = str(epoch)
        env["PYTHONUNBUFFERED"] = "1"
        armed = _schedule.env_for(schedule, rank, epoch)
        if armed:
            env["HEAT_TPU_FAULTS"] = armed
        log = open(
            os.path.join(run_dir, f"log_rank{rank}_epoch{epoch}.txt"), "ab"
        )
        try:
            return subprocess.Popen(
                [exe, _WORKER, str(rank)],
                env=env, cwd=run_dir,
                stdout=log, stderr=subprocess.STDOUT,
            )
        finally:
            log.close()  # the child holds its own copy of the fd

    if schedule["workload"] == "fed":
        job_journal = os.path.join(run_dir, "fed.jsonl")
    else:
        job_journal = os.path.join(run_dir, "journal_rank0.jsonl")

    sup = _sup_mod.Supervisor(
        spawn,
        schedule["ranks"],
        heartbeat_dir=hb_dir,
        heartbeat_timeout=_HB_TIMEOUT,
        restart_budget=_schedule.lethal_count(schedule),
        generation_deadline=_GEN_DEADLINE,
        poll_interval=0.05,
        grace=0.5,
        flightrec_dir=fr_dir,
        job_journal=job_journal,
    )
    result = sup.run()
    report = result.report()
    oracle_results = _oracles.run_oracles(run_dir, schedule, report)
    fails = _oracles.failing(oracle_results)
    verdict = {
        "index": schedule["index"],
        "seed": schedule["seed"],
        "digest": _schedule.schedule_digest(schedule),
        "workload": schedule["workload"],
        "ranks": schedule["ranks"],
        "jobs": schedule["jobs"],
        "faults": _fault_tokens(schedule),
        "ok": not fails,
        "fails": fails,
        "oracles": {
            r["oracle"]: (True if r["ok"] else r["detail"])
            for r in oracle_results
        },
        "sup": {
            "ok": report.get("ok"),
            "restarts": report.get("restarts"),
            "generations": report.get("generations"),
            "failures": report.get("failures"),
        },
        "run_dir": run_dir,
    }
    if not fails and not keep:
        shutil.rmtree(run_dir, ignore_errors=True)
        verdict["run_dir"] = None
    return verdict


# ---------------------------------------------------------------------- #
# the campaign journal: crash-durable, resumable by index
# ---------------------------------------------------------------------- #
class CampaignJournal:
    """Append-only JSONL verdict log with a tmp+rename header.

    The header pins the campaign identity ``(seed, count, tier)``; every
    verdict and reproducer is one flushed line.  ``resume()`` replays an
    existing journal — refusing a seed mismatch, because appending
    verdicts of a DIFFERENT campaign to this journal would poison the
    determinism audit — and returns the set of finished indices.
    """

    SCHEMA = 1

    def __init__(self, path: str, *, seed: int, count: int, tier: str):
        self.path = path
        self.meta = {
            "type": "meta", "schema": self.SCHEMA,
            "seed": int(seed), "count": int(count), "tier": str(tier),
        }
        if not os.path.exists(path):
            tmp = path + ".tmp"
            with open(tmp, "w") as fh:
                fh.write(json.dumps(self.meta, sort_keys=True) + "\n")
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, path)
        self._fh = open(path, "a")

    def append(self, record: dict) -> None:
        self._fh.write(json.dumps(record, sort_keys=True) + "\n")
        self._fh.flush()

    def close(self) -> None:
        self._fh.close()

    @staticmethod
    def replay(path: str) -> dict:
        """``{"meta": header, "verdicts": {index: row}, "repros": [...]}``
        — last verdict per index wins; a torn trailing line (the crash
        the tmp+rename header and line-granular appends are armor
        against) is skipped, not fatal."""
        meta, verdicts, repros = None, {}, []
        with open(path) as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue  # torn tail
                if rec.get("type") == "meta":
                    meta = rec
                elif rec.get("type") == "verdict":
                    verdicts[int(rec["index"])] = rec
                elif rec.get("type") == "repro":
                    repros.append(rec)
        return {"meta": meta, "verdicts": verdicts, "repros": repros}

    def resume(self) -> Dict[int, dict]:
        state = self.replay(self.path)
        meta = state["meta"]
        if meta is None:
            raise ValueError(f"{self.path}: no journal header")
        for key in ("seed", "tier"):
            if meta.get(key) != self.meta[key]:
                raise ValueError(
                    f"{self.path}: journal is campaign "
                    f"{key}={meta.get(key)!r}, not {self.meta[key]!r} — "
                    "refusing to mix campaigns in one journal"
                )
        return state["verdicts"]


# ---------------------------------------------------------------------- #
# the campaign runner
# ---------------------------------------------------------------------- #
def run_campaign(
    seed: int,
    count: int,
    out_dir: str,
    *,
    shrink_failures: bool = True,
    keep: bool = False,
    resume: bool = False,
    sites: Optional[tuple] = None,
    modes: tuple = ("train", "serve", "fed"),
    log: Callable[[str], None] = lambda s: print(s, flush=True),
) -> dict:
    """Sweep schedules ``(seed, 0..count-1)`` through :func:`run_schedule`.

    Verdicts land in ``<out_dir>/campaign.jsonl`` as they finish; with
    ``resume`` an existing journal's finished indices are skipped (the
    generator re-derives identical schedules for the rest).  Every
    failing schedule is auto-shrunk to its minimal reproducer and the
    greppable ``CHAOS-REPRO`` line is both printed and journaled.

    Returns ``{"rows": [verdict...], "failures": [...], "repro_lines":
    [...], "table": str}``.
    """
    os.makedirs(out_dir, exist_ok=True)
    journal = CampaignJournal(
        os.path.join(out_dir, "campaign.jsonl"),
        seed=seed, count=count, tier="fast",
    )
    done = journal.resume() if resume else {}
    rows: List[dict] = []
    repro_lines: List[str] = []
    t0 = time.monotonic()
    try:
        for i in range(int(count)):
            if i in done:
                rows.append(done[i])
                continue
            sched = _schedule.generate_schedule(
                seed, i, modes=modes, sites=sites
            )
            run_dir = os.path.join(out_dir, f"run{i:04d}")
            verdict = run_schedule(sched, run_dir, keep=keep)
            verdict["type"] = "verdict"
            journal.append(verdict)
            rows.append(verdict)
            status = "ok" if verdict["ok"] else f"FAIL({','.join(verdict['fails'])})"
            log(
                f"CHAOS-RUN idx={i} workload={sched['workload']} "
                f"faults=[{' '.join(_fault_tokens(sched))}] {status}"
            )
            if not verdict["ok"] and shrink_failures:
                shrink = _shrink_mod()
                minimal, fail = shrink.shrink(
                    sched,
                    lambda s, _dir=out_dir, _i=i: _shrink_probe(s, _dir, _i),
                    log=log,
                )
                line = _schedule.repro_line(minimal, fail)
                log(line)
                repro_lines.append(line)
                journal.append({
                    "type": "repro", "index": i, "fail": fail, "line": line,
                    "schedule": minimal,
                })
    finally:
        journal.close()
    failures = [r for r in rows if not r.get("ok")]
    return {
        "rows": rows,
        "failures": failures,
        "repro_lines": repro_lines,
        "table": verdict_table(rows),
        "elapsed_s": round(time.monotonic() - t0, 1),
    }


def _shrink_mod():
    if __package__:
        from . import shrink as s
        return s
    return _load("heat_chaos_shrink", "chaos/shrink.py")


_probe_n = [0]


def _shrink_probe(sched: dict, out_dir: str, index: int) -> List[str]:
    """The shrinker's run function: execute a candidate schedule in a
    scratch dir, return the failing oracle names, clean up regardless —
    shrink probes are evidence-gathering, not evidence."""
    _probe_n[0] += 1
    d = os.path.join(out_dir, f"shrink{index:04d}_{_probe_n[0]:03d}")
    try:
        v = run_schedule(sched, d, keep=False)
        return list(v["fails"])
    finally:
        shutil.rmtree(d, ignore_errors=True)


# ---------------------------------------------------------------------- #
# the verdict table
# ---------------------------------------------------------------------- #
def verdict_table(rows: List[dict]) -> str:
    """Deterministic fixed-order text table — two same-seed campaigns
    must render byte-identical tables (no timing, no paths)."""
    header = ("idx", "workload", "r", "jobs", "faults", "verdict")
    body = []
    for r in sorted(rows, key=lambda r: int(r["index"])):
        body.append((
            str(r["index"]),
            str(r["workload"]),
            str(r["ranks"]),
            str(r["jobs"]),
            " ".join(r.get("faults", ())) or "-",
            "ok" if r.get("ok") else "FAIL:" + ",".join(r.get("fails", ())),
        ))
    widths = [
        max(len(header[c]), *(len(row[c]) for row in body)) if body
        else len(header[c])
        for c in range(len(header))
    ]
    lines = [
        "  ".join(h.ljust(w) for h, w in zip(header, widths)).rstrip(),
        "  ".join("-" * w for w in widths),
    ]
    for row in body:
        lines.append(
            "  ".join(v.ljust(w) for v, w in zip(row, widths)).rstrip()
        )
    n_ok = sum(1 for r in rows if r.get("ok"))
    lines.append(f"CHAOS-CAMPAIGN schedules={len(rows)} ok={n_ok} "
                 f"fail={len(rows) - n_ok}")
    return "\n".join(lines)
