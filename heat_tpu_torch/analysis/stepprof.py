"""Step-time breakdown: compute vs comm-wait vs host-sync vs idle, per step.

    python heat_tpu_torch/analysis/stepprof.py DIR_OR_FILE... [--steps NAME,NAME...]
                               [--json OUT] [--per-step N]

The topology-aware compute/comm-overlap work (ROADMAP; "The Big Send-off",
arXiv 2504.18658, frames collective cost as THE measurable dominant term
at pod scale) needs a measured baseline before it can claim a win: how
much of each training/serving step is computation, how much is the host
*blocked* on collectives, how much is device→host synchronization, and
how much is unattributed idle.  This tool decomposes exactly that from
the telemetry span export (``rank*.jsonl``, ``telemetry.flush``):

- a **step** is any span whose name is in ``--steps`` (default:
  ``daso.step``, ``optim.step``, ``nn.train_step``, ``sched.job``);
- a step's **window** runs from its start to the start of the same rank's
  next step of the same name (the full step CYCLE — the trailing
  ``comm.Wait`` and checkpoint IO between two steps belong to the step
  that incurred them; the last step's window ends at the last record it
  contains);
- every other record of that rank inside the window is classified —
  **host-sync** (``*host_fetch*``, ``io.*``), **comm-wait** (``comm.*``
  spans and the ``*.wait`` leaf records ``health.guard_blocking`` emits),
  **compute** (everything else: ``dispatch.*``, the step span itself) —
  and the window is swept once with class priority host > comm > compute,
  so overlapping records (a ``comm.resplit`` span containing its own tile
  waits) are never double-counted; uncovered window time is **idle**;
- the **overlap fraction** of a step is ``1 − comm_wait / window``: the
  share of the step cycle NOT exposed as blocking communication.  1.0
  means every byte moved behind compute; 0.0 means the step is pure
  comm-wait.

**What this measures (and what it cannot).**  Device collectives run
asynchronously on device; Python only sees comm when it *blocks* (the
guarded waits, eager resplit transfers).  The fraction is therefore
computed from *exposed* comm-wait — comm fully hidden behind compute is
(correctly) invisible and counts as overlap, but device-side comm that
merely overlaps OTHER comm cannot be distinguished.  This is the honest
host-observable number, the before/after comparison the hierarchical-
collectives PR will be judged against: pipelining gradient allreduce
against the backward pass shrinks exposed comm-wait, which raises this
fraction — see design.md "Observability plane".

Deliberately stdlib-only and standalone-loadable:
``heat_tpu_torch/analysis/telemetry_report.py`` loads this file for its overlap section —
one implementation of the decomposition.

Exit code: 0 (a report, possibly empty); 1 when no rank files were found.
"""

from __future__ import annotations

import argparse
import glob
import json
import math
import os
import sys
from typing import Dict, List, Optional, Tuple

DEFAULT_STEPS = ("daso.step", "optim.step", "nn.train_step", "sched.job")

# class priorities for the sweep: lower wins where records overlap
_HOST, _COMM, _COMPUTE = 0, 1, 2
_CLASS_NAMES = {_HOST: "host_sync", _COMM: "comm_wait", _COMPUTE: "compute"}


def classify(name: str) -> int:
    """host-sync > comm-wait > compute (see module docstring)."""
    if "host_fetch" in name or name.startswith("io."):
        return _HOST
    if name.startswith("comm.") or name.endswith(".wait"):
        return _COMM
    return _COMPUTE


def find_rank_files(target: str) -> List[str]:
    if os.path.isdir(target):
        return sorted(glob.glob(os.path.join(target, "rank*.jsonl")))
    return [target] if os.path.exists(target) else []


def read_spans(paths: List[str]) -> List[dict]:
    spans = []
    for path in paths:
        try:
            with open(path) as fh:
                for line in fh:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue
                    if rec.get("type") == "span":
                        spans.append(rec)
        except OSError:
            continue
    return spans


def _sweep(window: Tuple[float, float],
           intervals: List[Tuple[float, float, int]]) -> Dict[str, float]:
    """One pass over the window: each elementary segment is charged to the
    highest-priority class active there; uncovered time is idle.  Robust
    to overlapping and nested records by construction."""
    w0, w1 = window
    total = max(w1 - w0, 0.0)
    out = {"compute": 0.0, "comm_wait": 0.0, "host_sync": 0.0, "idle": 0.0,
           "total": total}
    if total <= 0.0:
        return out
    clipped = []
    for a, b, cls in intervals:
        a, b = max(a, w0), min(b, w1)
        if b > a:
            clipped.append((a, b, cls))
    points = sorted({w0, w1} | {a for a, _, _ in clipped}
                    | {b for _, b, _ in clipped})
    for p0, p1 in zip(points, points[1:]):
        active = [cls for a, b, cls in clipped if a <= p0 and b >= p1]
        if active:
            out[_CLASS_NAMES[min(active)]] += p1 - p0
        else:
            out["idle"] += p1 - p0
    return out


def step_breakdown(
    spans: List[dict], step_names: Tuple[str, ...] = DEFAULT_STEPS
) -> List[dict]:
    """Per-step decomposition rows (see module docstring for the window
    and classification rules).  ``spans`` are telemetry span records; all
    ranks may be mixed — each rank's timeline is decomposed separately."""
    by_rank: Dict[int, List[dict]] = {}
    for s in spans:
        by_rank.setdefault(int(s.get("rank", 0)), []).append(s)
    rows: List[dict] = []
    for rank, recs in sorted(by_rank.items()):
        recs = sorted(recs, key=lambda r: float(r.get("ts", 0.0)))
        steps = [r for r in recs if r.get("name") in step_names]
        if not steps:
            continue
        last_end = max(
            float(r.get("ts", 0.0)) + float(r.get("dur_s", 0.0)) for r in recs
        )
        # windows per step NAME: consecutive daso.steps chain; an unrelated
        # sched.job stream on the same rank chains independently
        by_name: Dict[str, List[dict]] = {}
        for st in steps:
            by_name.setdefault(st["name"], []).append(st)
        for name, sts in by_name.items():
            for i, st in enumerate(sts):
                t0 = float(st.get("ts", 0.0))
                dur = float(st.get("dur_s", 0.0))
                if i + 1 < len(sts):
                    t1 = float(sts[i + 1].get("ts", 0.0))
                else:
                    t1 = max(t0 + dur, min(last_end, t0 + dur + 60.0))
                window = (t0, max(t1, t0 + dur))
                intervals = [(t0, t0 + dur, _COMPUTE)]  # the step span itself
                for r in recs:
                    if r is st or r.get("name") in step_names:
                        continue
                    a = float(r.get("ts", 0.0))
                    b = a + float(r.get("dur_s", 0.0))
                    if b <= window[0] or a >= window[1]:
                        continue
                    intervals.append((a, b, classify(str(r.get("name", "")))))
                parts = _sweep(window, intervals)
                total = parts["total"]
                rows.append({
                    "rank": rank,
                    "step": name,
                    # the span's sync= attribute ('monolithic'/'bucketed'),
                    # when the emitter labeled it — feeds STEP-OVERLAP-DELTA
                    "sync": (st.get("attrs") or {}).get("sync"),
                    "n": i,
                    "ts": round(t0, 6),
                    "total_s": round(total, 6),
                    "compute_s": round(parts["compute"], 6),
                    "comm_wait_s": round(parts["comm_wait"], 6),
                    "host_sync_s": round(parts["host_sync"], 6),
                    "idle_s": round(parts["idle"], 6),
                    "overlap_fraction": round(
                        1.0 - (parts["comm_wait"] / total if total else 0.0), 4
                    ),
                })
    return rows


def aggregate(rows: List[dict]) -> List[dict]:
    """Per step-name aggregate over all ranks: totals per class and the
    comm-weighted overlap fraction (Σ over steps, so a single long blocked
    step is not averaged away by many fast ones)."""
    agg: Dict[str, dict] = {}
    for r in rows:
        a = agg.setdefault(r["step"], {
            "step": r["step"], "steps": 0, "total_s": 0.0, "compute_s": 0.0,
            "comm_wait_s": 0.0, "host_sync_s": 0.0, "idle_s": 0.0,
            "ranks": set(),
        })
        a["steps"] += 1
        a["ranks"].add(r["rank"])
        for k in ("total_s", "compute_s", "comm_wait_s", "host_sync_s", "idle_s"):
            a[k] += r[k]
    out = []
    for name in sorted(agg):
        a = agg[name]
        total = a["total_s"]
        out.append({
            "step": name,
            "steps": a["steps"],
            "ranks": sorted(a["ranks"]),
            "total_s": round(total, 6),
            "compute_s": round(a["compute_s"], 6),
            "comm_wait_s": round(a["comm_wait_s"], 6),
            "host_sync_s": round(a["host_sync_s"], 6),
            "idle_s": round(a["idle_s"], 6),
            "overlap_fraction": round(
                1.0 - (a["comm_wait_s"] / total if total else 0.0), 4
            ),
        })
    return out


def overlap_delta(rows: List[dict]) -> Dict[str, Dict[str, float]]:
    """Per step-kind overlap fractions split by the steps' ``sync=`` span
    attribute — {kind: {'monolithic': f, 'bucketed': f}} for every kind
    whose merged input holds BOTH labels (a monolithic and a bucketed run
    flushed into the same directory).  The before/after comparison of the
    hierarchical-collectives work, computed from one merge dir so the two
    runs share clocks and methodology."""
    by: Dict[str, Dict[str, Dict[str, float]]] = {}
    for r in rows:
        lbl = r.get("sync")
        if lbl not in ("monolithic", "bucketed"):
            continue
        a = by.setdefault(r["step"], {}).setdefault(
            lbl, {"total": 0.0, "wait": 0.0}
        )
        a["total"] += r["total_s"]
        a["wait"] += r["comm_wait_s"]
    out: Dict[str, Dict[str, float]] = {}
    for kind in sorted(by):
        labels = by[kind]
        if {"monolithic", "bucketed"} <= set(labels):
            out[kind] = {
                lbl: round(
                    1.0 - (v["wait"] / v["total"] if v["total"] else 0.0), 4
                )
                for lbl, v in labels.items()
            }
    return out


def _pctl(values: List[float], q: float) -> float:
    """Exact upper percentile of a small sample (step counts are
    human-scale; same rule as telemetry_report's SLO table)."""
    if not values:
        return 0.0
    vs = sorted(values)
    idx = min(len(vs) - 1, max(0, int(math.ceil(q * len(vs))) - 1))
    return vs[idx]


def distribution(rows: List[dict]) -> Dict[str, Dict[str, float]]:
    """Per-step-kind p50/p99 of the window, exposed comm-wait and overlap
    fraction ACROSS step cycles — the aggregate STEP-OVERLAP line hides a
    straggling cycle inside the mean; the tail percentiles don't."""
    by: Dict[str, List[dict]] = {}
    for r in rows:
        by.setdefault(r["step"], []).append(r)
    out: Dict[str, Dict[str, float]] = {}
    for kind in sorted(by):
        rs = by[kind]
        totals = [r["total_s"] for r in rs]
        waits = [r["comm_wait_s"] for r in rs]
        overlaps = [r["overlap_fraction"] for r in rs]
        out[kind] = {
            "n": len(rs),
            "total_s_p50": _pctl(totals, 0.5),
            "total_s_p99": _pctl(totals, 0.99),
            "comm_wait_s_p50": _pctl(waits, 0.5),
            "comm_wait_s_p99": _pctl(waits, 0.99),
            "overlap_p50": _pctl(overlaps, 0.5),
            "overlap_p99": _pctl(overlaps, 0.99),
        }
    return out


def _fmt_table(rows: List[List[str]], header: List[str]) -> str:
    widths = [max(len(str(r[i])) for r in [header] + rows) for i in range(len(header))]
    fmt = "  ".join(f"{{:<{w}}}" for w in widths)
    lines = [fmt.format(*header), fmt.format(*("-" * w for w in widths))]
    lines += [fmt.format(*(str(c) for c in r)) for r in rows]
    return "\n".join(lines)


def render(rows: List[dict], per_step: int = 0) -> str:
    """The report text: per-step-kind aggregate table, one greppable
    ``STEP-OVERLAP`` marker line per kind (CI asserts on these), and
    optionally the first ``per_step`` individual step rows."""
    if not rows:
        return ""
    out = ["-- step-time breakdown (compute | comm-wait | host-sync | idle) --"]
    aggs = aggregate(rows)
    table = [
        [a["step"], a["steps"], ",".join(str(r) for r in a["ranks"]),
         f"{a['total_s'] * 1e3:.1f}", f"{a['compute_s'] * 1e3:.1f}",
         f"{a['comm_wait_s'] * 1e3:.1f}", f"{a['host_sync_s'] * 1e3:.1f}",
         f"{a['idle_s'] * 1e3:.1f}", f"{a['overlap_fraction']:.3f}"]
        for a in aggs
    ]
    out.append(_fmt_table(table, [
        "step", "n", "ranks", "total_ms", "compute_ms", "comm_wait_ms",
        "host_sync_ms", "idle_ms", "overlap",
    ]))
    for a in aggs:
        out.append(
            f"STEP-OVERLAP kind={a['step']} steps={a['steps']} "
            f"overlap={a['overlap_fraction']:.3f} "
            f"comm_wait_ms={a['comm_wait_s'] * 1e3:.1f} "
            f"total_ms={a['total_s'] * 1e3:.1f}"
        )
    # per-cycle tail distribution beside each aggregate line (the
    # STEP-OVERLAP format above is pinned by test and stays untouched)
    for kind, d in distribution(rows).items():
        out.append(
            f"STEP-DIST kind={kind} n={d['n']} "
            f"total_ms_p50={d['total_s_p50'] * 1e3:.1f} "
            f"total_ms_p99={d['total_s_p99'] * 1e3:.1f} "
            f"comm_wait_ms_p50={d['comm_wait_s_p50'] * 1e3:.1f} "
            f"comm_wait_ms_p99={d['comm_wait_s_p99'] * 1e3:.1f} "
            f"overlap_p50={d['overlap_p50']:.3f} "
            f"overlap_p99={d['overlap_p99']:.3f}"
        )
    # monolithic-vs-bucketed delta, when both labeled runs share this merge
    # dir (the CI-greppable improvement line; the STEP-OVERLAP format above
    # is asserted elsewhere and stays untouched)
    for kind, f in overlap_delta(rows).items():
        out.append(
            f"STEP-OVERLAP-DELTA kind={kind} "
            f"monolithic={f['monolithic']:.3f} bucketed={f['bucketed']:.3f} "
            f"delta={f['bucketed'] - f['monolithic']:+.3f}"
        )
    if per_step > 0:
        out.append("")
        sub = rows[:per_step]
        out.append(_fmt_table(
            [
                [r["rank"], r["step"], r["n"], f"{r['total_s'] * 1e3:.1f}",
                 f"{r['compute_s'] * 1e3:.1f}", f"{r['comm_wait_s'] * 1e3:.1f}",
                 f"{r['host_sync_s'] * 1e3:.1f}", f"{r['idle_s'] * 1e3:.1f}",
                 f"{r['overlap_fraction']:.3f}"]
                for r in sub
            ],
            ["rank", "step", "#", "total_ms", "compute_ms", "comm_wait_ms",
             "host_sync_ms", "idle_ms", "overlap"],
        ))
    return "\n".join(out)


def overlap_section(spans: List[dict],
                    step_names: Tuple[str, ...] = DEFAULT_STEPS,
                    per_step: int = 0) -> str:
    """The embeddable form ``heat_tpu_torch/analysis/telemetry_report.py`` calls with its
    already-merged spans; '' when no step spans exist (the common
    non-training invocation prints nothing extra)."""
    rows = step_breakdown(
        [s for s in spans if s.get("type") == "span"], step_names
    )
    if not rows:
        return ""
    return "\n" + render(rows, per_step=per_step)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("targets", nargs="+",
                    help="telemetry dirs and/or rank*.jsonl files")
    ap.add_argument("--steps", default=",".join(DEFAULT_STEPS),
                    help="comma-separated step span names")
    ap.add_argument("--per-step", type=int, default=0,
                    help="also print the first N individual step rows")
    ap.add_argument("--json", default=None, help="write the per-step rows here")
    args = ap.parse_args(argv)

    paths: List[str] = []
    for t in args.targets:
        paths.extend(find_rank_files(t))
    paths = sorted(dict.fromkeys(paths))
    if not paths:
        print(f"no rank*.jsonl files under {args.targets}", file=sys.stderr)
        return 1
    step_names = tuple(s.strip() for s in args.steps.split(",") if s.strip())
    rows = step_breakdown(read_spans(paths), step_names)
    if not rows:
        print(f"no step spans ({', '.join(step_names)}) in {len(paths)} rank file(s)")
        return 0
    print(render(rows, per_step=args.per_step))
    if args.json:
        with open(args.json, "w") as fh:
            json.dump({"steps": rows, "aggregate": aggregate(rows),
                       "distribution": distribution(rows)}, fh, indent=1)
        print(f"\nper-step JSON written to {args.json}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
