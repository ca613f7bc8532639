"""Cross-rank timeline assembly, Chrome-trace export, critical-path blame.

The runtime already records everything this module needs — telemetry span
JSONL exports (``utils/telemetry.py``), crash-durable flight-ring
collective stamps (``utils/flightrec.py``), scheduler/federation journals
(``parallel/scheduler.py`` / ``parallel/federation.py``) — but each
artifact answers only "how much".  This module merges them into ONE
cross-rank timeline and answers "which rank, which op, which seq gated
this step":

- **Clock alignment.**  Each rank's span timestamps live in a private
  ``perf_counter`` domain anchored to wall clock once at import
  (``telemetry._T0_PERF``/``_T0_WALL``); ring stamps are raw
  ``time.time()``.  Neither is comparable across hosts.  The shared
  collective-stamp anchors fix that: in lockstep SPMD, equal ``seq``
  means the same logical staging instant, so a rank's offset against the
  reference rank is the **robust median** of its per-seq stamp deltas,
  with the max residual reported as the quality bound.  One offset per
  rank corrects both streams (spans and stamps share the rank's wall
  clock).  A rank with telemetry but no ring is NAMED unaligned — it is
  never silently merged on a clock nobody estimated.
- **Chrome trace-event export** (:func:`to_chrome_trace`): one pid per
  rank; lanes for compute spans, collectives, host syncs; a pseudo-pid
  for scheduler journal records; flow events joining every collective's
  participants across ranks via its ``seq`` and ``trace_id`` flows
  across ingress → scheduler → serving.  :func:`validate_chrome_trace`
  is the stdlib schema checker CI runs against the exported artifact.
- **Critical path** (:func:`critical_path`): per step-cycle (the
  stepprof window rule — a step's window runs to the next same-name step
  start on that rank), every instant is attributed to the highest-
  priority active record (host sync > comm wait > compute), naming the
  dominant contributor per step kind; across ranks, every shared seq
  charges its **gating rank** (the last stamper) with the stamp spread,
  and a rank whose stream stops short is charged the whole time the
  world kept going without it — which is how the chaos lane's injected
  straggler gets named.  Output: greppable ``CRITICAL-PATH kind=… rank=…
  op=… seq=… share=…`` lines plus per-rank / per-op blame tables.

Stdlib-only and standalone-loadable on purpose (the postmortem pattern):
``heat_tpu_torch/analysis/traceviz.py`` loads this file via ``spec_from_file_location``
on machines that never import torch.  Everything here is post-hoc reading
of already-written artifacts — the hot paths gain zero cost.
"""

from __future__ import annotations

import json
import os
import sys
from typing import Any, Dict, List, Optional, Tuple

__all__ = [
    "DEFAULT_STEPS",
    "assemble",
    "estimate_clock_offsets",
    "load_telemetry",
    "load_rings",
    "load_journals",
    "to_chrome_trace",
    "validate_chrome_trace",
    "critical_path",
    "critical_path_report",
    "clock_report",
    "classify",
]

DEFAULT_STEPS = ("daso.step", "optim.step", "nn.train_step", "sched.job")

# trace lanes (tid per rank pid); the scheduler journal gets its own
# pseudo-pid — journals are written by one process for the whole world
LANE_COMPUTE = 0
LANE_COLL = 1
LANE_HOST = 2
SCHED_PID = 1 << 20
_LANE_NAMES = {
    LANE_COMPUTE: "compute spans",
    LANE_COLL: "collectives",
    LANE_HOST: "host syncs",
}


def classify(name: str) -> str:
    """Span class, mirroring ``analysis/stepprof.py``: host syncs outrank
    comm waits outrank compute when deciding what gates an instant."""
    if "host_fetch" in name or name.startswith("io."):
        return "host"
    if name.startswith("comm.") or name.endswith(".wait"):
        return "comm"
    return "compute"


# ---------------------------------------------------------------------- #
# artifact loading (flightrec is the ONE ring-format implementation —
# loaded standalone exactly like heat_tpu_torch/analysis/postmortem.py does)
# ---------------------------------------------------------------------- #
_flightrec = None


def _flightrec_mod():
    mod = sys.modules.get("heat_tpu_torch.utils.flightrec")
    if mod is not None:
        return mod
    global _flightrec
    if _flightrec is None:
        import importlib.util

        path = os.path.normpath(
            os.path.join(
                os.path.dirname(os.path.abspath(__file__)),
                os.pardir, "utils", "flightrec.py",
            )
        )
        spec = importlib.util.spec_from_file_location("heat_timeline_flightrec", path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = mod
        spec.loader.exec_module(mod)
        _flightrec = mod
    return _flightrec


def expand_dirs(dirs: List[str]) -> List[str]:
    """Each dir plus its harvested ``epoch<N>/`` ring subdirectories (the
    supervisor moves a failed generation's rings there at teardown).
    Epoch dirs come FIRST so a live ring for the same rank wins the merge
    — the final generation is the story the timeline tells."""
    out: List[str] = []
    for d in dirs:
        subs = []
        try:
            for name in sorted(os.listdir(d)):
                p = os.path.join(d, name)
                if name.startswith("epoch") and os.path.isdir(p):
                    subs.append(p)
        except OSError:
            pass
        out.extend(subs)
        out.append(d)
    return list(dict.fromkeys(out))


def load_telemetry(dirs: List[str]) -> Tuple[Dict[int, List[dict]], Dict[int, dict]]:
    """``rank → span records`` and ``rank → meta record`` from every
    ``rank<k>.jsonl`` under the target dirs.  Torn lines are skipped —
    the exporter may have died mid-flush."""
    spans: Dict[int, List[dict]] = {}
    meta: Dict[int, dict] = {}
    for d in dirs:
        try:
            names = sorted(os.listdir(d))
        except OSError:
            continue
        for name in names:
            if not (name.startswith("rank") and name.endswith(".jsonl")):
                continue
            try:
                rank = int(name[len("rank"):-len(".jsonl")])
            except ValueError:
                continue
            try:
                with open(os.path.join(d, name)) as fh:
                    for line in fh:
                        try:
                            rec = json.loads(line)
                        except ValueError:
                            continue
                        if not isinstance(rec, dict):
                            continue
                        if rec.get("type") == "span":
                            spans.setdefault(rank, []).append(rec)
                        elif rec.get("type") == "meta":
                            meta[rank] = rec
            except OSError:
                continue
    for sp in spans.values():
        sp.sort(key=lambda r: r.get("ts", 0.0))
    return spans, meta


def load_rings(dirs: List[str]) -> Dict[int, dict]:
    """``rank → parsed ring`` across the target dirs; a later dir's ring
    for the same rank replaces an earlier one (see :func:`expand_dirs`).
    Unreadable files are skipped, never fatal."""
    fr = _flightrec_mod()
    rings: Dict[int, dict] = {}
    for d in dirs:
        for path in fr.find_ring_files(d):
            try:
                ring = fr.read_ring(path)
            except (OSError, ValueError):
                continue
            rings[int(ring.get("rank", 0))] = ring
    return rings


def load_journals(dirs: List[str]) -> List[dict]:
    """Scheduler/federation journal records (``*journal*.jsonl``) across
    the target dirs, each tagged with its source path."""
    out: List[dict] = []
    seen = set()
    for d in dirs:
        try:
            names = sorted(os.listdir(d))
        except OSError:
            continue
        for name in names:
            if "journal" not in name or not name.endswith(".jsonl"):
                continue
            path = os.path.join(d, name)
            if path in seen:
                continue
            seen.add(path)
            try:
                with open(path) as fh:
                    for line in fh:
                        try:
                            rec = json.loads(line)
                        except ValueError:
                            continue
                        if isinstance(rec, dict) and rec.get("type"):
                            rec["_journal"] = name
                            out.append(rec)
            except OSError:
                continue
    out.sort(key=lambda r: r.get("t", 0.0))
    return out


# ---------------------------------------------------------------------- #
# clock alignment
# ---------------------------------------------------------------------- #
def _median(vals: List[float]) -> float:
    s = sorted(vals)
    n = len(s)
    mid = n // 2
    return s[mid] if n % 2 else (s[mid - 1] + s[mid]) / 2.0


def _coll_stamps(ring: dict) -> Dict[int, dict]:
    """seq → coll record (last write wins: after a wrap the ring holds the
    latest window; duplicates cannot survive it anyway)."""
    out: Dict[int, dict] = {}
    for rec in ring.get("records", []):
        if rec.get("k") == "coll" and rec.get("seq") is not None and rec.get("t") is not None:
            try:
                out[int(rec["seq"])] = rec
            except (TypeError, ValueError):
                continue
    return out


def estimate_clock_offsets(rings: Dict[int, dict]) -> dict:
    """Per-rank clock offsets from the shared collective-stamp anchors.

    Reference = the lowest rank holding stamps (offset 0 by definition).
    For every other rank, offset = median of ``t_rank(seq) − t_ref(seq)``
    over the shared seqs — robust against the handful of seqs where one
    rank really was late (the very skew the critical path then measures)
    — and ``max_residual_s`` bounds how far any single anchor strays from
    the estimate.  Aligned time = ``t_raw − offset``.

    A rank sharing no seq with the reference is returned in
    ``unaligned`` — named, never silently aligned."""
    stamps = {r: _coll_stamps(ring) for r, ring in rings.items()}
    stamps = {r: s for r, s in stamps.items() if s}
    align: dict = {"ref": None, "offsets": {}, "per_rank": {}, "unaligned": []}
    if not stamps:
        align["unaligned"] = [
            {"rank": r, "reason": "no-collective-stamps"} for r in sorted(rings)
        ]
        return align
    ref = min(stamps)
    align["ref"] = ref
    align["offsets"][ref] = 0.0
    align["per_rank"][ref] = {
        "anchors": len(stamps[ref]), "offset_s": 0.0, "max_residual_s": 0.0,
    }
    for r in sorted(stamps):
        if r == ref:
            continue
        shared = sorted(set(stamps[r]) & set(stamps[ref]))
        if not shared:
            align["unaligned"].append({"rank": r, "reason": "no-shared-anchors"})
            continue
        deltas = [
            float(stamps[r][s]["t"]) - float(stamps[ref][s]["t"]) for s in shared
        ]
        off = _median(deltas)
        align["offsets"][r] = off
        align["per_rank"][r] = {
            "anchors": len(shared),
            "offset_s": off,
            "max_residual_s": max(abs(d - off) for d in deltas),
        }
    for r in sorted(rings):
        if r not in stamps and r != ref:
            align["unaligned"].append({"rank": r, "reason": "no-collective-stamps"})
    return align


# ---------------------------------------------------------------------- #
# assembly
# ---------------------------------------------------------------------- #
def assemble(dirs: List[str], step_names: Tuple[str, ...] = DEFAULT_STEPS) -> dict:
    """Load + align every artifact under ``dirs`` (epoch ring harvests
    included) into one bundle the exporters and the critical-path walker
    consume."""
    dirs = expand_dirs([d for d in dirs if d])
    spans, meta = load_telemetry(dirs)
    rings = load_rings(dirs)
    journals = load_journals(dirs)
    align = estimate_clock_offsets(rings)
    # telemetry without a ring: no anchors exist for this rank's clock —
    # name it; its events still export on its own (uncorrected) clock
    for r in sorted(spans):
        if r not in rings:
            align["unaligned"].append({"rank": r, "reason": "no-ring"})
    align["unaligned"].sort(key=lambda u: u["rank"])
    offsets = align["offsets"]

    # journal clock domain: the writer's pid, matched to a rank via ring /
    # telemetry meta pids, borrows that rank's offset
    jpids = {
        rec.get("pid") for rec in journals if rec.get("type") == "meta"
    } - {None}
    journal_offset = 0.0
    pid_to_rank = {ring.get("pid"): r for r, ring in rings.items()}
    pid_to_rank.update({m.get("pid"): r for r, m in meta.items()})
    for p in jpids:
        if p in pid_to_rank and pid_to_rank[p] in offsets:
            journal_offset = offsets[pid_to_rank[p]]
            break

    t0 = None
    for r, sp in spans.items():
        off = offsets.get(r, 0.0)
        for s in sp:
            t = float(s.get("ts", 0.0)) - off
            t0 = t if t0 is None else min(t0, t)
    for r, ring in rings.items():
        off = offsets.get(r, 0.0)
        for rec in ring.get("records", []):
            if rec.get("t") is not None:
                try:
                    t = float(rec["t"]) - off
                except (TypeError, ValueError):
                    continue
                t0 = t if t0 is None else min(t0, t)
    for rec in journals:
        if rec.get("t") is not None:
            t = float(rec["t"]) - journal_offset
            t0 = t if t0 is None else min(t0, t)

    return {
        "ranks": sorted(set(spans) | set(rings)),
        "spans": spans,
        "meta": meta,
        "rings": rings,
        "journals": journals,
        "journal_offset": journal_offset,
        "align": align,
        "offsets": offsets,
        "t0": t0 if t0 is not None else 0.0,
        "step_names": tuple(step_names),
        "dirs": dirs,
    }


def _aligned(bundle: dict, rank: int, t: float) -> float:
    return float(t) - bundle["offsets"].get(rank, 0.0)


# ---------------------------------------------------------------------- #
# Chrome trace-event export
# ---------------------------------------------------------------------- #
def _us(bundle: dict, rank: int, t: float) -> float:
    return round((_aligned(bundle, rank, t) - bundle["t0"]) * 1e6, 1)


def to_chrome_trace(bundle: dict) -> dict:
    """The merged bundle as Chrome trace-event JSON (Perfetto-loadable).

    Mapping (documented in design.md "Timeline export & critical path"):
    telemetry span → ``X`` on the rank's compute/collectives/host lane;
    ring ``coll`` stamp → 1 µs ``X`` on the collectives lane + ``s/t/f``
    flow chain joining every participant of that seq; ring
    ``ckpt/resume/shutdown/mem`` → ``i`` instants; ring ``span``/
    ``span_end`` pairs → reconstructed ``X`` slices ONLY for ranks with
    no telemetry export (the chaos post-mortem case); journal record →
    ``i`` on the scheduler pseudo-pid + per-job ``X`` slice; trace ids →
    ``s/t/f`` flows across every source that carries them."""
    ev: List[dict] = []
    flows: List[dict] = []
    trace_points: Dict[str, List[Tuple[float, int, int, str]]] = {}

    for rank in bundle["ranks"]:
        ev.append({"ph": "M", "pid": rank, "tid": 0, "name": "process_name",
                   "args": {"name": f"rank{rank}"}})
        ev.append({"ph": "M", "pid": rank, "tid": 0, "name": "process_sort_index",
                   "args": {"sort_index": rank}})
        for lane, lname in _LANE_NAMES.items():
            ev.append({"ph": "M", "pid": rank, "tid": lane, "name": "thread_name",
                       "args": {"name": lname}})

    # telemetry spans
    for rank, sp in bundle["spans"].items():
        for s in sp:
            name = str(s.get("name", "?"))
            lane = {"compute": LANE_COMPUTE, "comm": LANE_COLL,
                    "host": LANE_HOST}[classify(name)]
            ts = _us(bundle, rank, float(s.get("ts", 0.0)))
            dur = max(float(s.get("dur_s", 0.0)) * 1e6, 1.0)
            attrs = s.get("attrs") or {}
            ev.append({
                "ph": "X", "pid": rank, "tid": lane, "ts": ts, "dur": round(dur, 1),
                "name": name, "cat": classify(name),
                "args": {k: v for k, v in attrs.items()},
            })
            tid = attrs.get("trace_id")
            if tid:
                trace_points.setdefault(str(tid), []).append((ts, rank, lane, name))

    # flight-ring records
    coll_by_seq: Dict[int, List[Tuple[float, int, str]]] = {}
    for rank, ring in bundle["rings"].items():
        open_spans: List[Tuple[str, float]] = []
        has_telemetry = rank in bundle["spans"]
        for rec in ring.get("records", []):
            k = rec.get("k")
            try:
                t = float(rec.get("t"))
            except (TypeError, ValueError):
                continue
            ts = _us(bundle, rank, t)
            if k == "coll":
                op = str(rec.get("op", "?"))
                args = {
                    f: rec[f]
                    for f in ("seq", "wire", "gshape", "dtype", "src", "dst", "dl", "tid")
                    if rec.get(f) is not None
                }
                ev.append({"ph": "X", "pid": rank, "tid": LANE_COLL, "ts": ts,
                           "dur": 1.0, "name": op, "cat": "collective-stamp",
                           "args": args})
                if rec.get("seq") is not None:
                    try:
                        coll_by_seq.setdefault(int(rec["seq"]), []).append((ts, rank, op))
                    except (TypeError, ValueError):
                        pass
                if rec.get("tid"):
                    trace_points.setdefault(str(rec["tid"]), []).append(
                        (ts, rank, LANE_COLL, op)
                    )
            elif k in ("ckpt", "resume", "shutdown") or (k == "mem" and rec.get("oom")):
                name = "OOM" if k == "mem" else k
                ev.append({"ph": "i", "pid": rank, "tid": LANE_HOST, "ts": ts,
                           "s": "p", "name": name, "cat": "marker"})
            elif k == "span" and not has_telemetry:
                open_spans.append((str(rec.get("name", "?")), ts))
            elif k == "span_end" and not has_telemetry and open_spans:
                name, t_open = open_spans.pop()
                ev.append({"ph": "X", "pid": rank, "tid": LANE_COMPUTE,
                           "ts": t_open, "dur": round(max(ts - t_open, 1.0), 1),
                           "name": name, "cat": "ring-span", "args": {}})

    # flow events: every collective seq joins its participants across ranks
    for seq, parts in sorted(coll_by_seq.items()):
        if len(parts) < 2:
            continue
        parts.sort()
        for i, (ts, rank, op) in enumerate(parts):
            ph = "s" if i == 0 else ("f" if i == len(parts) - 1 else "t")
            flow = {"ph": ph, "pid": rank, "tid": LANE_COLL, "ts": ts,
                    "name": op, "cat": "collective", "id": seq}
            if ph == "f":
                flow["bp"] = "e"
            flows.append(flow)

    # scheduler / federation journals: one pseudo-process, job slices +
    # per-record instants
    if bundle["journals"]:
        ev.append({"ph": "M", "pid": SCHED_PID, "tid": 0, "name": "process_name",
                   "args": {"name": "scheduler (journal)"}})
        ev.append({"ph": "M", "pid": SCHED_PID, "tid": 0, "name": "thread_name",
                   "args": {"name": "scheduler jobs"}})
        joff = bundle["journal_offset"]
        jobs: Dict[str, List[Tuple[float, str]]] = {}
        for rec in bundle["journals"]:
            try:
                t = float(rec.get("t"))
            except (TypeError, ValueError):
                continue
            ts = round((t - joff - bundle["t0"]) * 1e6, 1)
            kind = str(rec.get("type", "?"))
            if kind == "meta":
                continue
            args = {
                f: rec[f] for f in ("id", "kind", "tenant", "tid", "epoch", "reason")
                if rec.get(f) is not None
            }
            ev.append({"ph": "i", "pid": SCHED_PID, "tid": 0, "ts": ts, "s": "t",
                       "name": kind, "cat": "journal", "args": args})
            if rec.get("id") is not None:
                jobs.setdefault(str(rec["id"]), []).append((ts, kind))
            if rec.get("tid"):
                trace_points.setdefault(str(rec["tid"]), []).append(
                    (ts, SCHED_PID, 0, kind)
                )
        for job_id, points in sorted(jobs.items()):
            points.sort()
            t_first, t_last = points[0][0], points[-1][0]
            ev.append({
                "ph": "X", "pid": SCHED_PID, "tid": 0, "ts": t_first,
                "dur": round(max(t_last - t_first, 1.0), 1),
                "name": f"job {job_id}", "cat": "job",
                "args": {"records": [k for _, k in points]},
            })

    # trace-id flows: ingress → scheduler → serving → collectives
    for tid, points in sorted(trace_points.items()):
        spots = sorted(set(points))
        if len(spots) < 2 or len({(p[1], p[2]) for p in spots}) < 2:
            continue
        for i, (ts, pid, lane, name) in enumerate(spots):
            ph = "s" if i == 0 else ("f" if i == len(spots) - 1 else "t")
            flow = {"ph": ph, "pid": pid, "tid": lane, "ts": ts,
                    "name": "trace", "cat": "trace", "id": f"tr-{tid}"}
            if ph == "f":
                flow["bp"] = "e"
            flows.append(flow)

    align = bundle["align"]
    return {
        "traceEvents": ev + flows,
        "displayTimeUnit": "ms",
        "otherData": {
            "t0_epoch_s": bundle["t0"],
            "clock_ref_rank": align.get("ref"),
            "clock_offsets_s": {
                str(r): round(o, 6) for r, o in sorted(bundle["offsets"].items())
            },
            "clock_unaligned": align.get("unaligned", []),
            "source_dirs": bundle.get("dirs", []),
        },
    }


# every phase the trace-event format defines (the exporter above uses
# X/i/M/s/t/f; the checker accepts the full alphabet so it can validate
# foreign traces too)
_VALID_PH = frozenset({
    "B", "E", "X",            # duration
    "i", "I",                 # instant (I is the legacy spelling)
    "C",                      # counter
    "b", "n", "e",            # async
    "s", "t", "f",            # flow
    "S", "T", "p", "F",       # legacy async
    "M",                      # metadata
    "P",                      # sample
    "N", "O", "D",            # object
    "R",                      # mark
    "c",                      # clock sync
    "a",                      # linked id
    "v", "V",                 # memory dumps
    "(", ")",                 # legacy context
})
_TS_FREE = frozenset("M")  # metadata events carry no timestamp


def validate_chrome_trace(obj: Any, max_problems: int = 25) -> List[str]:
    """Stdlib trace-event schema check: [] iff ``obj`` is a loadable
    Chrome trace.  Deliberately structural (phases, required fields,
    numeric timestamps, flow ids) — the CI gate for the exported
    artifact."""
    problems: List[str] = []

    def bad(msg: str) -> bool:
        problems.append(msg)
        return len(problems) >= max_problems

    if not isinstance(obj, dict):
        return ["top level: expected an object with 'traceEvents'"]
    events = obj.get("traceEvents")
    if not isinstance(events, list):
        return ["top level: 'traceEvents' missing or not a list"]
    for i, e in enumerate(events):
        if not isinstance(e, dict):
            if bad(f"event {i}: not an object"):
                break
            continue
        ph = e.get("ph")
        if not isinstance(ph, str) or ph not in _VALID_PH:
            if bad(f"event {i}: bad phase {ph!r}"):
                break
            continue
        if "pid" not in e:
            if bad(f"event {i} (ph={ph}): missing pid"):
                break
            continue
        if ph not in _TS_FREE:
            ts = e.get("ts")
            if not isinstance(ts, (int, float)) or isinstance(ts, bool):
                if bad(f"event {i} (ph={ph}): non-numeric ts {ts!r}"):
                    break
                continue
        if not isinstance(e.get("name", ""), str):
            if bad(f"event {i} (ph={ph}): non-string name"):
                break
            continue
        if ph == "X":
            dur = e.get("dur")
            if not isinstance(dur, (int, float)) or isinstance(dur, bool) or dur < 0:
                if bad(f"event {i} (X): bad dur {dur!r}"):
                    break
                continue
        if ph in "stf" and e.get("id") is None:
            if bad(f"event {i} (flow {ph}): missing id"):
                break
            continue
    return problems


# ---------------------------------------------------------------------- #
# critical path + blame
# ---------------------------------------------------------------------- #
def _step_windows(spans: List[dict], name: str) -> List[Tuple[float, float, dict]]:
    """One rank's step cycles for ``name``: window = step start → next
    same-name step start (the stepprof rule); the last window is the
    step's own extent (post-run idle gates nothing)."""
    steps = sorted(
        (s for s in spans if s.get("name") == name),
        key=lambda s: float(s.get("ts", 0.0)),
    )
    out = []
    for i, s in enumerate(steps):
        t0 = float(s.get("ts", 0.0))
        t1 = (
            float(steps[i + 1].get("ts", 0.0))
            if i + 1 < len(steps)
            else t0 + float(s.get("dur_s", 0.0))
        )
        if t1 > t0:
            out.append((t0, t1, s))
    return out


def _window_segments(
    rank: int, spans: List[dict], t0: float, t1: float, step: dict
) -> List[Tuple[float, str, str]]:
    """Attribute every elementary segment of one step window to the record
    gating it: (seconds, class, op-name).  Host spans outrank comm spans
    outrank the step's own compute — at any instant the highest-priority
    live record is what progress is waiting on."""
    marks = {t0, t1}
    active: List[Tuple[float, float, str, str]] = []
    for s in spans:
        if s is step:
            continue
        cls = classify(str(s.get("name", "")))
        if cls == "compute":
            continue
        a = float(s.get("ts", 0.0))
        b = a + float(s.get("dur_s", 0.0))
        a, b = max(a, t0), min(b, t1)
        if b <= a:
            continue
        active.append((a, b, cls, str(s.get("name", "?"))))
        marks.add(a)
        marks.add(b)
    points = sorted(marks)
    segs: List[Tuple[float, str, str]] = []
    step_name = str(step.get("name", "?"))
    for a, b in zip(points, points[1:]):
        mid = (a + b) / 2.0
        live = [iv for iv in active if iv[0] <= mid < iv[1]]
        host = [iv for iv in live if iv[2] == "host"]
        comm = [iv for iv in live if iv[2] == "comm"]
        if host:
            segs.append((b - a, "host", host[0][3]))
        elif comm:
            segs.append((b - a, "comm", comm[0][3]))
        else:
            segs.append((b - a, "compute", step_name))
    return segs


def critical_path(
    bundle: dict, step_names: Optional[Tuple[str, ...]] = None
) -> dict:
    """The gating chain, two views over the ALIGNED timeline:

    - per step kind: dominant (class, rank, op) share of the summed
      step-cycle windows; a comm contributor carries the seq of the
      rank's latest collective stamp at the segment;
    - per collective seq across ranks: the gating rank (last stamper)
      charged with the stamp spread — and a rank whose stream stops
      short of the world's charged with the (right-censored) time the
      world kept recording without it, at its last stamped (seq, op),
      and NAMED as the gating rank regardless of charge magnitude: the
      injected straggler's conviction, matching the post-mortem's.  Where
      every stream ends at one seq (blocking collectives), a rank that
      stamped it without the ``enter`` record its peers wrote is short
      there.

    Returns steps/collective detail, greppable ``lines``, and the merged
    per-rank / per-op ``blame`` shares."""
    step_names = tuple(step_names or bundle.get("step_names") or DEFAULT_STEPS)
    spans = bundle["spans"]
    offsets = bundle["offsets"]

    # per-rank aligned stamp streams
    stamps: Dict[int, Dict[int, Tuple[float, str]]] = {}
    for rank, ring in bundle["rings"].items():
        off = offsets.get(rank, 0.0)
        by = {}
        for seq, rec in _coll_stamps(ring).items():
            try:
                by[seq] = (float(rec["t"]) - off, str(rec.get("op", "?")))
            except (TypeError, ValueError):
                continue
        if by:
            stamps[rank] = by

    lines: List[str] = []
    blame: Dict[Tuple[int, str], float] = {}

    # ---- per step kind ------------------------------------------------ #
    steps_out: Dict[str, dict] = {}
    for kind in step_names:
        contrib: Dict[Tuple[str, int, str], dict] = {}
        total = 0.0
        windows = 0
        for rank, sp in spans.items():
            my_stamps = sorted(
                (t, seq, op) for seq, (t, op) in stamps.get(rank, {}).items()
            )
            for t0, t1, step in _step_windows(sp, kind):
                off = offsets.get(rank, 0.0)
                windows += 1
                total += t1 - t0
                seg_t = t0
                for secs, cls, op in _window_segments(rank, sp, t0, t1, step):
                    c = contrib.setdefault(
                        (cls, rank, op), {"s": 0.0, "seq": None, "big": 0.0}
                    )
                    c["s"] += secs
                    if secs > c["big"]:
                        c["big"] = secs
                        if cls == "comm" and my_stamps:
                            at = seg_t - off  # aligned segment start
                            before = [x for x in my_stamps if x[0] <= at]
                            c["seq"] = (before[-1] if before else my_stamps[0])[1]
                    seg_t += secs
        if not windows or total <= 0:
            continue
        ranked = sorted(contrib.items(), key=lambda kv: -kv[1]["s"])
        cls, rank, op = ranked[0][0]
        top = ranked[0][1]
        seq = top["seq"] if top["seq"] is not None else "-"
        share = top["s"] / total
        lines.append(
            f"CRITICAL-PATH kind={kind} rank={rank} op={op} seq={seq} "
            f"share={share:.3f}"
        )
        for (ccls, crank, cop), c in contrib.items():
            blame[(crank, cop)] = blame.get((crank, cop), 0.0) + c["s"]
        steps_out[kind] = {
            "windows": windows,
            "total_s": total,
            "contributors": [
                {"class": k[0], "rank": k[1], "op": k[2],
                 "s": v["s"], "seq": v["seq"], "share": v["s"] / total}
                for k, v in ranked
            ],
        }

    # ---- cross-rank collective gating --------------------------------- #
    coll_out: dict = {"charges": [], "total_s": 0.0}
    if len(stamps) >= 2:
        charges: Dict[int, dict] = {}

        def charge(rank: int, secs: float, op: str, seq: int) -> None:
            c = charges.setdefault(rank, {"s": 0.0, "op": op, "seq": seq, "big": 0.0})
            c["s"] += secs
            if secs > c["big"]:
                c.update(big=secs, op=op, seq=seq)

        all_seqs = set()
        for by in stamps.values():
            all_seqs |= set(by)
        for seq in sorted(all_seqs):
            parts = [
                (by[seq][0], r, by[seq][1]) for r, by in stamps.items() if seq in by
            ]
            if len(parts) < 2:
                continue
            parts.sort()
            gap = parts[-1][0] - parts[0][0]
            if gap > 0:
                charge(parts[-1][1], gap, parts[-1][2], seq)
        # short streams: a rank that stopped stamping while the world kept
        # going gated every later seq — charge it the span the world spent
        # without it, at its LAST stamp (the post-mortem convention).  The
        # wait is right-censored: nobody stamps while the world is wedged
        # on the straggler, so the observable lag only reaches the last
        # aligned record of ANY kind in ANY ring, not the teardown.
        global_last_seq = max(max(by) for by in stamps.values())
        global_last_t = max(max(t for t, _ in by.values()) for by in stamps.values())
        for rank, ring in bundle["rings"].items():
            off = offsets.get(rank, 0.0)
            for rec in ring.get("records", []):
                try:
                    global_last_t = max(global_last_t, float(rec["t"]) - off)
                except (KeyError, TypeError, ValueError):
                    continue
        short: Dict[int, int] = {}
        # blocking collectives: every stream ends at one seq, and the world
        # waits in its transport on the ranks that stamped it and never
        # went in (no ``enter`` record): those are short at that seq
        inside = {
            rank: any(
                rec.get("k") == "enter" and rec.get("seq") == global_last_seq
                for rec in bundle["rings"][rank].get("records", [])
            )
            for rank in stamps
        }
        level = all(max(by) == global_last_seq for by in stamps.values())
        for rank, by in stamps.items():
            last_seq = max(by)
            if last_seq < global_last_seq or (level and not inside[rank] and any(inside.values())):
                short[rank] = last_seq
                t_last, op_last = by[last_seq]
                charge(rank, max(global_last_t - t_last, 0.0), op_last, last_seq)
                # blame coordinates pin to the LAST stamp even when some
                # earlier rendezvous gap was the bigger single charge —
                # the (seq, op) the post-mortem names is where it wedged
                charges[rank].update(op=op_last, seq=last_seq)
        total = sum(c["s"] for c in charges.values())
        if total > 0:
            if short:
                # identification goes by stream lag, not charge magnitude:
                # however small the censored tail reads, the rank that
                # stopped stamping while the world kept going is
                # definitionally the rank the run ended waiting on — the
                # most-behind stream (ties: larger charge) is the verdict,
                # and it matches POSTMORTEM verdict=straggler by design
                worst_rank = min(
                    short, key=lambda r: (short[r], -charges[r]["s"])
                )
            else:
                worst_rank = max(charges, key=lambda r: charges[r]["s"])
            w = charges[worst_rank]
            lines.append(
                f"CRITICAL-PATH kind=collective rank={worst_rank} "
                f"op={w['op']} seq={w['seq']} share={w['s'] / total:.3f}"
            )
            for rank, c in charges.items():
                blame[(rank, c["op"])] = blame.get((rank, c["op"]), 0.0) + c["s"]
            coll_out = {
                "total_s": total,
                "charges": [
                    {"rank": r, "s": c["s"], "share": c["s"] / total,
                     "op": c["op"], "seq": c["seq"]}
                    for r, c in sorted(
                        charges.items(), key=lambda kv: -kv[1]["s"]
                    )
                ],
            }

    total_blame = sum(blame.values())
    by_rank: Dict[int, float] = {}
    by_op: Dict[str, float] = {}
    for (rank, op), secs in blame.items():
        by_rank[rank] = by_rank.get(rank, 0.0) + secs
        by_op[op] = by_op.get(op, 0.0) + secs
    return {
        "steps": steps_out,
        "collective": coll_out,
        "lines": lines,
        "blame": {
            "total_s": total_blame,
            "by_rank": {
                str(r): {"s": s, "share": (s / total_blame if total_blame else 0.0)}
                for r, s in sorted(by_rank.items(), key=lambda kv: -kv[1])
            },
            "by_op": {
                op: {"s": s, "share": (s / total_blame if total_blame else 0.0)}
                for op, s in sorted(by_op.items(), key=lambda kv: -kv[1])
            },
        },
    }


def _fmt_table(rows: List[List[str]], header: List[str]) -> str:
    widths = [max(len(str(r[i])) for r in [header] + rows) for i in range(len(header))]
    fmt = "  ".join(f"{{:<{w}}}" for w in widths)
    lines = [fmt.format(*header), fmt.format(*("-" * w for w in widths))]
    lines += [fmt.format(*(str(c) for c in r)) for r in rows]
    return "\n".join(lines)


def clock_report(bundle: dict) -> str:
    """Greppable ``CLOCK-ALIGN`` lines: one per aligned rank (offset,
    worst anchor residual, anchor count) and one per NAMED unaligned
    rank."""
    align = bundle["align"]
    out = []
    for r in sorted(align.get("per_rank", {})):
        q = align["per_rank"][r]
        out.append(
            f"CLOCK-ALIGN rank={r} offset_ms={q['offset_s'] * 1e3:+.3f} "
            f"residual_ms={q['max_residual_s'] * 1e3:.3f} anchors={q['anchors']}"
        )
    for u in align.get("unaligned", []):
        out.append(f"CLOCK-ALIGN rank={u['rank']} UNALIGNED reason={u['reason']}")
    return "\n".join(out)


def critical_path_report(
    bundle: dict, step_names: Optional[Tuple[str, ...]] = None
) -> str:
    """CRITICAL-PATH lines + the per-rank / per-op blame tables; '' when
    the artifacts hold nothing attributable (no step spans AND fewer than
    two stamped rings)."""
    cp = critical_path(bundle, step_names)
    if not cp["lines"]:
        return ""
    out = ["-- critical path (aligned cross-rank attribution) --"]
    out.extend(cp["lines"])
    blame = cp["blame"]
    if blame["total_s"] > 0:
        out.append("-- blame: share of total critical time --")
        out.append(_fmt_table(
            [
                [r, f"{v['s'] * 1e3:.1f}", f"{v['share']:.3f}"]
                for r, v in blame["by_rank"].items()
            ],
            ["rank", "ms", "share"],
        ))
        out.append(_fmt_table(
            [
                [op, f"{v['s'] * 1e3:.1f}", f"{v['share']:.3f}"]
                for op, v in blame["by_op"].items()
            ],
            ["op", "ms", "share"],
        ))
    return "\n".join(out)
