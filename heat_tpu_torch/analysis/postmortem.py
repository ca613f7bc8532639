"""Cross-rank collective post-mortem: name the diverging rank, seq, straggler.

    python heat_tpu_torch/analysis/postmortem.py FLIGHT_DIR [--heartbeats DIR]
                                 [--telemetry DIR] [--json OUT] [--context N]

Merges the per-rank flight-recorder rings (``flight_rank<k>.ring``,
written crash-durably by ``heat_tpu_torch.utils.flightrec``) — optionally
joined with the heartbeat beacons and the telemetry JSONL exports — into
ONE verdict:

- ``desync``   — the first sequence number where rank fingerprints
  ``(op, gshape, dtype, src/dst split, wire bytes)`` differ: the classic
  SPMD divergence (a rank-conditional extra/missing collective).  Ranks
  are grouped by fingerprint; a minority group is named as deviating.
- ``straggler`` — fingerprints agree on the common window but one rank's
  sequence stops short: that rank is stuck at its last staged collective
  while its peers moved on.  The port's collectives block until every
  rank joins, so a rank wedged at staging holds its peers at its own seq:
  there every ring ends at the same seq, and the straggler is the rank
  without the ``enter`` record (past staging, into the transport) that
  its peers wrote, lag 0.  Wait-time evidence (the ``comm.<name>.wait``
  histograms exported through telemetry) is attached when available.
- ``clean``    — identical streams AND every rank's ring ends in a
  ``shutdown`` record (written by ``bootstrap.finalize_distributed``).
- ``inconclusive`` — no rings, no collective records, or identical
  streams without shutdown markers (a global stall looks like this:
  every rank stuck at the SAME collective).

The port's rings carry ``coll`` records (one a collective, at world size
2 and up) and lifecycle records, but no ``d`` dispatch records: the port
instruments no op dispatch, so a verdict names the collective and its
seq, never the op that ran before it.

Deliberately stdlib-only and standalone-loadable (the supervisor loads
this file via ``spec_from_file_location`` from a process that never
imports torch); the ring-format reader is borrowed from
``heat_tpu_torch/utils/flightrec.py``, itself loaded standalone, so there is
exactly one parser for the on-disk format.

Exit code: 0 when a verdict was produced (including ``clean``), 1 when
no rings were found/readable.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
from typing import Dict, List, Optional, Tuple

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_FLIGHTREC_PATH = os.path.join(_PKG, "utils", "flightrec.py")
_flightrec = None


def _flightrec_mod():
    """The ring-format reader, loaded standalone (never imports heat_tpu_torch or torch)."""
    global _flightrec
    if _flightrec is None:
        in_pkg = sys.modules.get("heat_tpu_torch.utils.flightrec")
        if in_pkg is not None:  # already imported (in-process tests)
            _flightrec = in_pkg
            return _flightrec
        spec = importlib.util.spec_from_file_location(
            "heat_postmortem_flightrec", _FLIGHTREC_PATH
        )
        mod = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = mod
        spec.loader.exec_module(mod)
        _flightrec = mod
    return _flightrec


# ---------------------------------------------------------------------- #
# loading
# ---------------------------------------------------------------------- #
def load_rings(flight_dir: str) -> Dict[int, dict]:
    """rank → parsed ring (unreadable files are skipped, not fatal — the
    black box must yield whatever it can after any crash)."""
    fr = _flightrec_mod()
    rings: Dict[int, dict] = {}
    for path in fr.find_ring_files(flight_dir):
        try:
            ring = fr.read_ring(path)
        except (OSError, ValueError):
            continue
        rings[int(ring["rank"])] = ring
    return rings


def load_heartbeats(hb_dir: Optional[str]) -> Dict[int, dict]:
    """rank → last heartbeat payload (+ file age in ``age_s``)."""
    import glob
    import time

    out: Dict[int, dict] = {}
    if not hb_dir:
        return out
    for path in sorted(glob.glob(os.path.join(hb_dir, "rank*.json"))):
        base = os.path.basename(path)[len("rank") : -len(".json")]
        try:
            rank = int(base)
        except ValueError:
            continue
        try:
            with open(path) as fh:
                rec = json.load(fh)
            rec["age_s"] = round(time.time() - os.path.getmtime(path), 1)
        except (OSError, ValueError):
            continue
        out[rank] = rec
    return out


def load_wait_hists(telemetry_dir: Optional[str]) -> Dict[int, Dict[str, dict]]:
    """rank → {histogram name → summary} for the ``*.wait`` histograms in
    the per-rank telemetry JSONL exports (last snapshot wins within a
    rank, like the telemetry merge)."""
    import glob

    out: Dict[int, Dict[str, dict]] = {}
    if not telemetry_dir:
        return out
    for path in sorted(glob.glob(os.path.join(telemetry_dir, "rank*.jsonl"))):
        try:
            with open(path) as fh:
                lines = fh.readlines()
        except OSError:
            continue
        for line in lines:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if rec.get("type") != "hist" or not str(rec.get("name", "")).endswith(
                ".wait"
            ):
                continue
            rank = int(rec.get("rank", 0))
            out.setdefault(rank, {})[rec["name"]] = {
                "count": int(rec.get("count", 0)),
                "total_s": round(float(rec.get("total_s", 0.0)), 3),
                "max_s": round(float(rec.get("max_s", 0.0)), 3),
            }
    return out


# ---------------------------------------------------------------------- #
# analysis
# ---------------------------------------------------------------------- #
_FP_FIELDS = ("op", "gshape", "dtype", "src", "dst", "wire")


def _fingerprint(rec: dict, fields: Tuple[str, ...] = _FP_FIELDS) -> Tuple:
    return tuple(
        tuple(v) if isinstance(v := rec.get(f), list) else v for f in fields
    )


def _common_fp_fields(recs: List[dict]) -> Tuple[str, ...]:
    """The fingerprint fields comparable across ``recs``: when any record
    was truncated (``trunc=1`` — the ring writer shed its bulky fields,
    e.g. ``gshape``, to fit the slot), a field absent from SOME records is
    dropped from the comparison rather than read as a divergence — slot
    truncation is per-rank (payload byte lengths differ by rank) and must
    never convict an innocent rank of desync."""
    if not any(rec.get("trunc") for rec in recs):
        return _FP_FIELDS
    return tuple(f for f in _FP_FIELDS if all(f in rec for rec in recs))


def _coll_by_seq(ring: dict) -> Dict[int, dict]:
    return {
        int(r["seq"]): r
        for r in ring.get("records", [])
        if r.get("k") == "coll" and "seq" in r
    }


def _entered(ring: dict) -> set:
    """The seqs whose transport the rank went into (its ``enter`` records)."""
    return {
        int(r["seq"])
        for r in ring.get("records", [])
        if r.get("k") == "enter" and "seq" in r
    }


def _fp_brief(rec: Optional[dict]) -> Optional[dict]:
    if rec is None:
        return None
    out = {f: rec.get(f) for f in _FP_FIELDS if rec.get(f) is not None}
    out["seq"] = rec.get("seq")
    return out


def analyze(
    rings: Dict[int, dict],
    heartbeats: Optional[Dict[int, dict]] = None,
    waits: Optional[Dict[int, Dict[str, dict]]] = None,
    expected_ranks: Optional[List[int]] = None,
) -> dict:
    """Merge per-rank rings into one verdict (see the module docstring for
    the taxonomy).

    ``expected_ranks`` is the world the caller launched (the supervisor
    and the mp launcher pass it): a rank whose ring is MISSING can then
    never hide inside a ``clean`` verdict — a lost black box on a known
    rank is itself the finding.  Independent of it, a rank whose ring
    exists but holds no collective records while peers progressed is
    named a straggler stuck at seq 0 (died/wedged before its first
    collective) instead of being silently dropped from the analysis."""
    verdict: dict = {
        "verdict": "inconclusive",
        "ranks": sorted(rings),
        "last_seq": {},
        "first_divergent_seq": None,
        "divergence": None,
        "straggler": None,
        "detail": "",
    }
    missing = (
        sorted(set(int(r) for r in expected_ranks) - set(rings))
        if expected_ranks is not None
        else []
    )
    if missing:
        verdict["missing_ranks"] = missing
    if heartbeats:
        verdict["heartbeats"] = {
            str(r): {
                k: hb.get(k)
                for k in ("step", "seq", "collective", "status", "age_s")
                if hb.get(k) is not None
            }
            for r, hb in sorted(heartbeats.items())
        }
    if not rings:
        verdict["detail"] = "no flight-recorder ring files found" + (
            f" for rank(s) {missing}" if missing else ""
        )
        return verdict
    # torn/unparseable slots the reader skipped (flightrec.read_ring
    # counts them per ring): on every verdict path, so a lossy ring can
    # never pass for a complete stream — a "clean" verdict over a ring
    # with holes is not clean evidence
    skipped = {
        str(r): rings[r].get("slots_skipped", 0)
        for r in sorted(rings)
        if rings[r].get("slots_skipped")
    }
    if skipped:
        verdict["slots_skipped"] = skipped
    colls = {r: _coll_by_seq(ring) for r, ring in rings.items()}
    with_colls = [r for r in sorted(colls) if colls[r]]
    coll_less = [r for r in sorted(colls) if not colls[r]]
    if with_colls:
        last_seq = {r: max(colls[r]) for r in with_colls}
        verdict["last_seq"] = {str(r): last_seq[r] for r in with_colls}

    # ---- oom: an explicit allocation-failure dump (memory-ledger ``mem``
    # record with oom=1, written by utils.memledger.dump_oom before the
    # error re-raised) is a CAUSE, not a symptom — it outranks every
    # stream heuristic below.  Earliest dump wins when several ranks blew
    # up; the membuf records that follow it carry the dominant live
    # buffers with their minting provenance. ----------------------------- #
    oom_hits = []
    for r in sorted(rings):
        for rec in rings[r].get("records", []):
            if rec.get("k") == "mem" and rec.get("oom"):
                oom_hits.append((rec.get("t", 0), r, rec))
    if oom_hits:
        oom_hits.sort(key=lambda x: x[0])
        _, r, rec = oom_hits[0]
        # ONLY the membuf records of THIS dump: they follow their oom
        # record contiguously (the ledger writes them in one burst), and a
        # ring may hold several dumps (an earlier end-of-step attestation,
        # a second OOM) whose rows must not interleave stale duplicates
        top = []
        seen_i = set()
        collecting = False
        for x in rings[r].get("records", []):
            if x is rec:
                collecting = True
                continue
            if not collecting:
                continue
            if x.get("k") == "membuf":
                i = x.get("i")
                if i in seen_i:
                    break  # a LATER dump's burst restarted its index
                seen_i.add(i)
                top.append(x)
            elif x.get("k") == "mem" and (x.get("oom") or x.get("att")):
                # the next DUMP's header (a second OOM, or an attestation
                # written by dump_to_ring — tagged att=1): its rows belong
                # to it, not this failure — even when THIS dump wrote zero
                # membuf rows (every live buffer under the dispatch
                # threshold), the later burst must not be absorbed
                break
            # anything else — a racing coalesced "d" record, or a
            # concurrent thread's peak-WATERMARK "mem" record landing
            # mid-burst (the dump's rows are separate unlocked appends) —
            # interleaves without ending the collection
        top.sort(key=lambda x: (x.get("i", 1 << 30), -(x.get("nb") or 0)))
        verdict["verdict"] = "oom"
        verdict["oom"] = {
            "rank": r,
            "req_bytes": rec.get("req"),
            "where": rec.get("where"),
            "live_bytes": rec.get("live"),
            "peak_bytes": rec.get("peak"),
            "error": rec.get("err"),
            "top_buffers": top[:8],
        }
        head = top[0] if top else None
        verdict["detail"] = (
            f"rank {r} failed a {rec.get('req', '?')}-byte device allocation "
            f"at {rec.get('where', '?')} with {rec.get('live', '?')} bytes "
            "live"
            + (
                f"; dominant live buffer: {head.get('op')} "
                f"({head.get('nb')} B, {head.get('cat')})"
                if head
                else ""
            )
        )
        return verdict

    if not with_colls:
        verdict["detail"] = "rings contain no collective records"
        return verdict
    first_seq = {r: min(colls[r]) for r in with_colls}

    # ---- desync: first seq (inside the window every ring still holds)
    # where the rank fingerprints differ ------------------------------- #
    lo = max(first_seq.values())
    hi = min(last_seq.values())
    for s in range(lo, hi + 1):
        present = {r: colls[r].get(s) for r in with_colls}
        held = [rec for rec in present.values() if rec is not None]
        fields = _common_fp_fields(held)
        groups: Dict[Tuple, List[int]] = {}
        for r, rec in present.items():
            if rec is not None:
                groups.setdefault(_fingerprint(rec, fields), []).append(r)
        if len(groups) > 1:
            # minority group deviates (ties — e.g. 2 ranks — name all)
            sizes = sorted(len(v) for v in groups.values())
            minority = [
                r for fp, rs in groups.items() if len(rs) == sizes[0] for r in rs
            ]
            majority_possible = sizes[0] < sizes[-1]
            verdict["verdict"] = "desync"
            verdict["first_divergent_seq"] = s
            verdict["divergence"] = {
                str(r): _fp_brief(present[r]) for r in with_colls
            }
            verdict["deviating_ranks"] = sorted(minority) if majority_possible else sorted(
                with_colls
            )
            ops = ", ".join(
                f"rank {r}: {present[r].get('op')}" for r in sorted(present)
                if present[r] is not None
            )
            verdict["detail"] = (
                f"rank fingerprints diverge at seq {s} ({ops})"
                + (
                    f"; minority rank(s) {sorted(minority)} deviate"
                    if majority_possible
                    else "; 2-way split — cannot vote on the deviant"
                )
            )
            return verdict

    # ---- straggler: identical window, but someone's stream stops short.
    # A ring with NO collective records while peers progressed is the
    # extreme case — that rank died or wedged before its first collective
    # (seq 0), and silently dropping it would let a clean verdict lie. #
    global_max = max(last_seq.values())
    behind = sorted(r for r in with_colls if last_seq[r] < global_max)
    # every stream ends at one seq: under blocking collectives the ranks in
    # its transport wait on the ranks that stamped it and never went in
    waiting = unentered = []
    if not (coll_less or behind):
        inside = {r: global_max in _entered(rings[r]) for r in with_colls}
        waiting = [r for r in with_colls if inside[r]]
        unentered = [r for r in with_colls if not inside[r]] if waiting else []
    if coll_less or behind or unentered:
        if coll_less:
            worst, worst_seq, stuck = min(coll_less), 0, None
            behind = sorted(set(behind) | set(coll_less))
        elif unentered:
            worst, worst_seq = min(unentered), global_max
            stuck = colls[worst][worst_seq]
            behind = unentered
        else:
            worst = min(behind, key=lambda r: last_seq[r])
            worst_seq = last_seq[worst]
            stuck = colls[worst][worst_seq]
        verdict["verdict"] = "straggler"
        verdict["straggler"] = {
            "rank": worst,
            "ranks_behind": behind,
            "seq": worst_seq,
            "op": stuck.get("op") if stuck else None,
            "fingerprint": _fp_brief(stuck),
            "lag": global_max - worst_seq,
            "peers_at": global_max,
        }
        if unentered:
            verdict["straggler"]["waiting"] = waiting
        if waits and waits.get(worst):
            top = sorted(
                waits[worst].items(), key=lambda kv: -kv[1]["total_s"]
            )[:3]
            verdict["straggler"]["wait"] = dict(top)
        if unentered:
            verdict["detail"] = (
                f"rank {worst} stuck at seq {worst_seq} {stuck.get('op')} "
                "before its transport while rank(s) "
                f"{waiting} wait in it (lag 0)"
            )
        elif stuck is not None:
            verdict["detail"] = (
                f"rank {worst} stuck at seq {worst_seq} "
                f"{stuck.get('op')} while peers reached seq {global_max} "
                f"(lag {global_max - worst_seq})"
            )
        else:
            verdict["detail"] = (
                f"rank {worst} staged no collectives (stuck at seq 0) "
                f"while peers reached seq {global_max}"
            )
        if waits:
            verdict["wait_per_rank"] = {
                str(r): w for r, w in sorted(waits.items())
            }
        return verdict

    # ---- identical streams: clean iff every ring ends in shutdown ----- #
    def _has_shutdown(ring: dict) -> bool:
        return any(r.get("k") == "shutdown" for r in ring.get("records", []))

    if missing:
        # a lost black box on a known rank can never hide inside `clean`:
        # the surviving streams agree, but the world's story is incomplete
        verdict["detail"] = (
            f"rank(s) {missing} left no ring file while the surviving "
            f"rank(s) agree through seq {global_max} — cannot attest clean"
        )
    elif all(_has_shutdown(rings[r]) for r in with_colls):
        verdict["verdict"] = "clean"
        verdict["detail"] = (
            f"all {len(with_colls)} rank(s) agree through seq {global_max} "
            "and recorded a clean shutdown"
        )
    else:
        stuck = colls[with_colls[0]][global_max]
        verdict["detail"] = (
            f"all ranks at seq {global_max} ({stuck.get('op')}) with no "
            "shutdown record — global stall, or the run was cut before "
            "teardown"
        )
    return verdict


def analyze_dir(
    flight_dir: str,
    heartbeat_dir: Optional[str] = None,
    telemetry_dir: Optional[str] = None,
    expected_ranks: Optional[List[int]] = None,
) -> dict:
    """Load + analyze one run's artifacts."""
    rings = load_rings(flight_dir)
    return analyze(
        rings,
        heartbeats=load_heartbeats(heartbeat_dir),
        waits=load_wait_hists(telemetry_dir),
        expected_ranks=expected_ranks,
    )


def verdict_rank(verdict: dict) -> Optional[int]:
    """The single rank a verdict convicts, or None when it names none
    (inconclusive) or cannot narrow to one (a multi-rank desync tie).
    The chaos blame oracle cross-checks this against the schedule's
    injected victim: a verdict naming the WRONG rank is a diagnosis
    failure even when the run otherwise recovered."""
    kind = verdict.get("verdict")
    if kind == "straggler":
        r = (verdict.get("straggler") or {}).get("rank")
        return int(r) if r is not None else None
    if kind == "oom":
        r = (verdict.get("oom") or {}).get("rank")
        return int(r) if r is not None else None
    if kind == "desync":
        ranks = verdict.get("deviating_ranks") or []
        if len(ranks) == 1:
            return int(ranks[0])
    return None


def summary_line(verdict: dict, epoch: Optional[int] = None) -> str:
    """The one-line form launchers print (``POSTMORTEM verdict=…``)."""
    parts = ["POSTMORTEM"]
    if epoch is not None:
        parts.append(f"epoch={epoch}")
    parts.append(f"verdict={verdict.get('verdict')}")
    s = verdict.get("straggler")
    o = verdict.get("oom")
    if o:
        parts.append(f"rank={o['rank']} req={o.get('req_bytes')} "
                     f"where={o.get('where')}")
        top = o.get("top_buffers") or []
        if top:
            parts.append(f"top={top[0].get('op')}:{top[0].get('nb')}")
    elif s:
        parts.append(f"rank={s['rank']} seq={s['seq']} op={s['op']} lag={s['lag']}")
    elif verdict.get("first_divergent_seq") is not None:
        parts.append(f"seq={verdict['first_divergent_seq']}")
        dev = verdict.get("deviating_ranks")
        if dev:
            parts.append("ranks=" + ",".join(str(r) for r in dev))
    return " ".join(parts)


# ---------------------------------------------------------------------- #
# rendering
# ---------------------------------------------------------------------- #
def render_grid(
    rings: Dict[int, dict], around: Optional[int] = None, context: int = 5
) -> str:
    """seq × rank grid of collective fingerprints, centered on ``around``
    (or the tail).  ``*`` marks rows where ranks disagree; ``·`` marks a
    rank with no record at that seq."""
    colls = {r: _coll_by_seq(ring) for r, ring in sorted(rings.items())}
    ranks = [r for r in sorted(colls) if colls[r]]
    if not ranks:
        return "(no collective records)"
    lo = min(min(c) for c in colls.values() if c)
    hi = max(max(c) for c in colls.values() if c)
    if around is None:
        around = hi
    s0 = max(lo, around - context)
    s1 = min(hi, around + context)

    def cell(rec: Optional[dict]) -> str:
        if rec is None:
            return "·"
        bits = [str(rec.get("op"))]
        if rec.get("gshape") is not None:
            bits.append("x".join(str(v) for v in rec["gshape"]))
        if rec.get("wire") is not None:
            bits.append(f"{rec['wire']}B")
        return " ".join(bits)

    header = ["seq"] + [f"rank{r}" for r in ranks] + [""]
    rows = []
    for s in range(s0, s1 + 1):
        recs = [colls[r].get(s) for r in ranks]
        held = [rec for rec in recs if rec is not None]
        fields = _common_fp_fields(held)
        fps = {_fingerprint(rec, fields) for rec in held}
        mark = "*" if (len(fps) > 1 or any(rec is None for rec in recs)) else ""
        rows.append([str(s)] + [cell(rec) for rec in recs] + [mark])
    widths = [max(len(r[i]) for r in [header] + rows) for i in range(len(header))]
    fmt = "  ".join(f"{{:<{w}}}" for w in widths)
    lines = [fmt.format(*header), fmt.format(*("-" * w for w in widths))]
    lines += [fmt.format(*row) for row in rows]
    return "\n".join(lines)


def render(verdict: dict, rings: Optional[Dict[int, dict]] = None) -> str:
    out = [summary_line(verdict), verdict.get("detail", "")]
    if verdict.get("missing_ranks"):
        out.append(
            "rank(s) with NO ring file: "
            + ", ".join(str(r) for r in verdict["missing_ranks"])
        )
    # verdict dicts key ranks by str() (JSON round-trip safety): sort the
    # report numerically or rank 10 renders before rank 2 at pod scale
    by_rank = lambda kv: int(kv[0])  # noqa: E731
    if verdict.get("slots_skipped"):
        out.append(
            "torn/unparseable ring slot(s) skipped — the stream(s) below "
            "have holes: "
            + ", ".join(
                f"rank {r}: {n}"
                for r, n in sorted(verdict["slots_skipped"].items(), key=by_rank)
            )
        )
    if verdict.get("last_seq"):
        out.append(
            "last staged seq per rank: "
            + ", ".join(
                f"rank {r}: {s}"
                for r, s in sorted(verdict["last_seq"].items(), key=by_rank)
            )
        )
    hbs = verdict.get("heartbeats")
    if hbs:
        for r, hb in sorted(hbs.items(), key=by_rank):
            fields = " ".join(f"{k}={v}" for k, v in hb.items())
            out.append(f"heartbeat rank {r}: {fields}")
    o = verdict.get("oom")
    if o:
        out.append(
            f"rank {o['rank']} OOM at {o.get('where')}: requested "
            f"{o.get('req_bytes')} B with {o.get('live_bytes')} B live "
            f"(peak {o.get('peak_bytes')} B); dominant live buffers:"
        )
        for b in o.get("top_buffers") or []:
            prov = f"op={b.get('op')} cat={b.get('cat')}"
            if b.get("span"):
                prov += f" span={b['span']}"
            if b.get("tid"):
                prov += f" trace={b['tid']}"
            out.append(f"  {b.get('nb')} B  {prov}")
    s = verdict.get("straggler")
    if s and s.get("wait"):
        out.append(f"rank {s['rank']} blocking-wait evidence:")
        for name, w in s["wait"].items():
            out.append(
                f"  {name}: n={w['count']} total={w['total_s']}s max={w['max_s']}s"
            )
    if rings:
        around = verdict.get("first_divergent_seq")
        if around is None and s:
            around = s.get("seq")
        out.append("")
        out.append("-- collective timeline (seq × rank) --")
        out.append(render_grid(rings, around=around))
    return "\n".join(line for line in out if line is not None)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("flight_dir", help="directory holding flight_rank*.ring files")
    ap.add_argument("--heartbeats", default=None, help="heartbeat beacon dir")
    ap.add_argument("--telemetry", default=None, help="telemetry jsonl export dir")
    ap.add_argument("--json", default=None, help="also write the verdict here")
    ap.add_argument("--context", type=int, default=5,
                    help="grid rows either side of the point of interest")
    ap.add_argument("--expected-ranks", type=int, default=None, metavar="N",
                    help="world size launched: a rank 0..N-1 whose ring is "
                         "missing blocks a clean verdict")
    args = ap.parse_args(argv)

    rings = load_rings(args.flight_dir)
    verdict = analyze(
        rings,
        heartbeats=load_heartbeats(args.heartbeats),
        waits=load_wait_hists(args.telemetry),
        expected_ranks=(
            list(range(args.expected_ranks))
            if args.expected_ranks is not None
            else None
        ),
    )
    print(render(verdict, rings))
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(verdict, fh, indent=1)
        print(f"\nverdict JSON written to {args.json}")
    if not rings:
        print(f"no flight_rank*.ring files under {args.flight_dir}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
