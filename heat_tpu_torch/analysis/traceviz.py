"""Cross-rank timeline export: Perfetto traces, clock alignment, blame.

    python heat_tpu_torch/analysis/traceviz.py DIR [DIR...] [--out trace.json]
                               [--steps daso.step,sched.job] [--json OUT]
    python heat_tpu_torch/analysis/traceviz.py --validate-only trace.json

Merges every artifact the runtime already wrote under the target dirs —
telemetry ``rank<k>.jsonl`` exports, flight-recorder rings (including the
supervisor's harvested ``epoch<N>/`` subdirs), scheduler/federation
journals — into ONE clock-aligned cross-rank timeline
(``heat_tpu_torch/analysis/timeline.py``, loaded standalone: this runs on a
login node that never imports torch).  Prints:

- ``CLOCK-ALIGN rank=… offset_ms=… residual_ms=… anchors=…`` per rank
  (offsets estimated from the shared collective-stamp anchors; a rank
  with no anchors is NAMED unaligned, never silently merged);
- ``CRITICAL-PATH kind=… rank=… op=… seq=… share=…`` per step kind and
  for the cross-rank collective gating chain, plus the per-rank /
  per-op blame tables;
- ``TRACE-EXPORT events=… ranks=… out=…`` after writing the Chrome
  trace-event JSON (``--out``), which is self-validated against the
  stdlib schema checker before this exits 0.

Empty target dirs are not an error (exit 0): a run that recorded nothing
has an empty timeline, not a broken one.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))

_timeline = None


def _timeline_mod():
    """``heat_tpu_torch/analysis/timeline.py`` — via the package when loaded,
    else standalone (the postmortem pattern)."""
    mod = sys.modules.get("heat_tpu_torch.analysis.timeline")
    if mod is not None:
        return mod
    global _timeline
    if _timeline is None:
        import importlib.util

        path = os.path.join(_HERE, "timeline.py")
        spec = importlib.util.spec_from_file_location("traceviz_timeline", path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = mod
        spec.loader.exec_module(mod)
        _timeline = mod
    return _timeline


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("targets", nargs="*",
                    help="dirs holding telemetry jsonl / flight rings / journals")
    ap.add_argument("--out", default=None, metavar="TRACE_JSON",
                    help="write the Chrome trace-event JSON here")
    ap.add_argument("--steps", default=None,
                    help="comma-separated step span names (default: stepprof's)")
    ap.add_argument("--json", default=None, metavar="OUT",
                    help="also write the critical-path/alignment structure here")
    ap.add_argument("--validate-only", default=None, metavar="TRACE_JSON",
                    help="schema-check an existing trace file and exit")
    args = ap.parse_args(argv)
    tl = _timeline_mod()

    if args.validate_only:
        try:
            with open(args.validate_only) as fh:
                obj = json.load(fh)
        except (OSError, ValueError) as e:
            print(f"unreadable trace {args.validate_only}: {e}", file=sys.stderr)
            return 1
        problems = tl.validate_chrome_trace(obj)
        if problems:
            for p in problems:
                print(f"INVALID: {p}", file=sys.stderr)
            return 1
        n = len(obj.get("traceEvents", []))
        print(f"TRACE-VALID events={n} file={args.validate_only}")
        return 0

    if not args.targets:
        print("nothing to do: no target dirs (and no --validate-only)",
              file=sys.stderr)
        return 1
    step_names = (
        tuple(s.strip() for s in args.steps.split(",") if s.strip())
        if args.steps else tl.DEFAULT_STEPS
    )
    bundle = tl.assemble(list(args.targets), step_names=step_names)
    if not bundle["ranks"] and not bundle["journals"]:
        # an empty (or artifact-less) dir is an empty timeline, not an error
        print(f"no telemetry/ring/journal artifacts under {args.targets}")
        return 0

    clock = tl.clock_report(bundle)
    if clock:
        print(clock)
    report = tl.critical_path_report(bundle)
    if report:
        print(report)

    trace = tl.to_chrome_trace(bundle)
    problems = tl.validate_chrome_trace(trace)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(trace, fh)
        print(
            f"TRACE-EXPORT events={len(trace['traceEvents'])} "
            f"ranks={len(bundle['ranks'])} out={args.out}"
        )
    if problems:
        # exporting a trace our own checker rejects is a bug, not a warning
        for p in problems:
            print(f"INVALID: {p}", file=sys.stderr)
        return 1
    if args.json:
        cp = tl.critical_path(bundle, step_names)
        with open(args.json, "w") as fh:
            json.dump({"align": bundle["align"], "critical_path": cp}, fh, indent=1)
        print(f"critical-path JSON written to {args.json}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
