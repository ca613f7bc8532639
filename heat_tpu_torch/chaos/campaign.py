#!/usr/bin/env python3
"""chaoscamp — the deterministic chaos campaign runner.

Sweeps seeded fault schedules (drawn from ``faults.catalog()``) against
real supervised worker processes, judges every run with the invariant
oracle suite, auto-shrinks failures to minimal reproducers, and writes a
crash-durable, resumable campaign journal.

    # a 50-schedule campaign (the CI lane's shape)
    python heat_tpu_torch/chaos/campaign.py --seed 20260807 --count 50 --out /tmp/camp

    # resume a killed campaign: finished indices are skipped
    python heat_tpu_torch/chaos/campaign.py --seed 20260807 --count 50 --out /tmp/camp --resume

    # replay one schedule from a CHAOS-REPRO line (token or whole line)
    python heat_tpu_torch/chaos/campaign.py --replay 'eyJmYXVsdHMiOi...'

    # run a legacy full-tier scenario by name, its ranks on the card
    # (--device cpu: on the CPU)
    python heat_tpu_torch/chaos/campaign.py --scenario fed-world-kill

Exit codes: 0 = every schedule passed every oracle; 1 = at least one
failure (reproducers printed); 2 = usage error.

Stdlib-only; never imports torch (the engine's workers do their own
imports in their own processes).
"""

import argparse
import importlib.util
import json
import os
import sys
import tempfile

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))  # the heat_tpu_torch package


def _load(name, relpath):
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(PKG, relpath)
    )
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="chaoscamp", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("--seed", type=int, default=0, help="campaign seed")
    ap.add_argument("--count", type=int, default=50,
                    help="number of schedules to sweep")
    ap.add_argument("--out", default=None,
                    help="campaign directory (journal + failing run dirs)")
    ap.add_argument("--resume", action="store_true",
                    help="skip indices already in the campaign journal")
    ap.add_argument("--keep", action="store_true",
                    help="keep passing run directories too")
    ap.add_argument("--no-shrink", action="store_true",
                    help="report failures without shrinking them")
    ap.add_argument("--workloads", default="train,serve,fed",
                    help="comma list of workloads to draw from")
    ap.add_argument("--replay", metavar="TOKEN",
                    help="run ONE schedule from a CHAOS-REPRO token/line")
    ap.add_argument("--scenario", metavar="NAME",
                    help="run one legacy full-tier scenario by name")
    ap.add_argument("--device", choices=("gpu", "cpu"), default="gpu",
                    help="where a --scenario world's ranks run (default: the card)")
    ap.add_argument("--list-scenarios", action="store_true")
    ap.add_argument("--print-schedule", metavar="TOKEN",
                    help="decode and pretty-print a schedule token, no run")
    args = ap.parse_args(argv)

    sched_mod = _load("heat_chaos_schedule", "chaos/schedule.py")

    if args.print_schedule:
        tok = args.print_schedule
        sched = (sched_mod.parse_repro(tok) if "CHAOS-REPRO" in tok
                 else sched_mod.schedule_from_token(tok))
        print(json.dumps(sched, indent=2, sort_keys=True))
        return 0

    if args.list_scenarios:
        scn = _load("heat_chaos_scenarios", "chaos/scenarios.py")
        for name, spec in sorted(scn.SCENARIOS.items()):
            print(f"{name}: mode={spec['mode']} n_proc={spec['n_proc']}")
        return 0

    if args.scenario:
        scn = _load("heat_chaos_scenarios", "chaos/scenarios.py")
        print(f"CHAOS-SCENARIO {args.scenario} launching", flush=True)
        proc = scn.run_scenario(args.scenario, device=args.device)
        bad = scn.check_scenario(args.scenario, proc)
        tail = proc.stdout[-3000:]
        if bad:
            print(tail)
            for b in bad:
                print(f"CHAOS-SCENARIO {args.scenario} VIOLATION: {b}")
            return 1
        print(f"CHAOS-SCENARIO {args.scenario} ok")
        return 0

    engine = _load("heat_chaos_engine", "chaos/engine.py")

    if args.replay:
        tok = args.replay
        sched = (sched_mod.parse_repro(tok) if "CHAOS-REPRO" in tok
                 else sched_mod.schedule_from_token(tok))
        out = args.out or os.path.join(
            tempfile.gettempdir(), f"chaos_replay_{sched_mod.schedule_digest(sched)}"
        )
        print(json.dumps(sched, indent=2, sort_keys=True))
        verdict = engine.run_schedule(sched, out, keep=True)
        print(engine.verdict_table([verdict]))
        if verdict["ok"]:
            print(f"CHAOS-REPLAY ok (evidence kept at {out})")
            return 0
        for name, detail in verdict["oracles"].items():
            if detail is not True:
                print(f"CHAOS-REPLAY oracle {name}: {detail}")
        print(sched_mod.repro_line(sched, verdict["fails"][0]))
        print(f"CHAOS-REPLAY FAIL (evidence at {out})")
        return 1

    if not args.out:
        ap.error("--out is required for a campaign run")
    workloads = tuple(w for w in args.workloads.split(",") if w)
    summary = engine.run_campaign(
        args.seed, args.count, args.out,
        shrink_failures=not args.no_shrink,
        keep=args.keep,
        resume=args.resume,
        modes=workloads,
    )
    print(summary["table"])
    print(f"CHAOS-JOURNAL {os.path.join(args.out, 'campaign.jsonl')}")
    for line in summary["repro_lines"]:
        print(line)
    return 1 if summary["failures"] else 0


if __name__ == "__main__":
    sys.exit(main())
