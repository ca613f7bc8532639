#!/usr/bin/env python3
"""Which ``torch.profiler`` sessions record no device activity: back to back
and spaced apart, in a process before and after ranks it spawned on the
card have exited.

    python3 scripts/profiler_probe.py [--teardown]

Each session profiles one ``sin`` or ``cos`` of 1e7 float32 on the card
(CUDA activity only; one series with the CPU's too) and counts the device
rows of its ``key_averages()``.  The series: the first session; 30 back to
back, 8 a second apart, 4 three seconds apart, 20 back to back, all before
any spawn; then, after ``chip_smoke.index_rank`` ran on 2 spawned ranks on
this card and exited, 8 a second apart, 4 three seconds apart, 20 back to
back, 10 back to back with the CPU's activity, 4 three seconds apart after
30 s of quiet; 4 back to back in each of 2 newly spawned ranks; 6 a second
apart after those exit.  Prints one JSON line a series: its empty sessions
of all, whether a session that recorded saw its own operation, and each
session's start, wall seconds and row count, and last the seconds the
whole probe took.  With ``--teardown`` each session of this process runs
with ``TEARDOWN_CUPTI=1`` in the environment, so that the profiler
finalizes CUPTI after it and the next session starts CUPTI afresh, as
``chip_smoke.profiled`` does; spawned ranks never get it.  The probe
leaves by ``os._exit``: with ``--teardown`` the interpreter's exit hung
on an H100.  Without CUDA it exits 2 at once.
"""

import json
import os
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import torch  # noqa: E402

X = None
T0 = time.perf_counter()
TEARDOWN = False  # set in main(): spawned ranks import this module afresh


def session(op, cpu=False):
    """One profiled ``X.sin()`` or ``X.cos()``: its start, wall seconds, the
    number of device rows and whether they name each operation."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if cpu else [ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    t = time.perf_counter()
    if TEARDOWN:
        os.environ["TEARDOWN_CUPTI"] = "1"
    try:
        with profile(activities=acts) as prof:
            (X.sin() if op == "sin" else X.cos())
            torch.cuda.synchronize()
    finally:
        os.environ.pop("TEARDOWN_CUPTI", None)
    names = [e.key for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    return {"t": round(t - T0, 2), "op": op, "wall": round(time.perf_counter() - t, 3), "n": len(names),
            "sin": any("sin" in k.lower() for k in names), "cos": any("cos" in k.lower() for k in names)}


def series(label, count, gap, cpu=False):
    """``count`` sessions ``gap`` seconds apart, sin and cos in turn; prints
    the series' line."""
    rec = []
    for i in range(count):
        rec.append(session("sin" if i % 2 == 0 else "cos", cpu))
        time.sleep(gap)
    print(json.dumps({"series": label, "gap": gap, "cpu": cpu, "empty": sum(r["n"] == 0 for r in rec),
                      "of": count, "wrong_op": sum((r["op"] == "sin") != r["sin"] for r in rec if r["n"]),
                      "rec": rec}), flush=True)


def prof_rank(rank, port, out_q):
    """A spawned rank: 4 sessions back to back in a fresh process."""
    global X
    X = torch.rand(10_000_000, device="cuda")
    out_q.put((rank, [session("sin" if i % 2 == 0 else "cos") for i in range(4)]))


def main() -> int:
    global X, TEARDOWN
    if not torch.cuda.is_available():
        print("profiler_probe: torch.cuda.is_available() is False; this probe needs a GPU", file=sys.stderr)
        return 2
    import chip_smoke as cs

    TEARDOWN = "--teardown" in sys.argv[1:]
    X = torch.rand(10_000_000, device="cuda")
    series("A0 first", 1, 0.0)
    series("A1 rapid, no spawn yet", 30, 0.0)
    series("A2 1 s apart, no spawn yet", 8, 1.0)
    series("A3 3 s apart, no spawn yet", 4, 3.0)
    series("A4 rapid again, no spawn yet", 20, 0.0)
    cs.spawn_ranks(cs.index_rank, 2, 600)
    series("B1 1 s apart after spawn", 8, 1.0)
    series("B2 3 s apart after spawn", 4, 3.0)
    series("B3 rapid after spawn", 20, 0.0)
    series("B4 rapid after spawn, cpu too", 10, 0.0, cpu=True)
    time.sleep(30)
    series("B5 3 s apart after 30 s quiet", 4, 3.0)
    res = cs.spawn_ranks(prof_rank, 2, 600)
    print(json.dumps({"series": "C children profiling after a spawn", "res": res}), flush=True)
    series("C1 1 s apart after second spawn", 6, 1.0)
    print(cs.subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                            capture_output=True, text=True, timeout=60).stdout.strip())
    print(json.dumps({"teardown": TEARDOWN, "seconds": time.perf_counter() - T0}), flush=True)
    return 0


if __name__ == "__main__":
    code = main()
    # with --teardown the process can hang in the interpreter's exit (as
    # chip_smoke.py found), so it leaves at once, its output flushed
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)
