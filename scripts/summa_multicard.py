#!/usr/bin/env python3
"""``ht.matmul`` across cards, over NCCL: the SUMMA ring against the gather route.

    python3 scripts/summa_multicard.py [--ranks N] [--sizes 4096,8192,16384] [--reps K]

Spawns N processes (default: one a visible card), rank r on ``cuda:r`` in
the package's default process group (gloo for CPU tensors, NCCL for CUDA
tensors).  For each n of ``--sizes`` (default 4096, 8192 and 16384, the
north star's), two (n, n) float32 arrays split along rows (split 0 x split
0, BASELINE config 0's case) are multiplied by ``matmul_summa`` (b's row
blocks round the ring by NCCL send/recv, each transfer posted before the
block's GEMM) and by ``matmul(method='gspmd')`` (b gathered, one GEMM of
the local rows), in turns: summa, gather, gather, summa, each K times
(default 5) between barriers, the cards synchronised.  Rank 0 gathers each
product of the largest size and holds it against the world-1 product
``torch.matmul`` on its card, max |C - C1| over max |C1| <= 1e-5 (float32,
partial sums in another order); every size's products are held the same
way on the first K rows.  Prints one JSON line a size (ms, TFLOP/s a card
for each route, the communicator's traffic of one call), the card's name
and power limit, the ``_SUMMA_DISPATCH`` entry the times support (the
smallest n from which the ring wins at every measured size, or none), and
``{"ok": true, ...}`` last.  Without CUDA it exits 2 at once.  A failed
check or a rank that fails or hangs (``chip_smoke.spawn_ranks``) exits
non-zero.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
TIMEOUT_S = 600
RTOL = 1e-5


def _chip_smoke():
    """This checkout's chip_smoke.py: its rank spawner."""
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rel(got, want) -> float:
    """max |got - want| over max |want|, in float64."""
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / want.abs().max())


def _rank(rank: int, port: int, out_q, world: int, sizes, reps: int) -> None:
    sys.path.insert(0, str(HERE))
    import torch

    import heat_tpu_torch as ht

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", rank)
    torch.cuda.set_device(dev)
    ht.core.bootstrap.init_distributed(f"tcp://localhost:{port}", world_size=world, rank=rank, timeout_s=TIMEOUT_S)
    try:
        ht.use_device("gpu")
        comm = ht.core.communication.get_comm()
        res = {"rank": rank, "device": str(dev), "sizes": {}}
        for n in sizes:
            g = torch.Generator(device=dev).manual_seed(n)
            A = torch.randn(n, n, generator=g, device=dev)
            B = torch.randn(n, n, generator=g, device=dev)
            a, b = ht.array(A, split=0), ht.array(B, split=0)
            routes = {"summa": lambda: ht.linalg.matmul_summa(a, b),
                      "gather": lambda: ht.matmul(a, b, method="gspmd")}
            row = {"transport": {op: comm.transport(A, op) for op in ("Send", "Allgather")}}
            rows = min(reps, n)  # the first rows of the product, held at every size
            for name, fn in routes.items():
                comm.reset_traffic()
                c = fn()
                row[f"{name}_traffic"] = comm.traffic()
                full = comm.Allgatherv(c.larray, 0) if n == max(sizes) else c.larray[:rows]
                if rank == 0:
                    want = torch.matmul(A, B) if n == max(sizes) else torch.matmul(A[:rows], B)
                    row[f"{name}_rel_err"] = _rel(full if n == max(sizes) else full[:rows], want)
                    del want
                del c, full
            times = {"summa": [], "gather": []}
            for name in ("summa", "gather", "gather", "summa"):
                fn = routes[name]
                fn()
                torch.cuda.synchronize()
                comm.Barrier()
                t0 = time.perf_counter()
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
                comm.Barrier()
                times[name].append((time.perf_counter() - t0) * 1e3 / reps)
            row["ms"] = times
            row["peak_mem_bytes"] = torch.cuda.max_memory_allocated(dev)
            res["sizes"][n] = row
            del a, b, A, B
            torch.cuda.empty_cache()
        comm.Barrier()
        out_q.put((rank, res))
    finally:
        ht.core.bootstrap.finalize_distributed()


def fail(msg: str) -> None:
    raise RuntimeError(f"summa_multicard check failed: {msg}")


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=None, help="processes, one a card (default: the visible cards)")
    ap.add_argument("--sizes", default="4096,8192,16384", help="square sizes n, comma-separated")
    ap.add_argument("--reps", type=int, default=5, help="timed calls a turn")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("summa_multicard: torch.cuda.is_available() is False; this script needs CUDA cards", file=sys.stderr)
        return 2
    cards = torch.cuda.device_count()
    world = args.ranks or cards
    if not 2 <= world <= cards:
        fail(f"need 2 to {cards} ranks, one a card, got {world}")
    sizes = sorted(int(s) for s in args.sizes.split(","))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    results = _chip_smoke().spawn_ranks(_rank, world, TIMEOUT_S, world, sizes, args.reps)
    r0 = results[0]
    wins = {}
    for n in sizes:
        row = r0["sizes"][n]
        flops_card = 2.0 * n ** 3 / world
        # a route's time: the slowest rank's, the better of its two turns
        ms = {name: min(max(res["sizes"][n]["ms"][name][i] for res in results.values()) for i in range(2))
              for name in ("summa", "gather")}
        wins[n] = ms["summa"] < ms["gather"]
        print(json.dumps({
            "phase": "summa_vs_gather", "ranks": world, "shape": [n, n, n], "dtype": "float32", "splits": [0, 0],
            "ms": ms, "ms_turns_rank0": row["ms"], "tflops_per_card": {k: flops_card / v / 1e9 for k, v in ms.items()},
            "rel_err_vs_world_one": {k: row[f"{k}_rel_err"] for k in ("summa", "gather")},
            "rel_err_rows": "all" if n == max(sizes) else args.reps, "rtol": RTOL,
            "traffic_rank0": {k: row[f"{k}_traffic"] for k in ("summa", "gather")}, "transport": row["transport"],
            "peak_mem_bytes_rank0": row["peak_mem_bytes"], "summa_wins": wins[n]}),
            flush=True)
        for k in ("summa", "gather"):
            if not row[f"{k}_rel_err"] <= RTOL:
                fail(f"{k} at {n} vs world size 1: {row[f'{k}_rel_err']} > {RTOL}")
    cross = next((n for n in sizes if all(wins[m] for m in sizes if m >= n)), None)
    print(smi)
    print(json.dumps({"summa_dispatch_entry": {f"('gpu', {world})": cross} if cross else None,
                      "wins": {str(n): w for n, w in wins.items()}}))
    print(json.dumps({"ok": True, "ranks": world, "device": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
