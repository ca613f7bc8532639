#!/usr/bin/env python3
"""The distributed sample sort across cards, over NCCL: ``sort``, ``percentile`` and ``unique``.

    python3 scripts/sort_multicard.py [--ranks N] [--n 1000000000] [--reps K]

Spawns N processes (default: one a visible card), rank r on ``cuda:r`` in
the package's default process group (NCCL for CUDA tensors).  v =
``ht.random.rand(n, split=0)`` (float32; each rank draws its HeAT chunk
of the split-invariant stream), then ``ht.sort(v)`` (values and int32
indices: the sample sort, one exchange), ``ht.percentile(v, [5, 50,
95])`` (exact radix selection, no sort) and ``ht.unique(v)`` (the sort's
values, a neighbour compare), each K times (default 3) between barriers,
the cards synchronised; a route's time is the slowest rank's.  Each rank
also draws the whole of v on its own card (the same stream, replicated)
and holds its chunk of each result against world size 1 on it: ``sort``
and ``unique`` bit for bit ``torch.sort(stable=True)`` and
``torch.unique`` cut to the rank's chunk, ``percentile`` exactly the
port's world-1 result.  Prints one JSON line a route (ms, each rank's
bytes sent by collective, the bound: v read and the result written once at
3.35 TB/s a card), the card's name and power limit, and ``{"ok": true,
...}`` last.  Without CUDA it exits 2 at once.  A failed check or a rank
that fails or hangs (``chip_smoke.spawn_ranks``) exits non-zero.
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
TIMEOUT_S = 1200
SEED = 2024
PEAK_BYTES = 3.35e12


def _chip_smoke():
    """This checkout's chip_smoke.py: its rank spawner."""
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _timed(fn, comm, reps: int) -> float:
    """ms a call on this rank between barriers, the card synchronised."""
    import torch

    fn()
    torch.cuda.synchronize()
    comm.Barrier()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    comm.Barrier()
    return (time.perf_counter() - t0) * 1e3 / reps


def _rank(rank: int, port: int, out_q, world: int, n: int, reps: int) -> None:
    sys.path.insert(0, str(HERE))
    import torch

    import heat_tpu_torch as ht

    dev = torch.device("cuda", rank)
    torch.cuda.set_device(dev)
    ht.core.bootstrap.init_distributed(f"tcp://localhost:{port}", world_size=world, rank=rank, timeout_s=TIMEOUT_S)
    try:
        ht.use_device("gpu")
        comm = ht.core.communication.get_comm()
        ht.random.seed(SEED)
        v = ht.random.rand(n, split=0)
        off = comm.counts_displs_shape((n,), 0)[1][rank]
        cnt = v.lshape[0]
        res = {"rank": rank, "routes": {}}
        routes = {"sort": lambda: ht.sort(v), "percentile": lambda: ht.percentile(v, [5, 50, 95]),
                  "unique": lambda: ht.unique(v)}
        outs = {}
        for label, fn in routes.items():
            comm.reset_traffic()
            outs[label] = fn()
            torch.cuda.synchronize()
            traffic = comm.traffic()
            comm.Barrier()
            res["routes"][label] = {"traffic": traffic, "ms": _timed(fn, comm, reps)}
        # world size 1 on this card: the whole stream, replicated
        ht.random.seed(SEED)
        whole = ht.random.rand(n).larray
        sv, si = torch.sort(whole, stable=True)
        ok_sort = torch.equal(outs["sort"][0].larray, sv[off:off + cnt]) and torch.equal(
            outs["sort"][1].larray.long(), si[off:off + cnt])
        del si
        uq = torch.unique(sv)
        del sv
        u = outs["unique"]
        uoff = comm.counts_displs_shape(u.gshape, 0)[1][rank]
        ok_unique = u.gshape[0] == uq.numel() and torch.equal(u.larray, uq[uoff:uoff + u.lshape[0]])
        del uq
        w1 = ht.percentile(ht.array(whole), [5, 50, 95]).larray
        ok_pct = torch.equal(outs["percentile"].larray, w1)
        res["checks"] = {"sort": ok_sort, "unique": ok_unique, "percentile": ok_pct,
                         "percentile_values": outs["percentile"].larray.tolist(), "uniques": u.gshape[0],
                         "chunk": cnt}
        res["peak_mem_bytes"] = torch.cuda.max_memory_allocated(dev)
        del whole, outs
        torch.cuda.empty_cache()
        comm.Barrier()
        out_q.put((rank, res))
    finally:
        ht.core.bootstrap.finalize_distributed()


def fail(msg: str) -> None:
    raise RuntimeError(f"sort_multicard check failed: {msg}")


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=None, help="processes, one a card (default: the visible cards)")
    ap.add_argument("--n", type=int, default=1_000_000_000, help="elements of v")
    ap.add_argument("--reps", type=int, default=3, help="timed calls a route")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("sort_multicard: torch.cuda.is_available() is False; this script needs CUDA cards", file=sys.stderr)
        return 2
    cards = torch.cuda.device_count()
    world = args.ranks or cards
    if not 2 <= world <= cards:
        fail(f"need 2 to {cards} ranks, one a card, got {world}")
    cs = _chip_smoke()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    results = cs.spawn_ranks(_rank, world, TIMEOUT_S, world, args.n, args.reps)
    n = args.n
    chunk_bytes = (n // world) * 4
    writes = {"sort": n * 8 // world, "percentile": 12, "unique": results[0]["checks"]["uniques"] * 4 // world}
    for label in ("sort", "percentile", "unique"):
        ms = max(res["routes"][label]["ms"] for res in results.values())
        print(json.dumps({
            "phase": "sort_multicard", "route": label, "ranks": world, "n": n, "dtype": "float32", "split": 0,
            "ms": ms, "ms_per_rank": [res["routes"][label]["ms"] for _, res in sorted(results.items())],
            "bound_ms": (chunk_bytes + writes[label]) / PEAK_BYTES * 1e3,
            "sent_by_rank": {r: res["routes"][label]["traffic"] for r, res in sorted(results.items())},
            "exact_vs_world_one": all(res["checks"][label] for res in results.values())}), flush=True)
    for rank, res in sorted(results.items()):
        bad = [k for k in ("sort", "percentile", "unique") if not res["checks"][k]]
        if bad:
            fail(f"rank {rank}: {bad} differ from world size 1")
        sent = res["routes"]["sort"]["traffic"].get("Alltoall", {}).get("bytes", 0)
        if sent > res["checks"]["chunk"] * (4 + 8):
            fail(f"rank {rank}: the sort sent {sent} bytes, past its chunk's values and indices")
    print(json.dumps({"phase": "sort_multicard", "percentile_values": results[0]["checks"]["percentile_values"],
                      "uniques": results[0]["checks"]["uniques"],
                      "peak_mem_bytes": {r: res["peak_mem_bytes"] for r, res in sorted(results.items())}}))
    print(smi)
    print(json.dumps({"ok": True, "ranks": world, "device": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
