#!/usr/bin/env python3
"""The tiled resplit and BatchParallelKMeans across cards, over NCCL.

    python3 scripts/estimators_multicard.py [--ranks N] [--budget 256M]

Spawns N processes (default: one a visible card), rank r on ``cuda:r`` in
the package's default process group (NCCL for CUDA tensors).

1. The tiled resplit of a (4096, 4096, 256) float32 array (16 GiB; 4 GiB
   a card on four) split 0, to split 1 (tiled along axis 2) and to None,
   under ``--budget`` bytes a step: each rank's destination bit for bit
   the monolithic resplit's, its ``comm.traffic()`` bytes equal, and its
   time and transient memory (``max_memory_allocated`` past what was live,
   less the destination), each path alone, beside the budget plus one tile.
2. ``BatchParallelKMeans(64, max_iter=20)`` on X = ``create_clusters(1e8,
   32, 64)`` split 0: the fit across the cards, exact against its
   emulation on rank 0's card (each rank's chunk clustered from its own
   seed, the candidates merged), and one card's fit of the whole of X
   (world size 1), each timed.

Each rank builds or loads the kernels and runs each collective once,
untimed, before the first timing.  Prints one JSON line a measurement, the card's name and power limit, and
``{"ok": true, ...}`` last.  Without CUDA it exits 2 at once.  A failed
check, or a rank that fails or hangs (``chip_smoke.spawn_ranks``), exits
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
TIMEOUT_S = 1200
SHAPE = (4096, 4096, 256)
N, D, K, MAX_ITER, SEED = 100_000_000, 32, 64, 20, 15


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _resplit(ht, comm, x, dst, budget, rank):
    """(result, row) of one resplit of ``x`` on this rank, alone on the card."""
    import torch

    torch.cuda.synchronize()
    comm.Barrier()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    comm.reset_traffic()
    t0 = time.perf_counter()
    y = x.resplit(dst, memory_budget=budget)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    comm.Barrier()
    dst_bytes = y.larray.numel() * y.larray.element_size()
    return y, {"seconds": secs, "transient_bytes": torch.cuda.max_memory_allocated() - base - dst_bytes,
               "dst_bytes": dst_bytes, "traffic": {k: v["bytes"] for k, v in comm.traffic().items()},
               "calls": {k: v["calls"] for k, v in comm.traffic().items()}}


def _rank(rank: int, port: int, out_q, world: int, budget: int) -> None:
    sys.path.insert(0, str(HERE))
    import torch

    import heat_tpu_torch as ht
    from heat_tpu_torch.cluster.batchparallelclustering import local_lloyd
    from heat_tpu_torch.ops import _build

    dev = torch.device("cuda", rank)
    torch.cuda.set_device(dev)
    ht.core.bootstrap.init_distributed(f"tcp://localhost:{port}", world_size=world, rank=rank, timeout_s=TIMEOUT_S)
    try:
        ht.use_device("gpu")
        comm = ht.core.communication.get_comm()
        # untimed: the kernels' build or load, and NCCL's first all-to-all and all-gather
        _build.load()
        warm = ht.array(torch.ones(4 * world, 8, 8, device=dev), split=0)
        warm.resplit(1, memory_budget=0), warm.resplit(None, memory_budget=0), warm.resplit(1, memory_budget=256)
        torch.cuda.synchronize()
        comm.Barrier()
        res = {"rank": rank, "resplit": {}}
        _, lshape, _ = comm.chunk(SHAPE, 0)
        g = torch.Generator(device=dev).manual_seed(SEED + rank)
        x = ht.array(torch.randn(lshape, generator=g, device=dev), is_split=0)
        for dst in (1, None):
            mono, mrow = _resplit(ht, comm, x, dst, 0, rank)
            tiled, trow = _resplit(ht, comm, x, dst, budget, rank)
            plan = ht.core.redistribution.plan_resplit(SHAPE, 4, 0, dst, world, budget)
            res["resplit"][f"0->{dst}"] = {"monolithic": mrow, "tiled": trow, "equal": bool(torch.equal(
                mono.larray, tiled.larray)), "tiles": plan.n_tiles, "reason": plan.reason,
                "tile_bytes": plan.max_tile_bytes}
            del mono, tiled
            torch.cuda.empty_cache()
        del x
        torch.cuda.empty_cache()

        gm = torch.Generator().manual_seed(SEED)
        means = torch.rand((K, D), generator=gm) * 40.0 - 20.0
        X = ht.utils.data.create_clusters(N, D, K, means.numpy(), cluster_std=1.0, device="gpu", random_state=SEED)
        torch.cuda.synchronize()
        comm.Barrier()
        t0 = time.perf_counter()
        est = ht.cluster.BatchParallelKMeans(n_clusters=K, max_iter=MAX_ITER, random_state=0).fit(X)
        torch.cuda.synchronize()
        comm.Barrier()
        res["fit_s"] = time.perf_counter() - t0
        res["n_iter"] = est.n_iter_
        centers = est.cluster_centers_.larray
        whole = X.resplit(None).larray  # every rank's chunk, for the emulation and one card's fit on rank 0
        counts, displs = X.counts_displs()
        if rank == 0:
            solo = comm.Split(0)
            cands = []
            for r in range(world):
                chunk = whole[displs[r]:displs[r] + counts[r]]
                init = est._init(chunk, 0, r)
                cands.append(local_lloyd(chunk, init, MAX_ITER, False, est.tol)[0])
            cands = torch.cat(cands)
            merged = local_lloyd(cands, est._init(cands, 1, 0), MAX_ITER, False, est.tol)[0]
            res["emulation_equal"] = bool(torch.equal(merged.to(centers.dtype), centers))
            one = ht.array(whole, split=0, comm=solo)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            est1 = ht.cluster.BatchParallelKMeans(n_clusters=K, max_iter=MAX_ITER, random_state=0).fit(one)
            torch.cuda.synchronize()
            res["one_card_fit_s"] = time.perf_counter() - t0
            res["one_card_n_iter"] = est1.n_iter_
            md = means.to(dev)
            for key, c in (("recovered", centers), ("one_card_recovered", est1.cluster_centers_.larray)):
                dist = ((md[:, None, :] - c.float()[None]) ** 2).sum(-1).sqrt().min(1).values
                res[key] = int((dist <= 0.05).sum())
        else:
            comm.Split(1)
        res["peak_mem_bytes"] = torch.cuda.max_memory_allocated(dev)
        del whole, X
        torch.cuda.empty_cache()
        comm.Barrier()
        out_q.put((rank, res))
    finally:
        ht.core.bootstrap.finalize_distributed()


def fail(msg: str) -> None:
    raise RuntimeError(f"estimators_multicard check failed: {msg}")


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=None, help="processes, one a card (default: the visible cards)")
    ap.add_argument("--budget", default="256M", help="the tiled resplit's bytes a step (K/M/G suffixes)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("estimators_multicard: torch.cuda.is_available() is False; this script needs CUDA cards",
              file=sys.stderr)
        return 2
    cards = torch.cuda.device_count()
    world = args.ranks or cards
    if not 2 <= world <= cards:
        fail(f"need 2 to {cards} ranks, one a card, got {world}")
    sys.path.insert(0, str(HERE))
    from heat_tpu_torch.core.redistribution import parse_budget

    budget = parse_budget(args.budget)
    cs = _chip_smoke()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    results = cs.spawn_ranks(_rank, world, TIMEOUT_S, world, budget)
    for rank, res in sorted(results.items()):
        for case, r in res["resplit"].items():
            mono, tiled = r["monolithic"], r["tiled"]
            print(json.dumps({"phase": "tiled_resplit_multicard", "rank": rank, "case": case, "shape": list(SHAPE),
                              "ranks": world, "budget": budget, "tiles": r["tiles"], "tile_bytes": r["tile_bytes"],
                              "tiled": tiled, "monolithic": mono, "card": smi}), flush=True)
            if r["reason"] != "tiled" or not r["equal"]:
                fail(f"rank {rank}: resplit {case}: plan {r['reason']}, equal {r['equal']}")
            if mono["traffic"] != tiled["traffic"]:
                fail(f"rank {rank}: resplit {case} moved {tiled['traffic']}, the monolithic one {mono['traffic']}")
            if tiled["transient_bytes"] > budget + r["tile_bytes"]:
                fail(f"rank {rank}: resplit {case} held {tiled['transient_bytes']} transient bytes")
    r0 = results[0]
    print(json.dumps({"phase": "batchparallel_multicard", "ranks": world, "n": N, "d": D, "k": K,
                      "fit_s": max(res["fit_s"] for res in results.values()), "n_iter": r0["n_iter"],
                      "one_card_fit_s": r0["one_card_fit_s"], "one_card_n_iter": r0["one_card_n_iter"],
                      "recovered": r0["recovered"], "one_card_recovered": r0["one_card_recovered"],
                      "exact_vs_emulation": r0["emulation_equal"],
                      "peak_mem_bytes": {r: res["peak_mem_bytes"] for r, res in sorted(results.items())},
                      "card": smi}), flush=True)
    if not r0["emulation_equal"]:
        fail("the fit across the cards differs from its emulation on one card")
    print(smi)
    print(json.dumps({"ok": True, "ranks": world, "device": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
