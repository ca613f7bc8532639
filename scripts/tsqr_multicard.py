#!/usr/bin/env python3
"""BASELINE config 1 across cards, over NCCL: tall-skinny ``ht.linalg.qr`` and ``svd``.

    python3 scripts/tsqr_multicard.py [--ranks N] [--rows 1000000,4000000] [--cols 256] [--reps K]

Spawns N processes (default: one a visible card), rank r on ``cuda:r`` in
the package's default process group (gloo for CPU tensors, NCCL for CUDA
tensors).  For each m of ``--rows`` (default 1e6, config 1's rows, and 4e6,
one card's config-1 rows a card), an (m, n) float32 matrix split along
rows (n = ``--cols``, default 256), each rank drawing its HeAT chunk from a
generator seeded by (m, rank), is factored by ``ht.linalg.qr`` (CholeskyQR2
and Householder; TSQR: a local QR a rank, one Allgather of the R factors,
one local GEMM for Q) and ``ht.linalg.svd``, each K times (default 3)
between barriers, the cards synchronised.  A route's time is the slowest
rank's.  Rank 0 rebuilds the whole matrix and factors it at world size 1
(the same call on a replicated input, which runs the local path), timed
too; each route's R (signs aligned) and singular values are held against
it, and A = QR and Q^T Q = I against float64 across the ranks (1e-4, the
reference's tests' limits).  Prints one JSON line a (size, route) (ms,
TFLOP/s a card by the standard count 4mn^2 - 4n^3/3 and by the executed
products, the error against world size 1, the communicator's traffic of
one call), the card's name and power limit, and ``{"ok": true, ...}``
last.  Without CUDA it exits 2 at once.  A failed check or a rank that
fails or hangs (``chip_smoke.spawn_ranks``) exits non-zero.
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
TIMEOUT_S = 900
TOL = 1e-4  # the reference's tests' limits (tests/test_linalg.py)
RTOL_WORLD_ONE = 1e-4  # R and S against world size 1: float32 sums in another order, other local blocks


def _chip_smoke():
    """This checkout's chip_smoke.py: its rank spawner and error measures."""
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _chunk(m: int, n: int, rank: int, world: int, dev):
    """Rank ``rank``'s HeAT chunk of the (m, n) matrix: rows of a generator
    seeded by (m, rank)."""
    import torch

    rows = m // world + (1 if rank < m % world else 0)
    g = torch.Generator(device=dev).manual_seed(m * 64 + rank)
    return torch.randn(rows, n, generator=g, device=dev)


def _rank(rank: int, port: int, out_q, world: int, sizes, n: int, reps: int) -> None:
    sys.path.insert(0, str(HERE))
    import torch

    import heat_tpu_torch as ht

    cs = _chip_smoke()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", rank)
    torch.cuda.set_device(dev)
    ht.core.bootstrap.init_distributed(f"tcp://localhost:{port}", world_size=world, rank=rank, timeout_s=TIMEOUT_S)
    try:
        ht.use_device("gpu")
        comm = ht.core.communication.get_comm()
        res = {"rank": rank, "sizes": {}}
        for m in sizes:
            local = _chunk(m, n, rank, world, dev)
            a = ht.array(local, is_split=0)
            routes = {"qr auto (CholeskyQR2)": lambda: ht.linalg.qr(a),
                      "qr householder": lambda: ht.linalg.qr(a, method="householder"),
                      "svd": lambda: ht.linalg.svd(a)}
            row = {}
            ref = None
            if rank == 0:  # world size 1: the whole matrix, replicated, on this card
                whole = torch.cat([_chunk(m, n, r, world, dev) for r in range(world)])
                r1 = ht.linalg.qr(ht.array(whole)).R.larray
                ref = (r1, torch.linalg.svdvals(r1.double()))
                row["world_one_ms"] = {"qr auto (CholeskyQR2)": cs.wall_ms(lambda: ht.linalg.qr(ht.array(whole)), reps)}
                del whole
                torch.cuda.empty_cache()
            comm.Barrier()
            for label, fn in routes.items():
                comm.reset_traffic()
                out = fn()
                traffic = comm.traffic()
                if label == "svd":
                    u, s, v = out
                    q, r, scale = u.larray, v.larray.T, s.larray
                    rr = ht.linalg.qr(a, mode="r").R.larray
                else:
                    q, r, scale = out.Q.larray, out.R.larray, None
                    rr = r
                # A = QR and Q^T Q = I in float64, summed over the ranks
                r64 = r.double() if scale is None else scale.double()[:, None] * r.double()
                sums = torch.stack([(local.double() - q.double() @ r64).square().sum(), local.double().square().sum()])
                gram = q.double().T @ q.double()
                comm.Allreduce(sums)
                comm.Allreduce(gram)
                eye = torch.eye(gram.shape[0], dtype=torch.float64, device=dev)
                entry = {"rel_err": float((sums[0] / sums[1]).sqrt()), "orth_err": float((gram - eye).abs().max()),
                         "traffic": traffic}
                if rank == 0:
                    d = cs.align_signs(rr, ref[0])
                    entry["r_vs_world_one"] = cs.rel_max(d[:, None] * rr, ref[0])
                    s_here = scale if scale is not None else torch.linalg.svdvals(r.double())
                    entry["s_vs_world_one"] = cs.rel_max(s_here, ref[1])
                del out, q, r, rr
                torch.cuda.empty_cache()
                comm.Barrier()
                entry["ms"] = _timed(fn, comm, reps)
                row[label] = entry
            row["peak_mem_bytes"] = torch.cuda.max_memory_allocated(dev)
            res["sizes"][m] = row
            del a, local
            torch.cuda.empty_cache()
        comm.Barrier()
        out_q.put((rank, res))
    finally:
        ht.core.bootstrap.finalize_distributed()


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


def fail(msg: str) -> None:
    raise RuntimeError(f"tsqr_multicard check failed: {msg}")


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=None, help="processes, one a card (default: the visible cards)")
    ap.add_argument("--rows", default="1000000,4000000", help="row counts m, comma-separated")
    ap.add_argument("--cols", type=int, default=256, help="columns n")
    ap.add_argument("--reps", type=int, default=3, help="timed calls a route")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("tsqr_multicard: torch.cuda.is_available() is False; this script needs CUDA cards", file=sys.stderr)
        return 2
    cards = torch.cuda.device_count()
    world = args.ranks or cards
    if not 2 <= world <= cards:
        fail(f"need 2 to {cards} ranks, one a card, got {world}")
    sizes = sorted(int(s) for s in args.rows.split(","))
    n = args.cols
    cs = _chip_smoke()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    results = cs.spawn_ranks(_rank, world, TIMEOUT_S, world, sizes, n, args.reps)
    r0 = results[0]
    for m in sizes:
        flops = cs.qr_flops(m, n, world)
        standard = {"qr auto (CholeskyQR2)": flops["standard"], "qr householder": flops["standard"],
                    "svd": flops["standard"] + 2.0 * m * n * n}
        executed = {"qr auto (CholeskyQR2)": flops["cholqr2"], "qr householder": flops["householder"],
                    "svd": flops["svd"]}
        for label in standard:
            entry = r0["sizes"][m][label]
            ms = max(res["sizes"][m][label]["ms"] for res in results.values())
            print(json.dumps({
                "phase": "tsqr_multicard", "route": label, "ranks": world, "shape": [m, n], "dtype": "float32",
                "split": 0, "ms": ms, "ms_per_rank": [res["sizes"][m][label]["ms"] for _, res in sorted(results.items())],
                "tflops_per_card_standard": standard[label] / world / ms / 1e9,
                "tflops_per_card_executed": executed[label] / world / ms / 1e9,
                "world_one_ms_qr_auto": r0["sizes"][m]["world_one_ms"]["qr auto (CholeskyQR2)"],
                "rel_err": entry["rel_err"], "orth_err": entry["orth_err"], "tol": TOL,
                "r_vs_world_one": entry["r_vs_world_one"], "s_vs_world_one": entry["s_vs_world_one"],
                "rtol_world_one": RTOL_WORLD_ONE, "traffic_rank0": entry["traffic"],
                "peak_mem_bytes_rank0": r0["sizes"][m]["peak_mem_bytes"]}), flush=True)
            if not (entry["rel_err"] <= TOL and entry["orth_err"] <= TOL):
                fail(f"{label} at {m}: {entry['rel_err']}, {entry['orth_err']} > {TOL}")
            if not (entry["r_vs_world_one"] <= RTOL_WORLD_ONE and entry["s_vs_world_one"] <= RTOL_WORLD_ONE):
                fail(f"{label} at {m} vs world size 1: R {entry['r_vs_world_one']}, S {entry['s_vs_world_one']}")
    print(smi)
    print(json.dumps({"ok": True, "ranks": world, "device": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
