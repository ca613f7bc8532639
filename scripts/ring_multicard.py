#!/usr/bin/env python3
"""The sequence-parallel ring across cards, over NCCL, against one card.

    python3 scripts/ring_multicard.py [--ranks N] [--steps K]

Spawns N processes (default: one a visible card), rank r on ``cuda:r`` in
the package's default process group (gloo for CPU tensors, NCCL for CUDA
tensors), so the ring's K/V sends and the gradient Allreduce go card to
card over NCCL as they are.  Without CUDA it exits 2 at once (the ring on
the CPU is ``tests/test_torch_ring_attention.py``'s).  Each rank holds its
HeAT chunk of the sequence, 2048 positions a rank:
1. ``ring_attention`` of (2, 8, S, 64) causal float32 blocks: forward, and
   the gradients of q, k, v;
2. one training step of ``TransformerLM(32768, 512, 8, depth=8,
   max_len=S, comm=comm)`` on (2, S + 1) tokens: the global mean loss, and
   every gradient summed over the ranks;
3. K timed Adam steps (default 10): the step time and tokens/s, and each
   positions wrapper's launches (depth x K x N a rank).
Rank 0 gathers 1 and holds it and 2 against the same inputs on its one
card without the ring (``flash_attention`` and a world-1 step: the static
kernels): out to 2e-5 and q, k, v gradients to 1e-4 of each tensor's
largest entry (float32, another merge order over up to 8192 keys); the
loss to 1e-5 relative and each parameter's gradient to 1e-3 of its largest
entry (``chip_smoke.py``'s limits).  Prints one JSON line a phase, the
card's name and power limit, and ``{"ok": true, ...}`` last; a failed
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
PER_RANK = 2048  # positions a rank
OUT_RTOL, GRAD_RTOL = 2e-5, 1e-4


def _chip_smoke():
    """This checkout's chip_smoke.py: its LM widths, batches, ring step and rank spawner."""
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rel(got, want) -> float:
    """max |got - want| over max |want|."""
    got, want = got.detach().float(), want.detach().float()
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)


def _rank(rank: int, port: int, out_q, world: int, steps: int) -> None:
    sys.path.insert(0, str(HERE))
    import torch

    import heat_tpu_torch as ht
    from heat_tpu_torch.ops import flash_attention as fa

    cs = _chip_smoke()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", rank)
    torch.cuda.set_device(dev)
    ht.core.bootstrap.init_distributed(f"tcp://localhost:{port}", world_size=world, rank=rank, timeout_s=TIMEOUT_S)
    try:
        ht.use_device("gpu")
        comm = ht.core.communication.get_comm()
        S = PER_RANK * world
        cfg = dict(cs.LM, max_len=S)
        res = {"rank": rank, "device": str(dev), "transport": comm.transport(torch.zeros(1, device=dev))}

        # 1. ring_attention against flash_attention on rank 0
        g = torch.Generator(device=dev).manual_seed(3)
        q, k, v, w = (torch.randn((2, 8, S, 64), generator=g, device=dev) for _ in range(4))
        lo, (n,), _ = comm.chunk((S,), 0)
        part = [t[:, :, lo:lo + n].clone().requires_grad_(True) for t in (q, k, v)]
        out = ht.parallel.ring_attention(*part, comm, causal=True)
        grads = torch.autograd.grad((out * w[:, :, lo:lo + n]).sum(), part)
        gathered = [comm.Allgatherv(t.detach().contiguous(), axis=2) for t in (out, *grads)]

        # 2. one training step against a world-1 step of the same weights
        torch.manual_seed(0)
        lm = ht.nn.models.TransformerLM(**cfg, comm=comm)
        for p in lm.parameters():
            comm.Bcast(p.data)
        batches = torch.from_numpy(cs.lm_batches(steps + 1, 17, 2, S)).to(dev)
        loss_r = cs._ring_step(ht, lm, comm, batches[0], lo, lo + n)
        if rank == 0:
            full = [t.clone().requires_grad_(True) for t in (q, k, v)]
            ref = fa.flash_attention(*full, causal=True)
            ref_grads = torch.autograd.grad((ref * w).sum(), full)
            res["attention_rel_err"] = {name: _rel(a, b) for name, a, b in
                                        zip(("out", "dq", "dk", "dv"), gathered, (ref, *ref_grads))}
            grads_r = {name: p.grad.detach().clone() for name, p in lm.named_parameters()}
            one = ht.nn.models.TransformerLM(**cfg)
            one.load_state_dict(lm.state_dict())
            loss_1 = cs.lm_loss(ht, one, batches[0])
            loss_1.backward()
            res["loss"], res["world_one_loss"] = loss_r, float(loss_1.detach())
            res["worst_grad"] = max(((name, _rel(grads_r[name], p.grad)) for name, p in one.named_parameters()),
                                    key=lambda t: t[1])
            del one, grads_r, full, ref, ref_grads
        comm.Allreduce(torch.zeros(1))  # every rank waits for rank 0's comparison (a host collective)

        # 3. timed training steps
        opt = ht.optim.DataParallelOptimizer("adam", lm.parameters(), lr=cs.LM_LR)
        for key in fa.launch_counts:
            fa.launch_counts[key] = 0
        step_s, losses = [], []
        for step in range(steps):
            t0 = time.perf_counter()
            losses.append(cs._ring_step(ht, lm, comm, batches[step + 1], lo, lo + n))
            opt.step()
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
        res.update(S=S, positions=[lo, lo + n], config=cfg, step_s=step_s, losses=losses,
                   launch_counts=dict(fa.launch_counts),
                   peak_mem_bytes=torch.cuda.max_memory_allocated(dev))
        comm.Allreduce(torch.zeros(1))
        out_q.put((rank, res))
    finally:
        ht.core.bootstrap.finalize_distributed()


def fail(msg: str) -> None:
    raise RuntimeError(f"ring_multicard check failed: {msg}")


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=None, help="processes, one a card (default: the visible cards)")
    ap.add_argument("--steps", type=int, default=10, help="timed training steps")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ring_multicard: torch.cuda.is_available() is False; this script needs CUDA cards", file=sys.stderr)
        return 2
    cards = torch.cuda.device_count()
    world = args.ranks or cards
    if not 2 <= world <= cards:
        fail(f"need 2 to {cards} ranks, one a card, got {world}")
    sys.path.insert(0, str(HERE))
    from heat_tpu_torch.ops import _build

    _build.load()  # once, before the ranks start: they load the built library
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    results = _chip_smoke().spawn_ranks(_rank, world, TIMEOUT_S, world, args.steps)
    r0 = results[0]
    depth = r0["config"]["depth"]
    for rank, res in sorted(results.items()):
        want = {key: depth * args.steps * world if key.startswith("flash_pos_") else 0 for key in res["launch_counts"]}
        if res["launch_counts"] != want:
            fail(f"rank {rank} launches {res['launch_counts']}, want {want}")
    err = r0["attention_rel_err"]
    loss_rel = abs(r0["loss"] - r0["world_one_loss"]) / abs(r0["world_one_loss"])
    steady = sorted(r0["step_s"][1:])[len(r0["step_s"][1:]) // 2]
    print(json.dumps({"phase": "ring_vs_one_card", "ranks": world, "transport": [res["transport"] for _, res in
                      sorted(results.items())], "attention_shape": [2, 8, r0["S"], 64], "attention_rel_err": err,
                      "out_rtol": OUT_RTOL, "grad_rtol": GRAD_RTOL, "loss": r0["loss"],
                      "world_one_loss": r0["world_one_loss"], "loss_rel_err": loss_rel,
                      "worst_grad": r0["worst_grad"]}), flush=True)
    print(json.dumps({"phase": "ring_training", "ranks": world, "config": r0["config"], "batch": [2, r0["S"] + 1],
                      "steps": args.steps, "step_ms_median": steady * 1e3,
                      "step_ms": [round(t * 1e3, 3) for t in r0["step_s"]], "tokens_per_s": 2 * r0["S"] / steady,
                      "losses": [round(x, 4) for x in r0["losses"]],
                      "peak_mem_bytes_per_rank": [res["peak_mem_bytes"] for _, res in sorted(results.items())],
                      "launch_counts_rank0": r0["launch_counts"]}), flush=True)
    if not (err["out"] <= OUT_RTOL and max(err["dq"], err["dk"], err["dv"]) <= GRAD_RTOL):
        fail(f"ring_attention vs one card: {err}")
    if not (loss_rel <= 1e-5 and r0["worst_grad"][1] <= 1e-3):
        fail(f"the ring step vs one card: loss {loss_rel}, gradient {r0['worst_grad']}")
    print(smi)
    print(json.dumps({"ok": True, "ranks": world, "device": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
