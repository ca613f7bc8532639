#!/usr/bin/env python3
"""BASELINE config 4 across cards, over NCCL: ResNet-50 by DataParallel and by DASO.

    python3 scripts/daso_multicard.py [--ranks N] [--batch 64] [--steps 12] [--trace-dir DIR]

Spawns N processes (default: one a visible card; N must be even), rank r on
``cuda:r`` in the package's default process group (gloo for CPU tensors,
NCCL for CUDA tensors).  Each rank trains ``ht.nn.models.resnet50()``
(1000 classes) on one synthetic (batch, 3, 224, 224) float32 batch of its
own, SGD lr 0.05, momentum 0.9, in torch's default precision (TF32
convolutions), and times ``--steps`` steps after 2 warm-up steps, the card
synchronised after each:

1. one card alone: ``DataParallel`` over a one-rank communicator (every card
   at once, each on its own);
2. ``DataParallel`` over all ranks: the gradients' mean Allreduce launched
   from the backward, one bucket (the default) and 25 MiB buckets, with the
   global batch's BatchNorm; then ``overlap_sync`` (BatchNorm per rank, the
   buckets reduced after the backward, the reference's opt-in path);
3. ``DASO`` as N/2 groups x 2 (warmup 2, ``global_skip`` 4, ``stale_steps``
   1): the gradient mean in each pair of cards every step, the parameter
   average across the pairs every 4 steps, consumed a step later.

To say where a DataParallel step's time goes, four more runs with 25 MiB
buckets change only the BatchNorm's statistics: per rank (no BatchNorm
collective), the global BatchNorm's arithmetic with its collectives left
out (a stand-in communicator that returns this rank's statistics), the
global BatchNorm on the gradients' communicator (the package's default) and
on a communicator of its own (another NCCL communicator and stream over the
same ranks).  Then one card alone and the last two are traced for
3 steps by ``torch.profiler`` on every rank: each step's compute-stream
busy time (every kernel on that stream, NCCL's included: torch launches a
synchronous collective on the current stream) and idle time, the idle
split into the part during which an NCCL kernel runs on another stream
and the part with no kernel at all (waiting on this rank's host), and
each NCCL kernel's count and time by name (``--trace-dir`` keeps rank 0's
traces).

Then the same runs once more with the sync instrumented (the card
synchronised around it) to give the step ms spent waiting on each tier:
for DataParallel the buckets still in flight when the backward's compute
is done, for DASO the pair's gradient mean (``ici``) and the average across
pairs (``dcn``).  Checks: every DataParallel replica the same bits; in DASO
the replicas of a pair the same bits after every step, and all ranks the
same bits after a full sync (the warm-up).  Prints one JSON line a run
(step ms, the slowest rank's; images/s a card and against one card), the
card's name and power limit, and ``{"ok": true, ...}`` last.  Without CUDA
it exits 2 at once.  A failed check or a rank that fails or hangs
(``chip_smoke.spawn_ranks``) exits non-zero.
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
LR, MOMENTUM, CLASSES = 0.05, 0.9, 1000
DASO = dict(total_local_comm_size=2, warmup_steps=2, global_skip=4, stale_steps=1)
WARMUP_STEPS = 2
TRACE_STEPS = 3


def _chip_smoke():
    """This checkout's chip_smoke.py: its rank spawner."""
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def fail(msg: str) -> None:
    raise RuntimeError(f"daso_multicard check failed: {msg}")


def _flat(model):
    import torch

    return torch.cat([p.detach().reshape(-1) for p in model.parameters()])


def _same_bits(comm, model) -> bool:
    """Whether every rank of ``comm`` holds this rank's parameters, bit for bit."""
    parts = comm.Allgather(_flat(model))
    return all(bool((p == parts[0]).all()) for p in parts)


class _Waits:
    """Card-synchronised time spent in the sync calls it wraps, by tier."""

    def __init__(self):
        self.ms = {}

    def wrap(self, owner, name: str, tier: str, settle: bool = True):
        import torch

        fn = getattr(owner, name)

        def timed(*args, **kwargs):
            if settle:
                torch.cuda.synchronize()  # the compute before the call is done
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            self.ms[tier] = self.ms.get(tier, 0.0) + (time.perf_counter() - t0) * 1e3
            return out

        setattr(owner, name, timed)
        return fn


class _LocalStats:
    """A stand-in for the global BatchNorm's communicator: its arithmetic
    runs (size 2 takes that path) and every gather returns this rank's."""

    size = 2

    @staticmethod
    def Allgather(x):
        return [x]

    @staticmethod
    def Allreduce(x):
        return x


def _union(intervals):
    """Sorted, merged (start, end) intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _overlap(gaps, cover) -> float:
    """Total length of ``gaps`` covered by ``cover`` (both merged)."""
    total, j = 0.0, 0
    for a, b in gaps:
        while j < len(cover) and cover[j][1] <= a:
            j += 1
        k = j
        while k < len(cover) and cover[k][0] < b:
            total += min(b, cover[k][1]) - max(a, cover[k][0])
            k += 1
    return total


def trace_summary(events, step_name: str) -> dict:
    """Each ``step_name`` span of a chrome trace's events (the card
    synchronised inside it): wall ms, the compute stream's (the stream with
    the most non-NCCL kernel time) busy ms (any kernel on it) and idle ms,
    the idle while an NCCL kernel runs elsewhere and with no kernel on the
    card, and the NCCL kernels by name."""
    steps = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("ph") == "X" and e.get("cat") == "user_annotation" and e.get("name") == step_name)
    kernels = [(e["ts"], e["ts"] + e["dur"], e["args"].get("stream"), e["name"]) for e in events
               if e.get("ph") == "X" and e.get("cat") == "kernel"]
    nccl = [k for k in kernels if k[3].startswith("nccl")]
    by_stream = {}
    for a, b, stream, name in kernels:
        if not name.startswith("nccl"):
            by_stream[stream] = by_stream.get(stream, 0.0) + (b - a)
    compute = max(by_stream, key=by_stream.get) if by_stream else None
    per_step = []
    for s0, s1 in steps:
        busy = _union([(max(a, s0), min(b, s1)) for a, b, st, _ in kernels if st == compute and b > s0 and a < s1])
        first, last = (busy[0][0], busy[-1][1]) if busy else (s0, s0)
        gaps = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]
        nccl_cover = _union([(a, b) for a, b, _, _ in nccl if b > s0 and a < s1])
        any_cover = _union([(a, b) for a, b, _, _ in kernels if b > s0 and a < s1])
        idle = sum(b - a for a, b in gaps)
        on_nccl = _overlap(gaps, nccl_cover)
        per_step.append({"wall_ms": (s1 - s0) / 1e3, "compute_busy_ms": sum(b - a for a, b in busy) / 1e3,
                         "before_first_kernel_ms": (first - s0) / 1e3, "after_last_kernel_ms": (s1 - last) / 1e3,
                         "compute_idle_ms": idle / 1e3, "idle_while_nccl_runs_ms": on_nccl / 1e3,
                         "idle_with_no_kernel_ms": (idle - _overlap(gaps, any_cover)) / 1e3})
    names = {}
    for a, b, stream, name in nccl:
        if any(s0 <= a < s1 for s0, s1 in steps):
            key = name.split("(")[0]
            entry = names.setdefault(key, {"count": 0, "ms": 0.0, "max_ms": 0.0, "streams": set()})
            entry["count"] += 1
            entry["ms"] += (b - a) / 1e3
            entry["max_ms"] = max(entry["max_ms"], (b - a) / 1e3)
            entry["streams"].add(stream)
    for entry in names.values():
        entry["streams"] = sorted(entry["streams"])
    return {"compute_stream": compute, "steps": per_step, "nccl_kernels_in_steps": names}


def _rank(rank: int, port: int, out_q, world: int, batch: int, steps: int, trace_dir: str = "") -> None:
    sys.path.insert(0, str(HERE))
    import torch

    import heat_tpu_torch as ht
    from heat_tpu_torch.core import collectives

    dev = torch.device("cuda", rank)
    torch.cuda.set_device(dev)
    ht.core.bootstrap.init_distributed(f"tcp://localhost:{port}", world_size=world, rank=rank, timeout_s=TIMEOUT_S)
    try:
        ht.use_device("gpu")
        comm = ht.core.communication.get_comm()
        alone = comm.Split(rank)  # a one-rank communicator: this card on its own
        ce = ht.nn.functional.cross_entropy
        g = torch.Generator(device=dev).manual_seed(rank)
        x = torch.randn(batch, 3, 224, 224, generator=g, device=dev)
        y = torch.randint(0, CLASSES, (batch,), generator=g, device=dev)
        res = {"rank": rank}

        def opt():
            return ht.optim.DataParallelOptimizer("sgd", lr=LR, momentum=MOMENTUM)

        def timed(step, n):
            out = []
            for _ in range(n):
                t0 = time.perf_counter()
                step()
                torch.cuda.synchronize()
                out.append((time.perf_counter() - t0) * 1e3)
            return out

        def dp_run(label, dp_comm, budget, instrument, overlap_sync=False, bn_sync=None, trace=False):
            torch.manual_seed(0)
            model = ht.nn.models.resnet50()
            dp = ht.nn.DataParallel(model, comm=dp_comm, optimizer=opt(), grad_bucket_bytes=budget,
                                    overlap_sync=overlap_sync)
            if bn_sync is not None:  # the BatchNorm's statistics: "rank", or the communicator they go over
                for m in model.modules():
                    if isinstance(m, ht.nn.modules._BatchNorm):
                        m._sync = None if bn_sync == "rank" else bn_sync
            step = dp.make_train_step(ce)
            timed(lambda: step(x, y), WARMUP_STEPS)
            if trace:
                res.setdefault("traces", {})[label] = traced(lambda: step(x, y), label)
                del model, dp, step
                torch.cuda.empty_cache()
                return
            waits = _Waits()
            if instrument:
                orig = waits.wrap(dp, "_finish_sync", "buckets in flight after the backward")
            ms = timed(lambda: step(x, y), steps)
            if instrument:
                dp._finish_sync = orig
            entry = {"step_ms": ms, "waits_ms_per_step": {k: v / steps for k, v in waits.ms.items()},
                     "peak_mem_bytes": torch.cuda.max_memory_allocated(), "buckets": dp._plan.n_buckets}
            if not _same_bits(comm, model) and dp_comm.size > 1:
                fail(f"{label}: the DataParallel replicas differ")
            res.setdefault(label, {}).update(entry if not instrument else {"instrumented": entry})
            del model, dp, step
            torch.cuda.empty_cache()

        def traced(step, label):
            import gzip
            import os
            import tempfile

            from torch.profiler import ProfilerActivity, profile, record_function

            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(TRACE_STEPS):
                    with record_function("dp_step"):
                        step()
                        torch.cuda.synchronize()
            fd, path = tempfile.mkstemp(suffix=".json")
            os.close(fd)
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
            if trace_dir and rank == 0:
                name = label.replace(" ", "_").replace(",", "").replace("'", "")
                with open(path, "rb") as f, gzip.open(Path(trace_dir) / f"rank0_{name}.json.gz", "wb") as g:
                    g.write(f.read())
            os.unlink(path)
            return trace_summary(events, "dp_step")

        for instrument in (False, True):
            dp_run("one card", alone, None, instrument)
            dp_run("DataParallel, one bucket", comm, None, instrument)
            dp_run("DataParallel, 25 MiB buckets", comm, "25M", instrument)
            dp_run("DataParallel, overlap_sync, 25 MiB buckets", comm, "25M", instrument, overlap_sync=True)
        bn_comm = comm.Split(0)  # the same ranks, another communicator (and NCCL stream)
        breakdown = {"BatchNorm per rank": "rank", "global BatchNorm's arithmetic, no collective": _LocalStats(),
                     "global BatchNorm, the gradients' communicator": comm,
                     "global BatchNorm, its own communicator": bn_comm}
        for label, bn_sync in breakdown.items():
            dp_run(f"DataParallel, 25 MiB buckets, {label}", comm, "25M", False, bn_sync=bn_sync)
        dp_run("one card", alone, None, False, trace=True)
        for label in ("global BatchNorm, the gradients' communicator", "global BatchNorm, its own communicator"):
            dp_run(f"DataParallel, 25 MiB buckets, {label}", comm, "25M", False, bn_sync=breakdown[label], trace=True)

        def daso_run(instrument):
            torch.manual_seed(0)
            model = ht.nn.models.resnet50()
            daso = ht.optim.DASO(opt(), **DASO)
            daso.init(model)
            waits, originals = _Waits(), []
            if instrument:
                originals.append((collectives, "bucketed_grad_allreduce",
                                  waits.wrap(collectives, "bucketed_grad_allreduce", "ici: the pair's gradient mean")))
                for name in ("bucketed_param_sync", "dispatch_all_bucket_averages", "consume_bucket_averages_all"):
                    originals.append((collectives, name, waits.wrap(collectives, name,
                                                                    "dcn: the average across pairs")))
            ms, pair_same, all_same_after_warmup = [], [], None
            for t in range(1, WARMUP_STEPS + steps + 1):
                t0 = time.perf_counter()
                daso.step(ce, x, y)
                torch.cuda.synchronize()
                if t > WARMUP_STEPS:
                    ms.append((time.perf_counter() - t0) * 1e3)
                if not instrument:
                    pair_same.append(_same_bits(daso.ici, model))
                    if t == DASO["warmup_steps"]:
                        all_same_after_warmup = _same_bits(comm, model)
            for owner, name, fn in originals:
                setattr(owner, name, fn)
            from heat_tpu_torch.optim.dp_optimizer import _drain

            _drain(daso._pending)
            entry = {"step_ms": ms, "waits_ms_per_step": {k: v / steps for k, v in waits.ms.items()},
                     "groups": [list(daso.ici.ranks), list(daso.dcn.ranks)]}
            if instrument:
                res["DASO"]["instrumented"] = entry
            else:
                if not all(pair_same):
                    bad = [i + 1 for i, same in enumerate(pair_same) if not same]
                    fail(f"DASO: the replicas of a pair differ at steps {bad}")
                if not all_same_after_warmup:
                    fail("DASO: the ranks differ after the warm-up's full sync")
                entry.update(pair_bit_identical_every_step=True, all_ranks_equal_after_warmup=True,
                             dcn_traffic=daso.dcn.traffic())
                res["DASO"] = entry
            del model, daso
            torch.cuda.empty_cache()

        daso_run(False)
        daso_run(True)
        res["transport"] = comm.transport(x, "Allreduce")
        torch.distributed.barrier()
        out_q.put((rank, res))
    finally:
        ht.core.bootstrap.finalize_distributed()


def _median(v):
    v = sorted(v)
    return v[len(v) // 2]


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=None, help="processes, one a card (default: the visible cards)")
    ap.add_argument("--batch", type=int, default=64, help="images a card")
    ap.add_argument("--steps", type=int, default=12, help="timed steps a run")
    ap.add_argument("--trace-dir", default="", help="where rank 0's traces are kept (default: not kept)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("daso_multicard: torch.cuda.is_available() is False; this script needs CUDA cards", file=sys.stderr)
        return 2
    cards = torch.cuda.device_count()
    world = args.ranks or cards
    if not 2 <= world <= cards or world % 2:
        fail(f"need an even number of ranks from 2 to {cards}, one a card, got {world}")
    cs = _chip_smoke()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    if args.trace_dir:
        Path(args.trace_dir).mkdir(parents=True, exist_ok=True)
    results = cs.spawn_ranks(_rank, world, TIMEOUT_S, world, args.batch, args.steps, args.trace_dir)
    alone = max(_median(res["one card"]["step_ms"]) for res in results.values())
    runs = [label for label in results[0] if isinstance(results[0][label], dict) and "step_ms" in results[0][label]]
    for label in runs:
        medians = [_median(res[label]["step_ms"]) for _, res in sorted(results.items())]
        ms = max(medians)
        instrumented = [res[label].get("instrumented") for res in results.values()]
        waits = ({k: max(i["waits_ms_per_step"].get(k, 0.0) for i in instrumented)
                  for k in instrumented[0]["waits_ms_per_step"]} if instrumented[0] else None)
        print(json.dumps({
            "phase": "daso_multicard", "run": label, "ranks": world if label != "one card" else 1,
            "cards_at_once": world, "batch_per_card": args.batch, "image": [3, 224, 224], "classes": CLASSES,
            "precision": "float32, TF32 convolutions (torch's default)", "steps": args.steps,
            "step_ms_median": ms, "step_ms_median_per_rank": medians, "images_per_s_per_card": args.batch / ms * 1e3,
            "vs_one_card": alone / ms,
            "instrumented_step_ms_median": (max(_median(i["step_ms"]) for i in instrumented)
                                            if instrumented[0] else None),
            "sync_wait_ms_per_step": waits,
            **{k: results[0][label][k] for k in ("buckets", "groups", "pair_bit_identical_every_step",
                                                  "all_ranks_equal_after_warmup", "dcn_traffic")
               if k in results[0][label]}}), flush=True)
    for label in results[0]["traces"]:
        for rank, res in sorted(results.items()):
            tr = res["traces"][label]
            print(json.dumps({"phase": "trace", "run": label, "rank": rank, "compute_stream": tr["compute_stream"],
                              "steps": tr["steps"], "nccl_kernels_in_steps": tr["nccl_kernels_in_steps"]}),
                  flush=True)
    print(json.dumps({"phase": "transport", "Allreduce": results[0]["transport"]}))
    print(smi)
    print(json.dumps({"ok": True, "ranks": world, "device": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
