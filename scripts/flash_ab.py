#!/usr/bin/env python3
"""Time the flash-attention kernels and the LM training steps of one checkout on a CUDA card.

    python3 scripts/flash_ab.py [--root DIR] [--reps N] [--shapes main|d512]

Imports ``heat_tpu_torch`` from DIR (a checkout of this repository; by
default the one holding this script), builds its kernels there, and prints
one JSON line: the card (nvidia-smi's name and power limit), DIR, and the
ms per launch, in float32 and bfloat16, timed with CUDA events by this
checkout's ``chip_smoke.time_flash`` and ``chip_smoke.time_pos``, of

- ``flash_fwd``, ``flash_bwd_dq`` and ``flash_bwd_dkv`` at the LM training
  step's attention, (B*H, S, d) = (64, 1024, 64) causal;
- ``flash_gqa_*`` at the grouped LM's, (64 query, 16 K/V rows, 1024, 64);
- ``flash_pos_*`` at the ring step's diagonal, past and dead blocks,
  (16, 2048, 2048, 64), and their mean over the ring's mix of blocks.

With ``--shapes d512`` it times the same wrappers at head dim 512, the
wide route (``chip_smoke.py``'s ``FLASH_D512``, ``GQA_D512``,
``POS_D512``), and stops there.  Otherwise it then runs two of ``chip_smoke.py``'s training phases on DIR's package,
each with its step time, the flash share of a profiled step, and one step
against the plain attention held to ``chip_smoke.py``'s bounds, so a
checkout that breaks them fails: the multi-head LM in float32
(``lm_train``, 20 steps, ``STEP_*``) and cast to bfloat16
(``lm_train_bf16``, 10 steps, ``BF16_STEP_*``).  Two checkouts compare only within one run on one card, run in turns,
the parent unpacked by ``git archive`` under ``build/`` (which git
ignores):

    mkdir -p build/parent && git archive PARENT | tar -x -C build/parent  # PARENT: the commit before the change
    for r in build/parent . . build/parent; do python3 scripts/flash_ab.py --root $r; done
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE), help="checkout whose heat_tpu_torch is timed")
    ap.add_argument("--reps", type=int, default=20, help="launches a timing")
    ap.add_argument("--shapes", choices=("main", "d512"), default="main",
                    help="the LM training step's attention and then its LM phases, or head dim 512's (the wide route)")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))  # the timed package
    import torch

    if not torch.cuda.is_available():
        print("flash_ab: needs a CUDA card", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")  # this checkout's
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import heat_tpu_torch

    if Path(heat_tpu_torch.__file__).resolve().parents[1] != root:
        raise RuntimeError(f"imported {heat_tpu_torch.__file__}, not the package under {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    mix = sum(cs.POS_MIX.values())
    mha, gqa, pos = ((cs.FLASH_MAIN, cs.GQA_MAIN, cs.POS_MAIN) if args.shapes == "main" else
                     (cs.FLASH_D512, cs.GQA_D512, cs.POS_D512))
    times = {}
    for dtype in (torch.float32, torch.bfloat16):
        row = {}
        for names, shape in ((cs.MHA_KERNELS, mha), (cs.GQA_KERNELS, gqa)):
            row.update({name: r["ms"] for name, r in cs.time_flash(names, *shape, dtype, args.reps).items()})
        for name, blocks in cs.time_pos(dtype, max(args.reps // 2, 1), pos).items():
            row[name] = {"mix": sum(cs.POS_MIX[b] * blocks[b]["ms"] for b in cs.POS_MIX) / mix,
                         **{b: blocks[b]["ms"] for b in blocks}}
        times[str(dtype).replace("torch.", "")] = row
    print(json.dumps({"card": smi, "root": str(root), "shapes": {"mha": list(mha), "gqa": list(gqa),
                                                                  "positions": list(pos)},
                      "causal": True, "ms": times}), flush=True)
    if args.shapes == "d512":
        return 0
    heat_tpu_torch.use_device("gpu")
    label = "TransformerLM training"
    lm, opt, _, batch = cs.lm_train(heat_tpu_torch, cs.LM, cs.MHA_KERNELS, label)
    cs.profile_training_step(heat_tpu_torch, lm, opt, batch, label)
    cs.lm_step_vs_plain(heat_tpu_torch, lm, batch, cs.MHA_KERNELS, "TransformerLM")
    del lm, opt, batch
    torch.cuda.empty_cache()
    cs.lm_train_bf16(heat_tpu_torch)
    return 0


if __name__ == "__main__":
    sys.exit(main())
