#!/usr/bin/env python3
"""Time the multi-head flash-attention kernels of one checkout on a CUDA card.

    python3 scripts/flash_ab.py [--root DIR] [--reps N]

Imports ``heat_tpu_torch`` from DIR (a checkout of this repository; by
default the one holding this script), builds its kernels there, and prints
one JSON line: the card (nvidia-smi's name and power limit), DIR, and the
ms per launch of ``flash_fwd``, ``flash_bwd_dq`` and ``flash_bwd_dkv`` at
the LM training step's attention, (B*H, S, d) = (64, 1024, 64) causal, in
float32 and bfloat16, timed with CUDA events by ``chip_smoke.time_flash``
(this checkout's).  It then runs ``chip_smoke.py``'s bfloat16 LM training
phase (``lm_train_bf16``) on DIR's package, printing the step time, the
flash share and one step against the plain attention, held to
``BF16_STEP_*`` as in ``chip_smoke.py``, so a checkout that breaks the
bound fails.  Two checkouts compare only within one run on one card, run in
turns:

    for r in OLD . . OLD; do python3 scripts/flash_ab.py --root $r; done
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
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))  # the timed package
    import torch

    if not torch.cuda.is_available():
        print("flash_ab: needs a CUDA card", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")  # this checkout's
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    import heat_tpu_torch

    if Path(heat_tpu_torch.__file__).resolve().parents[1] != root:
        raise RuntimeError(f"imported {heat_tpu_torch.__file__}, not the package under {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    times = {}
    for dtype in (torch.float32, torch.bfloat16):
        rows = chip_smoke.time_flash(chip_smoke.MHA_KERNELS, *chip_smoke.FLASH_MAIN, dtype, args.reps)
        times[str(dtype).replace("torch.", "")] = {name: row["ms"] for name, row in rows.items()}
    print(json.dumps({"card": smi, "root": str(root), "shape": list(chip_smoke.FLASH_MAIN), "causal": True,
                      "ms": times}), flush=True)
    heat_tpu_torch.use_device("gpu")
    chip_smoke.lm_train_bf16(heat_tpu_torch)
    return 0


if __name__ == "__main__":
    sys.exit(main())
