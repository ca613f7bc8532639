#!/usr/bin/env python3
"""Where the wide route's kernels spend their time, phase by phase, on a CUDA card.

    python3 scripts/wide_phases.py [--shape BHQ,BHK,S,D]

Builds ``heat_tpu_torch/ops/csrc/flash_attention_wide.cu`` with
``-DHEAT_WB_PHASES`` (thread 0 of each block adds the clock cycles of each
phase of ``wb_schedule`` in ``flash_wide_bwd.cuh``) into ``build/``, runs the
forward, dq and dk/dv once causal at the shape (default ``FLASH_D512``: 64
query rows, 64 K/V rows, S = 1024, d = 512) in float32 and bfloat16 after a
warm-up run, and prints one JSON line a kernel and dtype: the card
(nvidia-smi's name and power limit), the tile pairs the blocks ran, the
cycles a pair in each phase (summed over the blocks, over the pairs) and
each phase's share.  The phases: ``issue`` (the next pair's loads and the
loop), ``wait1`` (for the cluster's partial scores), ``exchange`` (the sums;
P and dS, or the forward's P, running max and sum; the pushes),
``arrive2``, ``partials`` (the next pair's partial products, overlapping the
pushes' landing), ``wait2`` (for every block's pushes), ``output`` (the
chunk's products), ``barrier`` (the block barrier after them), ``arrive1``.
The counters cost a few clock reads a pair; the kernels in the package are
built without them.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

KINDS = ("dq", "dkv", "fwd")  # the rows of wb_phase_cycles
PHASES = ("issue", "wait1", "exchange", "arrive2", "partials", "wait2", "output", "barrier", "arrive1")


def build() -> ctypes.CDLL:
    """The instrumented unit as a shared library under build/."""
    from heat_tpu_torch.ops import _build

    csrc, out = _build.CSRC, _build.BUILD_DIR / "libheat_wide_phases.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = subprocess.run([_build._nvcc(), *_build.ARCH, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                           "-DHEAT_WB_PHASES", "-I", str(csrc), str(csrc / "flash_attention_wide.cu"), "-o", str(out)],
                          capture_output=True, text=True)
    if nvcc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{nvcc.stdout}{nvcc.stderr}")
    lib = ctypes.CDLL(str(out))
    i32, i64, ptr, f32 = ctypes.c_int, ctypes.c_int64, ctypes.c_void_p, ctypes.c_float
    tail = [i64, i64, i32, i32, i32, f32, i32, ptr]
    lib.heat_flash_fwd_wide.argtypes = [i32] + [ptr] * 5 + tail
    lib.heat_flash_bwd_dq_wide.argtypes = [i32] + [ptr] * 7 + tail
    lib.heat_flash_bwd_dkv_wide.argtypes = [i32] + [ptr] * 8 + tail
    lib.heat_wb_phases.argtypes = [ptr]
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shape", default="64,64,1024,512", help="query rows, K/V rows, S, d")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("wide_phases.py needs a CUDA card", file=sys.stderr)
        return 2
    from heat_tpu_torch.ops import flash_attention as fa

    bhq, bhk, S, d = (int(x) for x in args.shape.split(","))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    lib = build()
    counters = (ctypes.c_ulonglong * (len(KINDS) * (len(PHASES) + 1)))()
    for dtype in (torch.float32, torch.bfloat16):
        g = torch.Generator(device="cuda").manual_seed(5)
        q, do = (torch.randn((bhq, S, d), generator=g, device="cuda").to(dtype) for _ in range(2))
        k, v = (torch.randn((bhk, S, d), generator=g, device="cuda").to(dtype) for _ in range(2))
        out, lse = (fa.flash_fwd if bhq == bhk else fa.flash_gqa_fwd)(q, k, v, True, d**-0.5)
        dd = (do.float() * out.float()).sum(-1)
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        dims = (bhq, bhk, S, d, int(dtype == torch.bfloat16), d**-0.5, 1, torch.cuda.current_stream().cuda_stream)
        ptrs = [t.data_ptr() for t in (q, k, v, do, lse, dd)]
        o2, lse2 = torch.empty_like(q), torch.empty_like(lse)
        for row, kind in enumerate(KINDS):
            for _ in range(2):  # a warm-up run, then the counted one
                lib.heat_wb_phases(counters)
                rc = (lib.heat_flash_bwd_dq_wide(0, *ptrs, dq.data_ptr(), *dims) if kind == "dq" else
                      lib.heat_flash_bwd_dkv_wide(0, *ptrs, dk.data_ptr(), dv.data_ptr(), *dims) if kind == "dkv"
                      else lib.heat_flash_fwd_wide(0, *ptrs[:3], o2.data_ptr(), lse2.data_ptr(), *dims))
                if rc != 0:
                    raise RuntimeError(f"{kind} failed with code {rc}")
                torch.cuda.synchronize()
            lib.heat_wb_phases(counters)
            c = list(counters)[row * (len(PHASES) + 1):(row + 1) * (len(PHASES) + 1)]
            pairs, total = max(c[-1], 1), sum(c[:-1])
            print(json.dumps({"kernel": f"flash_wide_{kind}_kernel", "dtype": str(dtype).split(".")[1],
                              "shape": [bhq, bhk, S, d], "card": smi, "block_pairs": c[-1],
                              "cycles_a_pair": {p: c[i] / pairs for i, p in enumerate(PHASES)},
                              "share": {p: c[i] / max(total, 1) for i, p in enumerate(PHASES)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
