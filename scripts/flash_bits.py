#!/usr/bin/env python3
"""Hold one checkout's flash kernels to another's bit for bit on a CUDA card.

    python3 scripts/flash_bits.py --parent DIR [--root DIR]

Runs the flash kernels of two checkouts of this repository (``--root``, by
default the one holding this script, and ``--parent``) on the same inputs,
each checkout's package in a process of its own (its kernels built there),
and prints one JSON line: the card (nvidia-smi's name and power limit) and,
for each case, whether every output is the same to the bit.  The cases
cover head dims up to 256, where a change that adds a route past them must
leave the results as they were: the multi-head, grouped and positions
wrappers, forward (out, lse), dq and dk/dv, float32 and bfloat16, at
d = 64, 128 (grouped 8:2), 160 and 256.  Exits 1 if any case differs.
The parent is unpacked by ``git archive`` under ``build/`` (which git
ignores):

    mkdir -p build/parent && git archive PARENT | tar -x -C build/parent
    python3 scripts/flash_bits.py --parent build/parent
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
# (query rows, K/V rows, S, d, causal); positions blocks (B, Sq, Sk, d, q offset, k offset, causal, s_valid)
CASES = [(16, 16, 1000, 64, True), (16, 4, 129, 128, False), (8, 8, 300, 256, True), (8, 2, 200, 160, True)]
POS_CASES = [(4, 300, 300, 64, 300, 300, True, 600), (4, 200, 333, 256, 100, 50, True, 383)]

DUMP = r"""
import sys, torch
sys.path.insert(0, sys.argv[1])
from heat_tpu_torch.ops import flash_attention as fa
cases, pos_cases = eval(sys.argv[3]), eval(sys.argv[4])
res = {}
for dt in (torch.float32, torch.bfloat16):
    for bhq, bhk, S, d, causal in cases:
        g = torch.Generator(device="cuda").manual_seed(S + d)
        q, do = (torch.randn((bhq, S, d), generator=g, device="cuda").to(dt) for _ in range(2))
        k, v = (torch.randn((bhk, S, d), generator=g, device="cuda").to(dt) for _ in range(2))
        pre = "flash_" if bhq == bhk else "flash_gqa_"
        fwd, dq, dkv = (getattr(fa, pre + n) for n in ("fwd", "bwd_dq", "bwd_dkv"))
        out, lse = fwd(q, k, v, causal, d**-0.5)
        dd = (do.float() * out.float()).sum(-1)
        res[f"{pre}{dt}{(bhq, bhk, S, d, causal)}"] = [t.cpu() for t in (
            out, lse, dq(q, k, v, do, lse, dd, causal, d**-0.5), *dkv(q, k, v, do, lse, dd, causal, d**-0.5))]
    for B, Sq, Sk, d, qo, ko, causal, s_valid in pos_cases:
        g = torch.Generator(device="cuda").manual_seed(Sq + d)
        q, do = (torch.randn((B, Sq, d), generator=g, device="cuda").to(dt) for _ in range(2))
        k, v = (torch.randn((B, Sk, d), generator=g, device="cuda").to(dt) for _ in range(2))
        a = (torch.arange(qo, qo + Sq, dtype=torch.int32, device="cuda"),
             torch.arange(ko, ko + Sk, dtype=torch.int32, device="cuda"), causal, d**-0.5, s_valid, True)
        out, lse = fa.flash_pos_fwd(q, k, v, *a)
        dd = (do.float() * out.float()).sum(-1) - 0.5
        res[f"flash_pos_{dt}{(B, Sq, Sk, d, qo, ko)}"] = [t.cpu() for t in (
            out, lse, fa.flash_pos_bwd_dq(q, k, v, do, lse, dd, *a), *fa.flash_pos_bwd_dkv(q, k, v, do, lse, dd, *a))]
torch.save(res, sys.argv[2])
"""


def dump(root: Path, out: Path) -> None:
    """Run ``root``'s kernels on every case in a process of its own; the outputs into ``out``."""
    subprocess.run([sys.executable, "-c", DUMP, str(root.resolve()), str(out), repr(CASES), repr(POS_CASES)],
                   check=True, timeout=1200)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE), help="the checkout under test (default: this one)")
    ap.add_argument("--parent", required=True, help="the checkout it is held to")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("flash_bits.py needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    with tempfile.TemporaryDirectory() as tmp:
        mine, theirs = Path(tmp) / "root.pt", Path(tmp) / "parent.pt"
        dump(Path(args.root), mine)
        dump(Path(args.parent), theirs)
        a, b = torch.load(mine), torch.load(theirs)
    same = {key: all(torch.equal(x, y) for x, y in zip(a[key], b[key])) for key in b}
    print(json.dumps({"card": smi, "root": args.root, "parent": args.parent, "cases": len(same),
                      "bitwise_equal": all(same.values()), "by_case": same}))
    return 0 if set(a) == set(b) and all(same.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
