#!/usr/bin/env python3
"""Hold one checkout's flash kernels to another's bit for bit on a CUDA card.

    python3 scripts/flash_bits.py --parent DIR [--root DIR]

Runs the flash kernels of two checkouts of this repository (``--root``, by
default the one holding this script, and ``--parent``) on the same inputs,
each checkout's package in a process of its own (its kernels built there),
and prints one JSON line: the card (nvidia-smi's name and power limit) and,
for each case, whether every output is the same to the bit.  The cases
cover every body a change to the wide route's forward must leave as it
was: head dims up to 256 (the multi-head, grouped and positions wrappers,
forward (out, lse), dq and dk/dv, float32 and bfloat16, at d = 64, 128
(grouped 8:2), 160 and 256), and the wide route's backward past 256 (dq
and dk/dv of the three wrappers at d = 320, 512 and 1126, ragged and
unaligned among them, from lse and dd that the script computes itself in
float64, so that neither checkout's forward feeds them).  The wide
forward is not among them: it is held against its plain version
(``chip_smoke.py``, the ``cuda`` tests).  Exits 1 if any case differs.
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
# the wide backward: each d in every wrapper, (query rows, K/V rows, S, d, causal) and positions blocks as above
WIDE_CASES = [c for d in (320, 512, 1126) for c in ((4, 4, 200, d, True), (8, 2, 129, d, False))]
WIDE_POS_CASES = [(4, 200, 333, d, 100, 50, True, 383) for d in (320, 512, 1126)]

DUMP = r"""
import sys, torch
sys.path.insert(0, sys.argv[1])
from heat_tpu_torch.ops import flash_attention as fa
cases, pos_cases, wide_cases, wide_pos_cases = (eval(a) for a in sys.argv[3:7])
res = {}

def rows64(q, k, v, do, keep, scale):
    # lse and dd = rowsum(dO * O) of softmax attention in float64 (every row has a live key), as float32
    g = q.shape[0] // k.shape[0]
    k, v = (t.double().repeat_interleave(g, 0) for t in (k, v))
    s = (q.double() @ k.transpose(-1, -2) * scale).masked_fill(~keep, float("-inf"))
    lse = torch.logsumexp(s, -1)
    out = torch.exp(s - lse[..., None]) @ v
    return lse.float(), (do.double() * out).sum(-1).float()

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
    for bhq, bhk, S, d, causal in wide_cases:
        g = torch.Generator(device="cuda").manual_seed(S + d)
        q, do = (torch.randn((bhq, S, d), generator=g, device="cuda").to(dt) for _ in range(2))
        k, v = (torch.randn((bhk, S, d), generator=g, device="cuda").to(dt) for _ in range(2))
        pre = "flash_" if bhq == bhk else "flash_gqa_"
        keep = torch.ones((S, S), dtype=torch.bool, device="cuda")
        lse, dd = rows64(q, k, v, do, keep.tril() if causal else keep, d**-0.5)
        dq, dkv = (getattr(fa, pre + n) for n in ("bwd_dq", "bwd_dkv"))
        res[f"wide_{pre}bwd_{dt}{(bhq, bhk, S, d, causal)}"] = [t.cpu() for t in (
            dq(q, k, v, do, lse, dd, causal, d**-0.5), *dkv(q, k, v, do, lse, dd, causal, d**-0.5))]
    for B, Sq, Sk, d, qo, ko, causal, s_valid in wide_pos_cases:
        g = torch.Generator(device="cuda").manual_seed(Sq + d)
        q, do = (torch.randn((B, Sq, d), generator=g, device="cuda").to(dt) for _ in range(2))
        k, v = (torch.randn((B, Sk, d), generator=g, device="cuda").to(dt) for _ in range(2))
        qpos = torch.arange(qo, qo + Sq, dtype=torch.int32, device="cuda")
        kpos = torch.arange(ko, ko + Sk, dtype=torch.int32, device="cuda")
        keep = (kpos[None, :] < s_valid) & (~torch.tensor(causal, device="cuda") | (qpos[:, None] >= kpos[None, :]))
        lse, dd = rows64(q, k, v, do, keep, d**-0.5)
        a = (qpos, kpos, causal, d**-0.5, s_valid, True)
        res[f"wide_flash_pos_bwd_{dt}{(B, Sq, Sk, d, qo, ko)}"] = [t.cpu() for t in (
            fa.flash_pos_bwd_dq(q, k, v, do, lse, dd, *a), *fa.flash_pos_bwd_dkv(q, k, v, do, lse, dd, *a))]
torch.save(res, sys.argv[2])
"""


def dump(root: Path, out: Path) -> None:
    """Run ``root``'s kernels on every case in a process of its own; the outputs into ``out``."""
    subprocess.run([sys.executable, "-c", DUMP, str(root.resolve()), str(out), repr(CASES), repr(POS_CASES),
                    repr(WIDE_CASES), repr(WIDE_POS_CASES)], check=True, timeout=1200)


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
