#!/usr/bin/env python3
"""A model of how the causal dk/dv grid fills the card's SMs.

    python3 scripts/flash_grid_model.py [--rows-q 64] [--rows-kv 16] [--tiles 16] [--sms 132]

The flash dk/dv kernel (``heat_tpu_torch/ops/csrc/flash_attention.cu``)
runs one block per (K/V row, 64-key tile), one block an SM; under causal
masking the block of key tile ik works through g * (tiles - ik) query tiles,
g = rows-q / rows-kv.  Blocks start in launch order as SMs free up (greedy
list scheduling).  Prints one JSON line with the makespan, in tile steps,
of the multi-head grid (g = 1) and of the grouped one, and their ratio: the
grouped dk/dv's predicted slowdown at equal time a tile step.  A model,
not a measurement: it ignores L2, clocks and the tail of each block.
"""

from __future__ import annotations

import argparse
import heapq
import json


def makespan(rows_kv: int, group: int, tiles: int, sms: int) -> int:
    """Tile steps until the last of rows_kv * tiles blocks ends on ``sms`` SMs."""
    free = [0] * sms
    for _ in range(rows_kv):
        for ik in range(tiles):
            heapq.heappush(free, heapq.heappop(free) + group * (tiles - ik))
    return max(free)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows-q", type=int, default=64, help="batch * query heads (the GQA LM: 8 * 8)")
    ap.add_argument("--rows-kv", type=int, default=16, help="batch * K/V heads (the GQA LM: 8 * 2)")
    ap.add_argument("--tiles", type=int, default=16, help="64-row tiles of S (S = 1024)")
    ap.add_argument("--sms", type=int, default=132, help="SMs of the card (H100 SXM: 132)")
    args = ap.parse_args()
    mha = makespan(args.rows_q, 1, args.tiles, args.sms)
    gqa = makespan(args.rows_kv, args.rows_q // args.rows_kv, args.tiles, args.sms)
    print(json.dumps({"mha_tile_steps": mha, "gqa_tile_steps": gqa, "ratio": gqa / mha,
                      "even_split_tile_steps": args.rows_q * args.tiles * (args.tiles + 1) / 2 / args.sms}))


if __name__ == "__main__":
    main()
