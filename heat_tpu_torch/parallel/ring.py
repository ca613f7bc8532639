"""Ring pipeline (reference: ``heat_tpu/parallel/ring.py``; HeAT's
``spatial.cdist`` ring).

Each rank keeps its stationary block; the rotating blocks go round the
ring, one ``Sendrecv`` a step (a rank sends the block it holds to rank - 1
and receives rank + 1's), while ``fn(stationary_block, rotating_block,
src_index)`` runs on every pair.  HeAT's ragged chunks rotate with their
own extents.  The reference runs the ring inside ``shard_map`` on global
arrays; here the operands are DNDarrays split along axis 0 and ``fn`` takes
this rank's local tensors.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..core import types
from ..core.dndarray import DNDarray

__all__ = ["ring_map"]


def ring_map(fn: Callable, stationary: DNDarray, rotating: DNDarray, comm=None, combine: str = "concat",
             concat_axis: int = -1) -> DNDarray:
    """Run ``fn(stationary_block, rotating_block, src_index)`` for every
    ring step, where ``src_index`` is the global index of the rotating block
    (the rank that owns it).  Each rank combines its steps' outputs in block
    order along ``concat_axis`` (``combine='concat'``) or sums them
    (``'sum'``); the global result is the ranks' results along axis 0,
    split 0.  Both operands must be split 0 (or replicated at world size
    1).  Collective."""
    if combine not in ("concat", "sum"):
        raise ValueError(f"combine must be 'concat' or 'sum', got {combine!r}")
    comm = stationary.comm if comm is None else comm
    for x in (stationary, rotating):
        if x.is_distributed() and x.split != 0:
            raise ValueError(f"ring_map takes arrays split along axis 0, got split={x.split}")
    p, r = comm.size, comm.rank
    stat = stationary.larray
    rot = rotating.larray
    if p > 1:
        counts = list(rotating.counts_displs()[0]) if rotating.is_distributed() else [rot.shape[0]] * p
    else:
        counts = [rot.shape[0]]
    outs = {}
    blk = rot
    for i in range(p):
        src = (r + i) % p
        outs[src] = fn(stat, blk, src)
        if i + 1 < p:  # pass the block on to rank - 1, take rank + 1's
            nxt = (src + 1) % p
            shape = (counts[nxt],) + tuple(blk.shape[1:])
            blk = comm.Sendrecv(blk.contiguous(), (r - 1) % p, (r + 1) % p, shape)
    if combine == "sum":
        res = outs[0]
        for s in range(1, p):
            res = res + outs[s]
    else:
        res = torch.cat([outs[s] for s in range(p)], concat_axis)
    n = res.shape[0] if res.ndim else 0
    if res.ndim == 0:
        raise ValueError("ring_map's step function must return at least 1-D blocks")
    total = n
    balanced = True
    if p > 1:
        sizes = [int(c) for c in comm._extents(res, 0)]
        total = sum(sizes)
        balanced = sizes == [comm.chunk((total,), 0, q)[1][0] for q in range(p)]
    split = 0 if (stationary.split == 0 or p > 1) else None
    return DNDarray(res, (total,) + tuple(res.shape[1:]), types.canonical_heat_type(res.dtype), split,
                    stationary.device, comm, balanced)
