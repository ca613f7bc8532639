"""The tiled resplit under a byte budget (reference: ``heat_tpu/core/redistribution.py``).

A resplit moves the whole array in one collective: split to split by one
``Alltoall``, split to None by one ``Allgatherv``.  Each rank then holds
its source chunk, its destination chunk and the collective's buffers (a
send and a receive buffer as large as the chunk) at once.  Following
"Memory-efficient array redistribution through portable collective
communication" (arXiv 2112.01075), a transition decomposes into K tiled
collectives along an axis that is neither the source nor the destination
split, each moving at most ``memory_budget`` bytes of the global array:

- :func:`plan_resplit` is the JAX package's planner, copied unchanged: pure
  shard arithmetic on (gshape, itemsize, src split, dst split, world size,
  budget), so the plans and their ``reason`` are the reference's for every
  input (``no-budget``, ``too-few-dims``, ``fits-in-budget``,
  ``ragged-src``/``ragged-dst``, ``no-free-axis``, ``tiled``,
  ``tiled-floor-one-slice``).
- :func:`execute_plan` streams the tiles: it preallocates this rank's
  destination chunk, then for each tile slices this rank's part of the tile
  into one contiguous send buffer, moves it with one ``all_to_all_single``
  (split to split) or one all-gather into one buffer (split to None), and writes what
  arrives into the destination in place (None to split needs no
  collective: a local slice of each tile).  Beyond source and destination
  the working set is one tile's send and receive buffers, at most the
  budget plus one tile.  Under gloo alone (several ranks on one card) a
  gathered tile goes through host memory, since gloo's gather of CUDA
  tensors holds a second device copy of the tile.  With ``donate`` the source is dropped once its
  last tile is in the send buffer.

Accounting: the tiles' wire bytes telescope to the monolithic collective's
(``comm.traffic()`` gives the same bytes under the same name, ``Alltoall``
or ``Allgather``, in K calls).

The budget is the explicit ``memory_budget=`` where given, else the
process default (:func:`set_redistribution_budget`), else the environment
variable ``HEAT_TPU_RESPLIT_BUDGET``, read once at import (K/M/G suffixes).
``None`` or 0 means unbounded: one monolithic collective.  At world size 1
a resplit moves nothing and no plan runs.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

# the gather into one tensor (``all_gather_into_tensor``, renamed ``all_gather_single`` in later torch)
_ALL_GATHER = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor

__all__ = [
    "ResplitPlan",
    "execute_plan",
    "get_redistribution_budget",
    "make_plan",
    "parse_budget",
    "plan_resplit",
    "set_redistribution_budget",
]


def parse_budget(budget) -> Optional[int]:
    """A budget in bytes: ints pass through, strings take K/M/G(B)
    suffixes (``"64M"`` is 67108864); ``None``, 0, negative and the empty
    string mean unbounded (``None``)."""
    if budget is None:
        return None
    if isinstance(budget, str):
        text = budget.strip().upper().removesuffix("B")
        if not text:
            return None
        scale = 1
        if text[-1] in "KMG":
            scale = 1024 ** ("KMG".index(text[-1]) + 1)
            text = text[:-1]
        budget = int(float(text) * scale)  # scale before truncating: "0.5G" is 512M
    else:
        budget = int(budget)
    return budget if budget > 0 else None


_DEFAULT_BUDGET: Optional[int] = parse_budget(os.environ.get("HEAT_TPU_RESPLIT_BUDGET"))


def set_redistribution_budget(budget) -> Optional[int]:
    """Set the process-wide default resplit budget (bytes, K/M/G suffixes;
    ``None``/0: unbounded).  Returns the previous value."""
    global _DEFAULT_BUDGET
    prev = _DEFAULT_BUDGET
    _DEFAULT_BUDGET = parse_budget(budget)
    return prev


def get_redistribution_budget() -> Optional[int]:
    """The process-wide default resplit budget in bytes (None: unbounded)."""
    return _DEFAULT_BUDGET


@dataclass(frozen=True)
class ResplitPlan:
    """A split→split transition decomposed into K tiled steps.

    ``tile_axis`` is None iff the plan is monolithic (``n_tiles == 1``,
    ``reason`` says why); otherwise tile ``i`` covers ``[i*tile_extent,
    min((i+1)*tile_extent, gshape[tile_axis]))`` along ``tile_axis``: the
    tiles partition the array exactly."""

    gshape: Tuple[int, ...]
    itemsize: int
    src_split: Optional[int]
    dst_split: Optional[int]
    size: int
    budget: Optional[int]
    tile_axis: Optional[int]
    tile_extent: int
    n_tiles: int
    total_bytes: int
    reason: str

    def tile_bounds(self, i: int) -> Tuple[int, int]:
        """(start, length) of tile ``i`` along ``tile_axis``."""
        if self.tile_axis is None:
            return 0, self.gshape[0] if self.gshape else 0
        n = self.gshape[self.tile_axis]
        start = i * self.tile_extent
        return start, min(self.tile_extent, n - start)

    def tile_nbytes(self, length: int) -> int:
        """Payload bytes of a tile spanning ``length`` along ``tile_axis``."""
        if self.tile_axis is None:
            return self.total_bytes
        n = self.gshape[self.tile_axis]
        return (self.total_bytes // n) * length if n else 0

    @property
    def max_tile_bytes(self) -> int:
        return self.tile_nbytes(self.tile_extent) if self.tile_axis is not None else self.total_bytes


def _mono(gshape, itemsize, src, dst, size, budget, total, reason) -> ResplitPlan:
    return ResplitPlan(
        gshape=tuple(gshape), itemsize=itemsize, src_split=src, dst_split=dst,
        size=size, budget=budget, tile_axis=None, tile_extent=0, n_tiles=1,
        total_bytes=total, reason=reason,
    )


def plan_resplit(
    gshape,
    itemsize: int,
    src_split: Optional[int],
    dst_split: Optional[int],
    size: int,
    memory_budget: Optional[int],
) -> ResplitPlan:
    """Decompose the (src_split → dst_split) transition of a ``gshape`` array
    of ``itemsize``-byte elements over ``size`` shards into tiles of at most
    ``memory_budget`` bytes each.  Pure shard math: a monolithic K=1 plan
    (with ``reason``) wherever tiling does not apply."""
    gshape = tuple(int(s) for s in gshape)
    ndim = len(gshape)
    if src_split is not None and ndim:
        src_split = src_split % ndim
    if dst_split is not None and ndim:
        dst_split = dst_split % ndim
    total = int(np.prod(gshape, dtype=np.int64)) * int(itemsize) if gshape else int(itemsize)
    budget = parse_budget(memory_budget)
    args = (gshape, int(itemsize), src_split, dst_split, int(size), budget, total)
    if budget is None:
        return _mono(*args, "no-budget")
    if ndim < 2:
        return _mono(*args, "too-few-dims")
    if total <= budget:
        return _mono(*args, "fits-in-budget")
    if src_split is not None and gshape[src_split] % size != 0:
        return _mono(*args, "ragged-src")
    if dst_split is not None and gshape[dst_split] % size != 0:
        return _mono(*args, "ragged-dst")
    candidates = [
        i for i in range(ndim)
        if i != src_split and i != dst_split and gshape[i] >= 2
    ]
    if not candidates:
        return _mono(*args, "no-free-axis")
    # largest extent → finest achievable granularity (ties: lowest axis)
    axis = max(candidates, key=lambda i: (gshape[i], -i))
    n = gshape[axis]
    per_index = total // n  # bytes of one tiling-axis slice
    extent = max(1, budget // per_index) if per_index else n
    if extent >= n:
        return _mono(*args, "fits-in-budget")
    n_tiles = -(-n // extent)
    reason = "tiled" if per_index <= budget else "tiled-floor-one-slice"
    return ResplitPlan(
        gshape=gshape, itemsize=int(itemsize), src_split=src_split,
        dst_split=dst_split, size=int(size), budget=budget, tile_axis=axis,
        tile_extent=extent, n_tiles=n_tiles, total_bytes=total, reason=reason,
    )


def make_plan(comm, gshape, itemsize: int, src_split: Optional[int], dst_split: Optional[int],
              memory_budget=None) -> Optional[ResplitPlan]:
    """The plan of a resplit on ``comm``, or None where no budget applies
    (``memory_budget=None`` takes the process default; 0 forces the
    monolithic path) or the transition moves nothing (world size 1, or the
    splits agree)."""
    budget = get_redistribution_budget() if memory_budget is None else parse_budget(memory_budget)
    if budget is None or src_split == dst_split or not comm.is_distributed():
        return None
    return plan_resplit(gshape, itemsize, src_split, dst_split, comm.size, budget)


def monolithic_wire(comm, lshape, itemsize: int, src_split, dst_split, counts) -> Tuple[Optional[str], int]:
    """(collective name, wire bytes) that the monolithic resplit of this
    rank's chunk of ``lshape`` accounts: ``Alltoall`` of the chunk at
    (p-1)/p, ``Allgather`` of the chunk padded to the largest at p-1, or
    nothing (None to split is a local slice)."""
    p = comm.size
    if src_split is None:
        return None, 0
    if dst_split is None:
        other = int(np.prod([s for i, s in enumerate(lshape) if i != src_split], dtype=np.int64))
        return "Allgather", int(round(other * max(counts) * itemsize * (p - 1)))
    return "Alltoall", int(round(int(np.prod(lshape, dtype=np.int64)) * itemsize * (p - 1) / p))


def _offsets(counts: Sequence[int]) -> list:
    return [int(v) for v in np.concatenate([[0], np.cumsum(counts)])]


def execute_plan(comm, source, plan: ResplitPlan, counts: Optional[Sequence[int]] = None,
                 donate: bool = False) -> torch.Tensor:
    """Run a K > 1 :class:`ResplitPlan` on this rank's chunk: returns its
    chunk of the destination split (``chunk``'s layout).  ``counts`` are
    every rank's extents along the source split (``chunk``'s when not
    given).  ``donate``: ``source`` is a one-element list holding the only
    reference to the chunk, which is emptied and the chunk dropped once the
    last tile has left it."""
    x = source.pop() if donate else source
    gshape, axis = plan.gshape, plan.tile_axis
    src, dst = plan.src_split, plan.dst_split
    p, rank = comm.size, comm.rank
    if src is not None and counts is None:
        counts = comm.counts_displs_shape(gshape, src)[0]
    out = x.new_empty(comm.chunk(gshape, dst)[1])
    name, total = monolithic_wire(comm, tuple(x.shape), x.element_size(), src, dst, counts)
    n, accounted = gshape[axis], 0
    if dst is not None:
        dcounts = comm.counts_displs_shape(gshape, dst)[0]
        doff = _offsets(dcounts)
    if src is not None:
        soff = _offsets(counts)
    for i in range(plan.n_tiles):
        start, length = plan.tile_bounds(i)
        piece = x.narrow(axis, start, length)
        target = out.narrow(axis, start, length)
        last = i == plan.n_tiles - 1
        if src is None:  # None -> split: this rank's slice of the tile, no collective
            target.copy_(piece.narrow(dst, doff[rank], dcounts[rank]))
        elif dst is None:  # split -> None: every rank's part of the tile, gathered
            width = max(counts)
            shape = list(piece.shape)
            shape[src] = width
            send = piece.new_zeros(shape) if piece.shape[src] != width else piece.contiguous()
            if send is not piece and piece.shape[src]:
                send.narrow(src, 0, piece.shape[src]).copy_(piece)
            del piece
            if last and donate:
                del x
            if send.is_cuda and not comm._nccl():
                # gloo alone (ranks sharing a card) gathers CUDA tensors through a device copy of the
                # whole tile besides the output: the tile goes through host memory instead
                send = send.cpu()
            # one buffer, the pieces one after another along axis 0: no list gathered and copied out
            parts = send.new_empty((p * send.shape[0],) + tuple(send.shape[1:]))
            _ALL_GATHER(parts, send, group=comm.group)
            parts = parts.view((p,) + tuple(send.shape))
            del send
            for s in range(p):
                target.narrow(src, soff[s], counts[s]).copy_(parts[s].narrow(src, 0, counts[s]))
            del parts
        else:  # split -> split: one all_to_all_single of the tile's pieces
            item = piece.element_size()
            pieces = [piece.narrow(dst, doff[r], dcounts[r]) for r in range(p)]
            send_sizes = [pc.numel() * item for pc in pieces]
            send = torch.empty(sum(send_sizes), dtype=torch.uint8, device=piece.device)
            for pc, lo, size in zip(pieces, _offsets(send_sizes), send_sizes):
                send[lo:lo + size].view(piece.dtype).view(pc.shape).copy_(pc)
            del pieces, piece
            if last and donate:
                del x
            shapes = []
            for s in range(p):
                shape = list(target.shape)
                shape[src] = counts[s]
                shapes.append(shape)
            recv_sizes = [int(np.prod(sh, dtype=np.int64)) * item for sh in shapes]
            recv = torch.empty(sum(recv_sizes), dtype=torch.uint8, device=send.device)
            dist.all_to_all_single(recv, send, recv_sizes, send_sizes, group=comm.group)
            del send
            for s, lo, size in zip(range(p), _offsets(recv_sizes), recv_sizes):
                target.narrow(src, soff[s], counts[s]).copy_(recv[lo:lo + size].view(out.dtype).view(shapes[s]))
            del recv
        if name is not None:
            wire = total * (start + length) // n - accounted  # telescoped: the sum is the monolithic bytes
            accounted += wire
            comm._account_bytes(name, wire)
    return out
