"""Ring attention: exact attention over a sequence split across processes
(reference: ``heat_tpu/parallel/ring_attention.py``).

Each rank holds its LOCAL block of the sequence (HeAT's ``chunk`` along the
sequence axis: the first ``S % p`` ranks hold one row more), where the
reference takes global arrays sharded over its mesh.  The K/V blocks rotate
around the ring of ranks while each rank's query block stays: at step j
rank r holds the block of rank ``(r - j) % p`` and attends it with
:func:`~heat_tpu_torch.ops.flash_attention.flash_attention_block` (the
positions kernels on the card), and the blocks' outputs merge exactly by
their logsumexps.  Every rank's blocks are padded to the longest local
length, ``ceil(S / p)`` for HeAT's chunk, pad keys at position 2**30, so the
ranks exchange tensors of one shape; pad queries are sliced off.

The backward needs no code of its own: torch's autograd differentiates the
merge, the block's autograd function runs the backward kernels, and the
rotation is an autograd function whose backward sends the gradient back
the other way.  Three rules keep the ranks' communication in step, so that
no rank waits on a send another never makes:
- K and V rotate as ONE stacked tensor, one ``Send`` a step;
- the positions of a visiting block are computed (it came from rank
  ``(r - j) % p``), never sent;
- the last rotation, whose result nobody reads, is not made;
- a block skipped whole (the dense steps' causal skip) keeps its K/V in the
  graph, with a zero gradient.
Every rank then builds the same graph with the same sequence of sends, in
the forward and in the backward.

``sequence_lengths`` gathers every rank's local lengths in one Allgather of
a small host tensor; :func:`ring_attention` makes one such call, and so does
a ``MultiheadAttention`` forward that is not given them (it needs the
rank's offset for rotary positions too).  ``TransformerLM`` gathers them
once a forward and hands them to every block.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch

from ..ops.flash_attention import (
    NO_MASS,
    POS_PAD,
    _block_mask,
    _dense_attention,
    _dense_block_pos,
    flash_attention,
    flash_attention_block,
)

__all__ = ["ring_attention", "ring_self_attention", "sequence_lengths"]

# calls that took the ring (K/V rotation over the ranks) or the one-process
# path (world size 1: the whole sequence on one rank)
path_counts = {"ring": 0, "global": 0}


def _global_attention(q, k, v, causal: bool, scale: float):
    """Dense attention over one rank's whole sequence, rectangular shapes
    allowed, top-left causal: the one dense softmax path of the package."""
    return _dense_attention(q, k, v, causal, scale, k.shape[-2])


def sequence_lengths(comm, n_q: int, n_kv: int) -> Tuple[Tuple[int, int], ...]:
    """Every rank's local (query, key/value) sequence lengths, in rank order:
    one Allgather of a host tensor."""
    mine = torch.tensor([int(n_q), int(n_kv)], dtype=torch.int64)
    return tuple((int(t[0]), int(t[1])) for t in comm.Allgather(mine))


class _RingShift(torch.autograd.Function):
    """``comm.Send(x, shift)``; the gradient goes back by ``Send(g, -shift)``."""

    @staticmethod
    def forward(ctx, x, comm, shift: int):
        ctx.comm, ctx.shift = comm, shift
        return comm.Send(x, shift)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.Send(g.contiguous(), -ctx.shift), None, None


class _DeadBlock(torch.autograd.Function):
    """The (O = 0, lse = -1e30) of a block whose keys all lie after every
    query here, without its two products.  The visiting K/V stay in the
    graph, with a zero gradient, so this rank's backward still makes the
    rotation's send that every other rank makes."""

    @staticmethod
    def forward(ctx, q, kv):
        ctx.kv_meta = (kv.shape, kv.dtype, kv.device)
        return torch.zeros_like(q), torch.full(q.shape[:-1], NO_MASS, dtype=torch.float32, device=q.device)

    @staticmethod
    def backward(ctx, g_out, g_lse):
        shape, dtype, device = ctx.kv_meta
        return None, torch.zeros(shape, dtype=dtype, device=device)


def _pad_seq(t: torch.Tensor, n: int) -> torch.Tensor:
    """``t`` zero-padded along the sequence axis (-2) to ``n`` rows."""
    return torch.nn.functional.pad(t, (0, 0, 0, n - t.shape[-2])) if n > t.shape[-2] else t


def _positions(offset: int, n: int, blk: int, device) -> torch.Tensor:
    """int32 positions offset, offset + 1, ... of n rows, padded to blk rows at the pad sentinel."""
    pos = torch.full((blk,), POS_PAD, dtype=torch.int32, device=device)
    pos[:n] = torch.arange(offset, offset + n, dtype=torch.int32, device=device)
    return pos


def _ring(q, k, v, comm, causal: bool, scale: float, kernel: str, lengths: Sequence[Tuple[int, int]]):
    """The ring over ``comm.size > 1`` ranks; ``lengths`` is
    :func:`sequence_lengths`'s, this rank's blocks are ``q``, ``k``, ``v``."""
    path_counts["ring"] += 1
    p, r = comm.size, comm.rank
    n_q = [a for a, _ in lengths]
    n_kv = [b for _, b in lengths]
    off_q = [sum(n_q[:i]) for i in range(p)]
    off_kv = [sum(n_kv[:i]) for i in range(p)]
    S_kv = sum(n_kv)
    blk_q, blk_k = max(n_q), max(n_kv)
    # no causal constraint and no pad key: the "no pad" sentinel leaves the block unmasked
    s_valid = S_kv if (causal or blk_k * p != S_kv) else 2**31 - 1
    q_pos = _positions(off_q[r], n_q[r], blk_q, q.device)
    q_last = off_q[r] + n_q[r] - 1  # the last real query's position
    q_blk = _pad_seq(q, blk_q)
    kv = torch.stack([_pad_seq(k, blk_k), _pad_seq(v, blk_k)])  # K and V rotate as one tensor
    o = torch.zeros(q_blk.shape, dtype=torch.float32, device=q.device)
    # -1e30, not -inf: the first merge takes exp(lse - lse'), and -inf - (-inf) would be NaN
    lse = torch.full(q_blk.shape[:-1], NO_MASS, dtype=torch.float32, device=q.device)
    for j in range(p):
        src = (r - j) % p  # the rank whose K/V block visits at step j
        k_pos = _positions(off_kv[src], n_kv[src], blk_k, q.device)
        if kernel == "dense":
            if causal and (n_kv[src] == 0 or off_kv[src] > q_last):
                # the whole block lies after every query here: skip both products, as the reference does
                ob, lb = _DeadBlock.apply(q_blk, kv)
            else:
                ob, lb = _dense_block_pos(q_blk, kv[0], kv[1], q_pos, k_pos, causal, scale,
                                          *_block_mask(causal, s_valid))
        else:
            ob, lb = flash_attention_block(q_blk, kv[0], kv[1], q_pos, k_pos, causal=causal, scale=scale,
                                           s_valid=s_valid)
        lse_new = torch.logaddexp(lse, lb)
        o = o * torch.exp(lse - lse_new)[..., None] + ob.float() * torch.exp(lb - lse_new)[..., None]
        lse = lse_new
        if j < p - 1:
            kv = _RingShift.apply(kv, comm, 1)
    return o.to(q.dtype)[..., : n_q[r], :]


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, comm, causal: bool = False,
                   scale: Optional[float] = None, kernel: str = "auto") -> torch.Tensor:
    """Exact softmax attention over a sequence split across ``comm``'s ranks.

    ``q``: ``(..., S_local, d)``, this rank's block of the query sequence;
    ``k``, ``v``: ``(..., S_kv_local, d)``, its block of the key/value
    sequence, with q's leading axes.  Returns this rank's block of the
    output, ``(..., S_local, d)`` in q's dtype.  Cross-attention (another
    key/value length) rides the ring too; ``causal`` is top-left aligned
    over GLOBAL positions (a query at position i attends keys <= i).

    ``kernel``: ``'auto'`` or ``'flash'`` run each ring step through
    ``flash_attention_block`` (the positions kernels on a CUDA tensor, their
    plain versions on a CPU one); ``'dense'`` through the dense block, with
    the reference's whole-block causal skip.  At world size 1 the call is
    ``flash_attention`` (or dense attention for rectangular shapes), as in
    the reference."""
    if kernel not in ("auto", "flash", "dense"):
        raise ValueError(f"kernel must be 'auto'|'flash'|'dense', got {kernel!r}")
    d = q.shape[-1]
    if k.shape != v.shape or k.shape[:-2] != q.shape[:-2] or k.shape[-1] != d:
        raise ValueError(f"ring_attention requires k.shape == v.shape and q/k agreeing in every axis but the "
                         f"sequence, got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)} — repeat shared K/V "
                         f"(e.g. MQA) to q's leading shape before the call")
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    if comm.size == 1:
        path_counts["global"] += 1
        if k.shape == q.shape:
            return flash_attention(q, k, v, causal=causal, scale=scale)
        return _global_attention(q, k, v, causal, scale)
    return _ring(q, k, v, comm, causal, scale, kernel, sequence_lengths(comm, q.shape[-2], k.shape[-2]))


def ring_self_attention(q, k, v, comm, causal: bool = False, scale: Optional[float] = None):
    """2-D ``(S_local, d)`` alias of :func:`ring_attention` (the original API)."""
    return ring_attention(q, k, v, comm, causal=causal, scale=scale)
