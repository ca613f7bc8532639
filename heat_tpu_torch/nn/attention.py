"""Multi-head attention (reference: ``heat_tpu/nn/attention.py``).

``MultiheadAttention`` keeps the reference's (and torch's) packed-projection
parameters, ``in_proj_weight`` (E + 2·kv_dim, E), ``in_proj_bias`` and
``out_proj``, so parameters carry over one to one; kv_dim = num_kv_heads ·
head_dim, so the packed projection is torch's (3E, E) unless grouped-query
attention (``num_kv_heads < num_heads``) shrinks it.  Unmasked
self-attention runs the flash kernels (the grouped ones under grouped-query
attention, which never repeat K/V), and so does multi-head
cross-attention over a memory of the query's length; masks,
``need_weights`` and other cross-attention run the dense path, over K/V
repeated to the query heads where they are grouped.  Decoding attends a cache of ``num_kv_heads`` heads
through one grouped tail.

With ``comm=`` unmasked self- and cross-attention run sequence-parallel on
the ring (``parallel.ring_attention``): ``x`` (and ``kv``) are this rank's
blocks of the sequence (HeAT's ``chunk``; the reference takes global arrays
and shards them), grouped K/V heads are repeated to the query heads before
the ring, and rotary positions are global, this rank's offset plus the
local index.  The offset comes from the ranks' lengths: one small
Allgather a call, unless the caller passes them (``TransformerLM`` gathers
them once a forward for all its blocks).  Masks and
``need_weights`` raise on more than one rank; decoding ignores ``comm``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..ops.flash_attention import _dense_attention, flash_attention, flash_attention_gqa
from ..parallel.ring_attention import _ring, ring_attention, sequence_lengths
from .modules import Linear, _device

__all__ = ["MultiheadAttention", "apply_rope"]


def apply_rope(x: torch.Tensor, positions, base: float = 10000.0) -> torch.Tensor:
    """Rotary position embedding on per-head states x (..., S, d): consecutive
    channel pairs rotate by position-dependent angles, so q·k depends only on
    the relative position.  ``positions`` broadcasts against the S axis: an
    ``arange`` for a sequence, a scalar for one decode step."""
    d = x.shape[-1]
    if d % 2:
        raise ValueError(f"rope requires an even head dim, got {d}")
    freqs = base ** (-torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d)
    ang = torch.as_tensor(positions, dtype=torch.float32, device=x.device)[..., None] * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


class MultiheadAttention(torch.nn.Module):
    """Multi-head attention with torch's parameter conventions, batch first.

    ``forward(x, kv=None, causal=False, key_padding_mask=None,
    attn_mask=None, need_weights=False, average_attn_weights=True)`` is the
    reference's ``apply``: self-attention on ``x`` (B, S, E), or
    cross-attention against ``kv`` (B, S_kv, E).  Masks follow torch:
    ``key_padding_mask`` (B, S_k) bool, True = ignore that key;
    ``attn_mask`` (S_q, S_k) bool (True = NOT allowed) or float (added to
    the scores).  With ``comm`` the inputs are this rank's sequence blocks
    and unmasked attention runs on the ring.  ``init_cache``/``decode_step``
    decode one token at a time against a static KV cache;
    ``precompute_kv``/``cross_step`` do the same against a fixed memory."""

    def __init__(self, embed_dim: int, num_heads: int, bias: bool = True, batch_first: bool = True, comm=None,
                 rope: bool = False, rope_base: float = 10000.0, num_kv_heads: int = None, device=None,
                 dtype=None):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} not divisible by num_heads {num_heads}")
        if not batch_first:
            raise ValueError("only batch_first=True is supported (framework layout)")
        if rope and (embed_dim // num_heads) % 2:
            raise ValueError("rope requires an even head dim")
        if num_kv_heads is None:
            num_kv_heads = num_heads
        if num_kv_heads < 1 or num_heads % num_kv_heads:
            raise ValueError(f"num_heads {num_heads} not divisible by num_kv_heads {num_kv_heads}")
        self.comm = comm  # the sequence-parallel ring's communicator, or None
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.num_kv_heads = num_kv_heads  # < num_heads: grouped-query attention
        self.kv_dim = num_kv_heads * self.head_dim
        self.bias = bias
        self.rope = rope  # rotary positions on self-attention q/k (not cross)
        self.rope_base = rope_base
        dev = _device(device)
        E = embed_dim
        rows = E + 2 * self.kv_dim
        self.in_proj_weight = torch.nn.Parameter(torch.empty((rows, E), device=dev, dtype=dtype))
        if bias:
            self.in_proj_bias = torch.nn.Parameter(torch.zeros(rows, device=dev, dtype=dtype))
        else:
            self.register_parameter("in_proj_bias", None)
        self.out_proj = Linear(E, E, bias=bias, device=device, dtype=dtype)
        self.reset_parameters()

    def reset_parameters(self) -> None:
        """The reference's init: xavier-uniform packed projection of E +
        2·kv_dim rows, zero biases, out_proj weight uniform in ±1/sqrt(E)."""
        torch.nn.init.xavier_uniform_(self.in_proj_weight)
        self.out_proj.reset_parameters()
        for b in (self.in_proj_bias, self.out_proj.bias):
            if b is not None:
                torch.nn.init.zeros_(b)

    def _heads(self, t: torch.Tensor, n_heads: int = None) -> torch.Tensor:
        B, S, _ = t.shape
        return t.reshape(B, S, n_heads or self.num_heads, self.head_dim).transpose(1, 2)

    def _split_heads(self, x: torch.Tensor):
        """The packed projection of x, split [E, kv_dim, kv_dim] into q, k, v heads."""
        q, k, v = F.linear(x, self.in_proj_weight, self.in_proj_bias).split(
            [self.embed_dim, self.kv_dim, self.kv_dim], dim=-1)
        return self._heads(q), self._heads(k, self.num_kv_heads), self._heads(v, self.num_kv_heads)

    def _repeat_kv(self, kh: torch.Tensor, vh: torch.Tensor):
        """Grouped K/V heads repeated to the query heads, for the dense paths
        (masks, need_weights, cross-attention); the grouped flash kernels and
        the decode tail do without the copy."""
        g = self.num_heads // self.num_kv_heads
        if g == 1:
            return kh, vh
        return kh.repeat_interleave(g, dim=1), vh.repeat_interleave(g, dim=1)

    def _project(self, x: torch.Tensor, rows: slice) -> torch.Tensor:
        b = self.in_proj_bias
        return F.linear(x, self.in_proj_weight[rows], None if b is None else b[rows])

    def _project_kv(self, kv: torch.Tensor):
        """``num_kv_heads`` K and V heads of kv, from the packed projection's K/V rows."""
        E, n = self.embed_dim, self.num_kv_heads
        k = self._project(kv, slice(E, E + self.kv_dim))
        v = self._project(kv, slice(E + self.kv_dim, E + 2 * self.kv_dim))
        return self._heads(k, n), self._heads(v, n)

    def _merge_project(self, out: torch.Tensor) -> torch.Tensor:
        B, H, S, d = out.shape
        return self.out_proj(out.transpose(1, 2).reshape(B, S, self.embed_dim))

    def _masked_dense(self, qh, kh, vh, causal, key_padding_mask, attn_mask, return_probs: bool = False):
        """Torch-convention masks as ONE additive float32 bias into the dense path."""
        neg = float("-inf")
        bias = torch.zeros((), dtype=torch.float32, device=qh.device)
        if attn_mask is not None:
            attn_mask = torch.as_tensor(attn_mask, device=qh.device)
            if attn_mask.dtype == torch.bool:  # True = NOT allowed
                bias = bias + torch.zeros(attn_mask.shape, device=qh.device).masked_fill(attn_mask, neg)
            else:
                bias = bias + attn_mask.float()
        if key_padding_mask is not None:
            kpm = torch.as_tensor(key_padding_mask, dtype=torch.bool, device=qh.device)[:, None, None, :]
            bias = bias + torch.zeros(kpm.shape, device=qh.device).masked_fill(kpm, neg)
        return _dense_attention(qh, kh, vh, causal, 1.0 / math.sqrt(self.head_dim), kh.shape[-2], bias=bias,
                                return_probs=return_probs)

    def forward(self, x: torch.Tensor, kv: torch.Tensor = None, causal: bool = False, key_padding_mask=None,
                attn_mask=None, need_weights: bool = False, average_attn_weights: bool = True, lengths=None):
        """``lengths``: with ``comm`` over more than one rank, every rank's
        (query, key/value) local lengths as ``sequence_lengths`` gives them,
        from a caller that gathered them once for several layers; without
        it this call gathers them (one small Allgather)."""
        E = self.embed_dim
        masked = key_padding_mask is not None or attn_mask is not None
        split = self.comm is not None and self.comm.size > 1
        if split and (need_weights or masked):
            # the inputs are local blocks: a dense path would see this rank's keys only
            raise ValueError("need_weights and key_padding_mask/attn_mask are not supported on the sequence-parallel "
                             "ring path (comm= over more than one rank); use causal=, or mask the inputs first")
        ring = self.comm is not None and not masked and not need_weights
        offset = 0
        if split:
            if lengths is None:
                lengths = sequence_lengths(self.comm, x.shape[1], (x if kv is None else kv).shape[1])
            offset = sum(n for n, _ in lengths[: self.comm.rank])
        if kv is None:
            qh, kh, vh = self._split_heads(x)
            if self.rope:
                pos = torch.arange(offset, offset + qh.shape[-2], device=x.device)  # global positions
                qh = apply_rope(qh, pos, self.rope_base)
                kh = apply_rope(kh, pos, self.rope_base)
        else:
            qh = self._heads(self._project(x, slice(0, E)))
            kh, vh = self._project_kv(kv)
        probs = None
        grouped = self.num_kv_heads != self.num_heads
        if ring:
            # the ring rotates full-head K/V blocks: grouped heads are repeated first, as in the reference
            kr, vr = self._repeat_kv(kh, vh)
            if split:
                out = _ring(qh, kr, vr, self.comm, causal, 1.0 / math.sqrt(self.head_dim), "auto", lengths)
            else:
                out = ring_attention(qh, kr, vr, self.comm, causal=causal)
        elif masked or need_weights:
            out = self._masked_dense(qh, *self._repeat_kv(kh, vh), causal, key_padding_mask, attn_mask,
                                     return_probs=need_weights)
            if need_weights:
                out, probs = out
        elif grouped and kv is None:
            out = flash_attention_gqa(qh, kh, vh, causal=causal)
        elif not grouped and qh.shape == kh.shape == vh.shape:
            out = flash_attention(qh, kh, vh, causal=causal)
        else:
            out = _dense_attention(qh, *self._repeat_kv(kh, vh), causal, 1.0 / math.sqrt(self.head_dim),
                                   kh.shape[-2])
        y = self._merge_project(out)
        if need_weights:
            # torch's contract: (B, S_q, S_k) averaged over heads, or (B, H, S_q, S_k)
            return y, (probs.mean(dim=1) if average_attn_weights else probs)
        return y

    # ------------------------------------------------------------------ #
    # autoregressive decoding
    # ------------------------------------------------------------------ #

    def init_cache(self, batch: int, max_len: int, dtype=torch.float32) -> dict:
        """Static KV cache for :meth:`decode_step`: (B, num_kv_heads, max_len,
        d) buffers written in place, one position a step, and the next position."""
        shape = (batch, self.num_kv_heads, max_len, self.head_dim)
        dev = self.in_proj_weight.device
        return {"k": torch.zeros(shape, dtype=dtype, device=dev), "v": torch.zeros(shape, dtype=dtype, device=dev),
                "index": 0}

    def decode_step(self, x: torch.Tensor, cache: dict):
        """One step: ``x`` (B, 1, E) at position ``cache['index']``.  Its K/V
        are written into the cache in place (the reference returns a new
        cache; here the buffers are updated and the same dict is returned),
        and the query attends to every cached position up to it.  Returns
        ``(y (B, 1, E), cache)``."""
        i = int(cache["index"])
        if i >= cache["k"].shape[2]:
            raise ValueError(f"decode_step past cache capacity: index {i} >= max_len {cache['k'].shape[2]}")
        qh, kh, vh = self._split_heads(x)
        if self.rope:
            # the cache holds rotated keys, so cached entries carry their positions
            qh = apply_rope(qh, i, self.rope_base)
            kh = apply_rope(kh, i, self.rope_base)
        cache["k"][:, :, i : i + 1] = kh.to(cache["k"].dtype)
        cache["v"][:, :, i : i + 1] = vh.to(cache["v"].dtype)
        live = torch.arange(cache["k"].shape[2], device=x.device) <= i  # unwritten slots are dead
        y = self._attend_merge_project(qh, cache["k"], cache["v"], live)
        cache["index"] = i + 1
        return y, cache

    def _attend_merge_project(self, qh, kh, vh, live=None) -> torch.Tensor:
        """The one-query decode tail: scores (``live`` key slots only),
        softmax, value contraction, head merge, output projection.  Grouped:
        each of the kh.shape[1] K/V heads serves its group of G query heads
        (G = 1 without grouped-query attention), so K/V are not repeated."""
        B, H, Sq, d = qh.shape
        hk = kh.shape[1]
        qg = qh.reshape(B, hk, H // hk, Sq, d)
        s = torch.einsum("bkgqd,bkld->bkgql", qg, kh) / math.sqrt(self.head_dim)
        if live is not None:
            s = s.masked_fill(~live, float("-inf"))
        out = torch.einsum("bkgql,bkld->bkgqd", torch.softmax(s, dim=-1), vh)
        return self._merge_project(out.reshape(B, H, Sq, d))

    def precompute_kv(self, kv: torch.Tensor):
        """Per-head K/V (B, num_kv_heads, S_kv, d) of a memory, projected once for :meth:`cross_step`."""
        return self._project_kv(kv)

    def cross_step(self, x: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor) -> torch.Tensor:
        """One-query cross-attention of x (B, 1, E) against :meth:`precompute_kv`'s K/V."""
        return self._attend_merge_project(self._heads(self._project(x, slice(0, self.embed_dim))), kh, vh)
