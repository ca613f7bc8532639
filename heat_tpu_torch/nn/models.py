"""Models (reference: ``heat_tpu/nn/models.py``): the transformers, the MLP and the ResNets.

``TransformerLM`` is the GPT-style causal language model of the reference:
token embedding + positions + pre-norm causal blocks + final LayerNorm +
LM head.  ``forward`` is the reference's teacher-forced ``apply`` and runs
the flash kernels in every block (forward, and dq and dk/dv under
``backward``; the grouped ones with ``num_kv_heads < num_heads``).
``generate`` decodes against a static KV cache: the reference compiles
the whole loop into one ``lax.scan``; here it is a Python loop over a
preallocated cache written in place, one ``decode_step`` per position, with
no host round trip inside the loop.

With ``comm=`` every block's attention runs on the sequence-parallel ring
(the positions kernels), and ``forward`` takes this rank's block of the
sequence.  A training step over the ranks does explicitly what the
reference's sharded program does implicitly: the loss is the global mean
(the local sum, Allreduced, over the global token count) and the
gradients are summed over the ranks by the bucketed sync
(``core.collectives.bucketed_grad_allreduce(..., op="sum")``).

``num_experts`` swaps every block's FFN for its own ``MoE`` of the same
hidden width (``moe_top_k``, ``moe_capacity_factor``; the Switch block):
the reference shares one stateless ``MoE`` between its blocks, each with
its own parameters; here each block owns its ``MoE`` module.  Under
``comm`` the experts are sharded over the ring's ranks and each rank
routes the tokens of its block of the sequence (the reference shards the
flattened batch evenly), so where capacity binds the drops differ.
Decoding takes an MoE block through ``MoE.decode_apply`` (drop-free).
``remat=True`` checkpoints each block (``torch.utils.checkpoint``,
non-reentrant, torch's RNG state preserved so dropout replays the same
mask): the backward recomputes the block, its flash forward included.

``transformer_decoder`` and ``Seq2SeqTransformer`` add the pre-norm
decoder block: causal self-attention, cross-attention against the
encoder's ``memory`` (the flash kernels where the memory is as long as the
target, the dense path otherwise), the FFN; under ``comm`` both attentions
ride the ring.  ``Seq2SeqTransformer.generate`` and ``beam_search`` encode
once, project each block's cross-attention K/V once, and run a Python loop
over ``decode_step`` (the reference compiles one ``lax.scan``); beams ride
the batch dimension and each step reorders the self-attention caches by
index.

``mlp`` and the ResNets (``resnet``, ``resnet18``, ``resnet34``,
``resnet50``) build the reference's layer order and shapes from the
vision layers of ``nn.modules``: ``resnet50()`` is the DASO baseline's
model, 1000 classes at width 64, whose stem pools with ``MaxPool2d(3,
stride=2)`` and no padding, as the reference's does (torchvision's pads).
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from ..parallel.ring_attention import sequence_lengths
from .attention import MultiheadAttention
from .moe import MoE
from .modules import (GELU, AdaptiveAvgPool2d, BatchNorm2d, Conv2d, Dropout, Embedding, Flatten, LayerNorm, Linear,
                      MaxPool2d, ReLU, Residual, Sequential, _device)

__all__ = ["mlp", "resnet", "resnet18", "resnet34", "resnet50", "resnet50_ish", "transformer_encoder",
           "transformer_decoder", "TransformerLM", "Seq2SeqTransformer"]


def _basic_block(cin: int, cout: int, stride: int = 1, device=None) -> Sequential:
    """ResNet-v1 basic block: two 3x3 convolutions, each with BatchNorm."""
    body = Sequential(Conv2d(cin, cout, 3, stride=stride, padding=1, bias=False, device=device),
                      BatchNorm2d(cout, device=device), ReLU(),
                      Conv2d(cout, cout, 3, stride=1, padding=1, bias=False, device=device),
                      BatchNorm2d(cout, device=device))
    shortcut = None
    if stride != 1 or cin != cout:
        shortcut = Sequential(Conv2d(cin, cout, 1, stride=stride, bias=False, device=device),
                              BatchNorm2d(cout, device=device))
    return Sequential(Residual(body, shortcut), ReLU())


def _bottleneck_block(cin: int, cmid: int, stride: int = 1, expansion: int = 4, device=None) -> Sequential:
    """ResNet-v1 bottleneck: 1x1 reduce, 3x3 (the stride), 1x1 expand (x4)."""
    cout = cmid * expansion
    body = Sequential(Conv2d(cin, cmid, 1, bias=False, device=device), BatchNorm2d(cmid, device=device), ReLU(),
                      Conv2d(cmid, cmid, 3, stride=stride, padding=1, bias=False, device=device),
                      BatchNorm2d(cmid, device=device), ReLU(),
                      Conv2d(cmid, cout, 1, bias=False, device=device), BatchNorm2d(cout, device=device))
    shortcut = None
    if stride != 1 or cin != cout:
        shortcut = Sequential(Conv2d(cin, cout, 1, stride=stride, bias=False, device=device),
                              BatchNorm2d(cout, device=device))
    return Sequential(Residual(body, shortcut), ReLU())


def resnet(stage_sizes=(2, 2, 2, 2), width: int = 64, num_classes: int = 10, in_channels: int = 3,
           stem_pool: bool = False, device=None) -> Sequential:
    """A ResNet-v1 of basic blocks ((2, 2, 2, 2): ResNet-18's stages) with a
    3x3 stem."""
    layers = [Conv2d(in_channels, width, 3, stride=1, padding=1, bias=False, device=device),
              BatchNorm2d(width, device=device), ReLU()]
    if stem_pool:
        layers.append(MaxPool2d(2))
    cin = width
    for stage, n_blocks in enumerate(stage_sizes):
        cout = width * 2 ** stage
        for b in range(n_blocks):
            layers.append(_basic_block(cin, cout, stride=2 if (b == 0 and stage > 0) else 1, device=device))
            cin = cout
    layers += [AdaptiveAvgPool2d(1), Flatten(), Linear(cin, num_classes, device=device)]
    return Sequential(*layers)


def resnet18(num_classes: int = 10, in_channels: int = 3, device=None) -> Sequential:
    return resnet((2, 2, 2, 2), 64, num_classes, in_channels, device=device)


def resnet34(num_classes: int = 1000, in_channels: int = 3, device=None) -> Sequential:
    return resnet((3, 4, 6, 3), 64, num_classes, in_channels, stem_pool=True, device=device)


def resnet50(num_classes: int = 1000, in_channels: int = 3, width: int = 64, device=None) -> Sequential:
    """ResNet-50: a 7x7 stride-2 stem, ``MaxPool2d(3, stride=2)`` without
    padding, bottleneck blocks in (3, 4, 6, 3) stages, the pooled head."""
    layers = [Conv2d(in_channels, width, 7, stride=2, padding=3, bias=False, device=device),
              BatchNorm2d(width, device=device), ReLU(), MaxPool2d(3, stride=2)]
    cin = width
    for stage, n_blocks in enumerate((3, 4, 6, 3)):
        cmid = width * 2 ** stage
        for b in range(n_blocks):
            layers.append(_bottleneck_block(cin, cmid, stride=2 if (b == 0 and stage > 0) else 1, device=device))
            cin = cmid * 4
    layers += [AdaptiveAvgPool2d(1), Flatten(), Linear(cin, num_classes, device=device)]
    return Sequential(*layers)


resnet50_ish = resnet34  # the reference's older name for its basic-block ResNet-34


def mlp(sizes=(784, 256, 128, 10), device=None) -> Sequential:
    """Linear layers of ``sizes`` with ReLU between (BASELINE config 3's MLP)."""
    layers = []
    for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
        layers.append(Linear(a, b, device=device))
        if i < len(sizes) - 2:
            layers.append(ReLU())
    return Sequential(*layers)


def _ffn(embed_dim: int, mlp_ratio: int, device=None) -> Sequential:
    """THE transformer FFN: Linear, exact GELU, Linear."""
    return Sequential(Linear(embed_dim, mlp_ratio * embed_dim, device=device), GELU(),
                      Linear(mlp_ratio * embed_dim, embed_dim, device=device))


def _block_ffn(embed_dim: int, mlp_ratio: int, num_experts, moe_top_k: int, comm, capacity_factor: float,
               device=None):
    """An ``MoE`` of the dense FFN's hidden width where ``num_experts`` is
    set (the Switch block), else None (the block builds the dense FFN)."""
    if not num_experts:
        return None
    return MoE(embed_dim, num_experts, hidden_dim=mlp_ratio * embed_dim, top_k=moe_top_k,
               capacity_factor=capacity_factor, comm=comm, device=device)


def _ffn_step(ff: torch.nn.Module, x: torch.Tensor) -> torch.Tensor:
    """The FFN of one decode step: an MoE's drop-free path."""
    return ff.decode_apply(x) if isinstance(ff, MoE) else ff(x)


class _Remat(torch.nn.Module):
    """A block whose ``forward`` checkpoints ``_block`` under ``remat`` when
    gradients are on."""

    remat = False

    def forward(self, *args):
        if self.remat and torch.is_grad_enabled():
            return checkpoint(self._block, *args, use_reentrant=False)
        return self._block(*args)


class _TransformerBlock(_Remat):
    """Pre-norm transformer block: x + MHA(LN(x)), then x + FFN(LN(x));
    ``ffn`` replaces the dense FFN (an ``MoE``)."""

    def __init__(self, embed_dim: int, num_heads: int, mlp_ratio: int = 4, causal: bool = False, comm=None,
                 rope: bool = False, num_kv_heads: int = None, dropout: float = 0.0, remat: bool = False,
                 ffn: torch.nn.Module = None, device=None):
        super().__init__()
        self.ln1 = LayerNorm(embed_dim, device=device)
        self.mha = MultiheadAttention(embed_dim, num_heads, comm=comm, rope=rope, num_kv_heads=num_kv_heads,
                                      device=device)
        self.ln2 = LayerNorm(embed_dim, device=device)
        self.ff = ffn if ffn is not None else _ffn(embed_dim, mlp_ratio, device=device)
        self.drop = Dropout(dropout)  # torch TransformerEncoderLayer's residual-branch sites
        self.causal = causal
        self.remat = remat

    def _block(self, x: torch.Tensor, lengths=None) -> torch.Tensor:
        """``lengths``: the ranks' sequence lengths for the attention under
        ``comm`` (see ``MultiheadAttention.forward``), or None to gather them."""
        h = x + self.drop(self.mha(self.ln1(x), causal=self.causal, lengths=lengths))
        return h + self.drop(self.ff(self.ln2(h)))

    def decode_step(self, x: torch.Tensor, cache: dict):
        """One-token block step against the KV cache: the last row of
        :meth:`forward` over the prefix (causal)."""
        a, cache = self.mha.decode_step(self.ln1(x), cache)
        h = x + a
        return h + _ffn_step(self.ff, self.ln2(h)), cache


def transformer_encoder(embed_dim: int = 256, num_heads: int = 8, depth: int = 4, mlp_ratio: int = 4,
                        causal: bool = False, comm=None, remat: bool = False, num_experts: int = None,
                        moe_top_k: int = 2, moe_capacity_factor: float = 1.5, dropout: float = 0.0,
                        device=None) -> Sequential:
    """A stack of pre-norm transformer blocks over (B, S, embed_dim) input,
    bidirectional by default (``causal=True`` for decoder-style masking).
    With ``comm`` every block's attention runs on the sequence-parallel ring
    over this rank's block of the sequence, and each gathers the ranks'
    lengths (one small Allgather a block).  ``num_experts`` gives each block
    its own ``MoE``; ``remat`` checkpoints each block."""
    return Sequential(*[_TransformerBlock(embed_dim, num_heads, mlp_ratio, causal, comm, dropout=dropout,
                                          remat=remat, device=device,
                                          ffn=_block_ffn(embed_dim, mlp_ratio, num_experts, moe_top_k, comm,
                                                         moe_capacity_factor, device))
                        for _ in range(depth)])


class _TransformerDecoderBlock(_Remat):
    """Pre-norm decoder block: x + SelfMHA(LN(x), causal), then x +
    CrossMHA(LN(x), kv=memory), then x + FFN(LN(x)); under ``comm`` both
    attentions ride the ring, the cross-attention against this rank's
    block of the memory."""

    def __init__(self, embed_dim: int, num_heads: int, mlp_ratio: int = 4, comm=None, remat: bool = False,
                 ffn: torch.nn.Module = None, dropout: float = 0.0, device=None):
        super().__init__()
        self.ln1 = LayerNorm(embed_dim, device=device)
        self.self_attn = MultiheadAttention(embed_dim, num_heads, comm=comm, device=device)
        self.ln2 = LayerNorm(embed_dim, device=device)
        self.cross_attn = MultiheadAttention(embed_dim, num_heads, comm=comm, device=device)
        self.ln3 = LayerNorm(embed_dim, device=device)
        self.ff = ffn if ffn is not None else _ffn(embed_dim, mlp_ratio, device=device)
        self.drop = Dropout(dropout)
        self.remat = remat

    def _block(self, x: torch.Tensor, memory: torch.Tensor, self_lengths=None, cross_lengths=None) -> torch.Tensor:
        """``self_lengths``/``cross_lengths``: the ranks' (query, key/value)
        lengths of the two attentions under ``comm``, or None to gather them."""
        h = x + self.drop(self.self_attn(self.ln1(x), causal=True, lengths=self_lengths))
        h = h + self.drop(self.cross_attn(self.ln2(h), kv=memory, lengths=cross_lengths))
        return h + self.drop(self.ff(self.ln3(h)))

    def decode_state(self, memory: torch.Tensor, batch: int, max_len: int, dtype=None) -> dict:
        """An empty self-attention cache and the memory's cross-attention
        K/V, projected once."""
        kh, vh = self.cross_attn.precompute_kv(memory)
        dtype = memory.dtype if dtype is None else dtype
        return {"self": self.self_attn.init_cache(batch, max_len, dtype), "mem_k": kh, "mem_v": vh}

    def decode_step(self, x: torch.Tensor, state: dict):
        """One-token decoder step: the last row of :meth:`forward` over the prefix."""
        a, self_cache = self.self_attn.decode_step(self.ln1(x), state["self"])
        h = x + a
        h = h + self.cross_attn.cross_step(self.ln2(h), state["mem_k"], state["mem_v"])
        return h + _ffn_step(self.ff, self.ln3(h)), {**state, "self": self_cache}


def _lengths(comm, n_q: int, n_kv: int):
    """Under ``comm`` over more than one rank: the ranks' (query, kv)
    lengths, one Allgather, and the self-attention pairs of each side."""
    if comm is None or comm.size == 1:
        return None, None, None
    both = sequence_lengths(comm, n_q, n_kv)
    return both, tuple((q, q) for q, _ in both), tuple((k, k) for _, k in both)


class _TransformerDecoder(torch.nn.ModuleList):
    """Decoder blocks sharing one encoder ``memory``; ``forward(x, memory)``
    with x (B, S_dec, E) and memory (B, S_enc, E), this rank's blocks of
    both under ``comm`` (the ranks' lengths gathered once for every block)."""

    def __init__(self, blocks, comm=None):
        super().__init__(blocks)
        self.comm = comm

    def forward(self, x: torch.Tensor, memory: torch.Tensor) -> torch.Tensor:
        cross, own, _ = _lengths(self.comm, x.shape[1], memory.shape[1])
        for block in self:
            x = block(x, memory, own, cross)
        return x


def transformer_decoder(embed_dim: int = 256, num_heads: int = 8, depth: int = 4, mlp_ratio: int = 4, comm=None,
                        remat: bool = False, num_experts: int = None, moe_top_k: int = 2,
                        moe_capacity_factor: float = 1.5, dropout: float = 0.0, device=None) -> _TransformerDecoder:
    """A stack of pre-norm decoder blocks: causal self-attention, then
    cross-attention against an encoder memory, then the FFN (an ``MoE``
    with ``num_experts``); ``remat`` checkpoints each block."""
    return _TransformerDecoder([
        _TransformerDecoderBlock(embed_dim, num_heads, mlp_ratio, comm, remat=remat, dropout=dropout, device=device,
                                 ffn=_block_ffn(embed_dim, mlp_ratio, num_experts, moe_top_k, comm,
                                                moe_capacity_factor, device))
        for _ in range(depth)], comm)


def _sinusoidal_positions(positions, embed_dim: int, device=None) -> torch.Tensor:
    """The original transformer's fixed sin/cos position code, for any
    position: an arange for a sequence, a scalar for one decode step."""
    half = embed_dim // 2
    div = 10000.0 ** (torch.arange(half, dtype=torch.float32, device=device) / half)
    ang = torch.as_tensor(positions, dtype=torch.float32, device=device)[..., None] / div
    return torch.stack([torch.sin(ang), torch.cos(ang)], dim=-1).reshape(*ang.shape[:-1], 2 * half)


def _normalize_truncation(top_k, top_p, vocab_size: int, sampled: bool):
    """Validate and canonicalize the truncation knobs: greedy decoding
    ignores them; ``top_k`` of 0/None or >= vocab and ``top_p`` of None or
    >= 1 disable them.  Invalid values raise."""
    if not sampled:
        return None, None
    if top_k is not None:
        top_k = int(top_k)
        if top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {top_k}")
        if top_k == 0 or top_k >= vocab_size:
            top_k = None
    if top_p is not None:
        top_p = float(top_p)
        if top_p <= 0.0:
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        if top_p >= 1.0:
            top_p = None
    return top_k, top_p


def _next_token(logits: torch.Tensor, sampled: bool, temperature: float, generator=None, top_k=None,
                top_p=None) -> torch.Tensor:
    """Greedy or sampled next token (B,) int32.  ``top_k`` keeps the k
    highest-probability tokens; ``top_p`` keeps the smallest nucleus whose
    mass reaches p, cut by sorted rank (the top token always survives)."""
    if not sampled:
        return logits.argmax(dim=-1).to(torch.int32)
    logits = logits.float() / temperature
    if top_k is not None and top_k < logits.shape[-1]:
        kth = logits.topk(top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if top_p is not None and top_p < 1.0:
        # a slot is cut when the mass strictly before it in descending order
        # already reaches p: a suffix of the order, never the top slot
        srt, order = logits.sort(dim=-1, descending=True)
        probs = torch.softmax(srt, dim=-1)
        keep_sorted = (torch.cumsum(probs, dim=-1) - probs) < top_p
        keep = torch.empty_like(keep_sorted).scatter_(-1, order, keep_sorted)
        logits = logits.masked_fill(~keep, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)


class TransformerLM(torch.nn.Module):
    """GPT-style causal language model, on the default device.

    Positions: ``'learned'`` table (the default), ``'rope'`` rotary or
    parameter-free ``'sinusoidal'``; ``tie_embeddings=True`` shares the
    token-embedding matrix as the head.  ``forward(tokens)`` (B, S) ->
    logits (B, S, vocab) is the reference's ``apply``; ``decode_step`` and
    ``generate`` decode against a static KV cache.

    ``num_kv_heads < num_heads`` makes every block's attention grouped-query:
    the grouped flash kernels in ``forward`` and a KV cache of
    ``num_kv_heads`` heads in decoding.  ``comm`` makes it sequence-parallel:
    ``forward(tokens)`` takes this rank's block (B, S_local) of a sequence
    split over the ranks (HeAT's ``chunk``), and every block's attention runs
    on the ring; positions are global, this rank's offset plus the local
    index, from one Allgather of the ranks' lengths a forward that every
    block reuses, and
    ``max_len`` bounds the global length.  Decoding ignores ``comm``.
    ``num_experts`` gives each block its own ``MoE`` (``moe_top_k``,
    ``moe_capacity_factor``), sharded over ``comm``'s ranks where they
    divide it (decoding then raises: a rank holds only its experts);
    ``remat`` checkpoints each block.
    ``dropout`` follows torch's module mode (active after ``train()``,
    torch's default, off after ``eval()``) where the reference takes
    ``apply(train=...)``; decoding never drops.
    """

    def __init__(self, vocab_size: int, embed_dim: int = 256, num_heads: int = 8, depth: int = 4,
                 mlp_ratio: int = 4, max_len: int = 1024, comm=None, remat: bool = False, num_experts: int = None,
                 moe_top_k: int = 2, moe_capacity_factor: float = 1.5, positions: str = "learned",
                 tie_embeddings: bool = False, num_kv_heads: int = None, dropout: float = 0.0, device=None):
        super().__init__()
        if positions not in ("learned", "rope", "sinusoidal"):
            raise ValueError(f"positions must be 'learned', 'rope' or 'sinusoidal', got {positions!r}")
        if positions == "sinusoidal" and embed_dim % 2:
            raise ValueError("sinusoidal positions require an even embed_dim")
        self.vocab_size = vocab_size
        self.embed_dim = embed_dim
        self.max_len = max_len
        self.positions = positions
        self.tie_embeddings = tie_embeddings
        self.comm = comm  # the sequence-parallel ring's communicator, or None
        scale = 1.0 / math.sqrt(embed_dim)
        self.embed = Embedding(vocab_size, embed_dim, device=device)
        with torch.no_grad():
            self.embed.weight.mul_(scale)
        if positions == "learned":
            self.pos = torch.nn.Parameter(scale * torch.randn((max_len, embed_dim), device=_device(device)))
        self.blocks = torch.nn.ModuleList(
            _TransformerBlock(embed_dim, num_heads, mlp_ratio, causal=True, comm=comm, rope=positions == "rope",
                              num_kv_heads=num_kv_heads, dropout=dropout, remat=remat, device=device,
                              ffn=_block_ffn(embed_dim, mlp_ratio, num_experts, moe_top_k, comm, moe_capacity_factor,
                                             device))
            for _ in range(depth))
        self.ln_f = LayerNorm(embed_dim, device=device)
        if not tie_embeddings:
            self.head = Linear(embed_dim, vocab_size, bias=False, device=device)

    def _logits(self, h: torch.Tensor) -> torch.Tensor:
        """The head, or the transposed token embedding when tied."""
        if self.tie_embeddings:
            return h @ self.embed.weight.T
        return self.head(h)

    def _positions(self, h: torch.Tensor, positions) -> torch.Tensor:
        if self.positions == "learned":
            return h + self.pos[positions]
        if self.positions == "sinusoidal":
            return h + _sinusoidal_positions(positions, self.embed_dim, h.device).to(h.dtype)
        return h  # rope rotates q/k inside the attention

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """Teacher-forced forward: tokens (B, S) int -> logits (B, S, vocab);
        with ``comm``, this rank's blocks of both."""
        S, offset, lengths = tokens.shape[1], 0, None
        if self.comm is not None and self.comm.size > 1:
            lengths = sequence_lengths(self.comm, S, S)  # once: every block's attention reuses them
            offset = sum(n for n, _ in lengths[: self.comm.rank])
            S = sum(n for n, _ in lengths)
        if S > self.max_len:
            raise ValueError(f"sequence length {S} exceeds max_len {self.max_len}")
        h = self._positions(self.embed(tokens), torch.arange(offset, offset + tokens.shape[1], device=tokens.device))
        for block in self.blocks:
            h = block(h, lengths)
        return self._logits(self.ln_f(h))

    def init_caches(self, batch: int, max_len: int, dtype=None) -> list:
        """One static KV cache per block, in the model's dtype by default."""
        dtype = self.embed.weight.dtype if dtype is None else dtype
        return [block.mha.init_cache(batch, max_len, dtype) for block in self.blocks]

    def decode_step(self, tok: torch.Tensor, pos: int, caches: list):
        """Logits (B, vocab) for tokens ``tok`` (B,) at position ``pos``, and
        the caches (updated in place).  Under ``'rope'`` the rotation
        position is the caches' index; feed positions 0, 1, 2, ... from fresh
        caches, as ``generate`` does."""
        h = self._positions(self.embed(tok[:, None]), pos)
        for block, cache in zip(self.blocks, caches):
            h, _ = block.decode_step(h, cache)
        return self._logits(self.ln_f(h))[:, 0, :], caches

    @torch.no_grad()
    def generate(self, prompt: torch.Tensor, max_new_tokens: int, *, temperature: float = 0.0, top_k: int = None,
                 top_p: float = None, eos_id: int = None, generator: torch.Generator = None) -> torch.Tensor:
        """Autoregressive continuation of ``prompt`` (B, S0) int tokens:
        (B, S0 + max_new_tokens) int32, beginning with the prompt.

        ``temperature=0`` decodes greedily; otherwise softmax sampling at that
        temperature from ``generator`` (a ``torch.Generator`` on the model's
        device; the reference takes a ``jax.random`` key), optionally
        truncated to ``top_k`` tokens and/or the ``top_p`` nucleus.
        ``eos_id`` pins a sequence to EOS once it emits it (EOS in the
        prompt never stops a sequence).  The prompt goes through the same
        cached step as generation."""
        sampled = bool(temperature)
        if sampled and generator is None:
            raise ValueError("sampling (temperature > 0) requires generator=")
        B, S0 = prompt.shape
        n_new = int(max_new_tokens)
        total = S0 + n_new
        if total > self.max_len:
            raise ValueError(f"prompt + max_new_tokens = {total} exceeds max_len {self.max_len}")
        top_k, top_p = _normalize_truncation(top_k, top_p, self.vocab_size, sampled)
        if eos_id is not None and not 0 <= int(eos_id) < self.vocab_size:
            raise ValueError(f"eos_id {eos_id} outside vocab [0, {self.vocab_size})")
        dev = self.embed.weight.device
        ys = torch.zeros((B, total), dtype=torch.int32, device=dev)
        ys[:, :S0] = prompt.to(device=dev, dtype=torch.int32)
        caches = self.init_caches(B, total)
        done = torch.zeros(B, dtype=torch.bool, device=dev)
        for t in range(total - 1):
            logits, caches = self.decode_step(ys[:, t], t, caches)
            if t + 1 < S0:
                continue  # prompt positions keep their given token
            nxt = _next_token(logits, sampled, temperature, generator, top_k, top_p)
            if eos_id is not None:
                nxt = torch.where(done, torch.full_like(nxt, int(eos_id)), nxt)
                done |= nxt == int(eos_id)
            ys[:, t + 1] = nxt
        return ys


class Seq2SeqTransformer(torch.nn.Module):
    """Encoder-decoder transformer (torch's ``nn.Transformer`` shape), on
    the default device: source embedding + learned positions +
    bidirectional encoder; target embedding + the same positions + causal
    decoder with cross-attention; final LayerNorm; LM head without bias.

    ``forward(src, tgt)`` is the reference's teacher-forced ``apply``:
    token ids (B, S_src), (B, S_tgt) -> logits (B, S_tgt, tgt_vocab).  With
    ``comm`` both are this rank's blocks of the sequences and every
    attention rides the ring; the ranks' lengths are gathered once a
    forward and positions are global.  ``num_experts`` gives each block of
    both stacks its own ``MoE``; ``remat`` checkpoints each block;
    ``dropout`` follows torch's module mode, and decoding never drops.
    ``generate`` and ``beam_search`` take the whole source on one rank
    (``comm`` over more than one rank raises there)."""

    def __init__(self, src_vocab: int, tgt_vocab: int, embed_dim: int = 256, num_heads: int = 8,
                 enc_depth: int = 4, dec_depth: int = 4, mlp_ratio: int = 4, max_len: int = 1024, comm=None,
                 remat: bool = False, num_experts: int = None, moe_top_k: int = 2, moe_capacity_factor: float = 1.5,
                 dropout: float = 0.0, device=None):
        super().__init__()
        self.src_vocab, self.tgt_vocab = src_vocab, tgt_vocab
        self.embed_dim, self.max_len, self.comm = embed_dim, max_len, comm
        scale = 1.0 / math.sqrt(embed_dim)
        self.src_embed = Embedding(src_vocab, embed_dim, device=device)
        self.tgt_embed = Embedding(tgt_vocab, embed_dim, device=device)
        with torch.no_grad():
            self.src_embed.weight.mul_(scale)
            self.tgt_embed.weight.mul_(scale)
        self.pos = torch.nn.Parameter(scale * torch.randn((max_len, embed_dim), device=_device(device)))
        ffn = lambda: _block_ffn(embed_dim, mlp_ratio, num_experts, moe_top_k, comm,  # noqa: E731
                                 moe_capacity_factor, device)
        self.encoder = torch.nn.ModuleList(
            _TransformerBlock(embed_dim, num_heads, mlp_ratio, causal=False, comm=comm, dropout=dropout, remat=remat,
                              ffn=ffn(), device=device) for _ in range(enc_depth))
        self.decoder = torch.nn.ModuleList(
            _TransformerDecoderBlock(embed_dim, num_heads, mlp_ratio, comm, remat=remat, ffn=ffn(), dropout=dropout,
                                     device=device) for _ in range(dec_depth))
        self.ln_f = LayerNorm(embed_dim, device=device)
        self.head = Linear(embed_dim, tgt_vocab, bias=False, device=device)

    def _embed(self, table: Embedding, tokens: torch.Tensor, offset: int, total: int, what: str) -> torch.Tensor:
        if total > self.max_len:
            raise ValueError(f"{what} length {total} exceeds max_len {self.max_len}")
        return table(tokens) + self.pos[offset: offset + tokens.shape[1]]

    def _split(self, n_tgt: int, n_src: int):
        """(cross lengths, target pairs, source pairs, target offset, source
        offset, target total, source total) of this forward."""
        cross, tgt, src = _lengths(self.comm, n_tgt, n_src)
        if cross is None:
            return None, None, None, 0, 0, n_tgt, n_src
        r = self.comm.rank
        return (cross, tgt, src, sum(q for q, _ in cross[:r]), sum(k for _, k in cross[:r]),
                sum(q for q, _ in cross), sum(k for _, k in cross))

    def encode(self, src: torch.Tensor, lengths=None, offset: int = 0, total: int = None) -> torch.Tensor:
        """src (B, S_src) int -> memory (B, S_src, E); under ``comm`` this
        rank's block (``lengths``, ``offset``, ``total``: the ranks' source
        pairs, this rank's offset and the global length, gathered here when
        not given)."""
        if lengths is None and self.comm is not None and self.comm.size > 1:
            _, _, lengths, _, offset, _, total = self._split(src.shape[1], src.shape[1])
        h = self._embed(self.src_embed, src, offset, src.shape[1] if total is None else total, "source")
        for block in self.encoder:
            h = block(h, lengths)
        return h

    def forward(self, src: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
        cross, own, src_pairs, t_off, s_off, t_total, s_total = self._split(tgt.shape[1], src.shape[1])
        memory = self.encode(src, src_pairs, s_off, s_total)
        h = self._embed(self.tgt_embed, tgt, t_off, t_total, "target")
        for block in self.decoder:
            h = block(h, memory, own, cross)
        return self.head(self.ln_f(h))

    def decode_step(self, tok: torch.Tensor, pos: int, states: list):
        """Logits (B, tgt_vocab) for target tokens ``tok`` (B,) at position
        ``pos``, and the states (self-attention caches updated in place)."""
        h = self.tgt_embed(tok[:, None]) + self.pos[pos]
        states = list(states)
        for i, block in enumerate(self.decoder):
            h, states[i] = block.decode_step(h, states[i])
        return self.head(self.ln_f(h))[:, 0, :], states

    def _decode_init(self, src: torch.Tensor, total: int, beams: int = 1) -> list:
        """Each decoder block's state for ``src``: the encoder runs once (in
        evaluation), each block projects the memory's K/V once, repeated
        beam-major for ``beams > 1``; the self caches hold B·beams rows."""
        if self.comm is not None and self.comm.size > 1:
            raise ValueError("generate and beam_search take the whole source on one rank: build the model "
                             "without comm (or over one rank) to decode")
        if total > self.max_len:
            raise ValueError(f"1 + max_new_tokens = {total} exceeds max_len {self.max_len}")
        was = self.training
        self.eval()
        try:
            memory = self.encode(src.to(self.pos.device))
        finally:
            self.train(was)
        states = []
        for block in self.decoder:
            st = block.decode_state(memory, src.shape[0] * beams, total, self.pos.dtype)
            if beams > 1:
                st["mem_k"] = st["mem_k"].repeat_interleave(beams, dim=0)
                st["mem_v"] = st["mem_v"].repeat_interleave(beams, dim=0)
            states.append(st)
        return states

    def _check_eos(self, eos_id) -> None:
        if eos_id is not None and not 0 <= int(eos_id) < self.tgt_vocab:
            raise ValueError(f"eos_id {eos_id} outside vocab [0, {self.tgt_vocab})")

    @torch.no_grad()
    def generate(self, src: torch.Tensor, max_new_tokens: int, *, bos_id: int = 0, temperature: float = 0.0,
                 top_k: int = None, top_p: float = None, eos_id: int = None,
                 generator: torch.Generator = None) -> torch.Tensor:
        """A target sequence for ``src`` (B, S_src) from ``bos_id``: (B, 1 +
        max_new_tokens) int32 beginning with BOS.  ``temperature``,
        ``top_k``, ``top_p``, ``eos_id`` and ``generator`` as in
        ``TransformerLM.generate``."""
        sampled = bool(temperature)
        if sampled and generator is None:
            raise ValueError("sampling (temperature > 0) requires generator=")
        n_new = int(max_new_tokens)
        top_k, top_p = _normalize_truncation(top_k, top_p, self.tgt_vocab, sampled)
        self._check_eos(eos_id)
        states = self._decode_init(src, 1 + n_new)
        B, dev = src.shape[0], self.pos.device
        ys = torch.zeros((B, 1 + n_new), dtype=torch.int32, device=dev)
        ys[:, 0] = int(bos_id)
        done = torch.zeros(B, dtype=torch.bool, device=dev)
        for t in range(n_new):
            logits, states = self.decode_step(ys[:, t], t, states)
            nxt = _next_token(logits, sampled, temperature, generator, top_k, top_p)
            if eos_id is not None:
                nxt = torch.where(done, torch.full_like(nxt, int(eos_id)), nxt)
                done |= nxt == int(eos_id)
            ys[:, t + 1] = nxt
        return ys

    @torch.no_grad()
    def beam_search(self, src: torch.Tensor, max_new_tokens: int, *, beam_width: int = 4, bos_id: int = 0,
                    eos_id: int = None, length_penalty: float = 0.0) -> torch.Tensor:
        """The best of ``beam_width`` beams for each source: (B, 1 +
        max_new_tokens) int32 beginning with BOS.  A beam that emitted EOS
        re-emits EOS at log-probability 0 (its score frozen, its tail EOS)
        and keeps its length (the EOS counted); the final ranking is score /
        length ** ``length_penalty`` (raw scores without ``eos_id``, where
        every beam has one length).  ``beam_width=1`` is greedy decoding."""
        n_new, W = int(max_new_tokens), int(beam_width)
        if W < 1:
            raise ValueError(f"beam_width must be >= 1, got {W}")
        self._check_eos(eos_id)
        lp = float(length_penalty)
        if lp != 0.0 and eos_id is None:
            raise ValueError("length_penalty requires eos_id (fixed-length beams all share one length)")
        B, V, total = src.shape[0], self.tgt_vocab, 1 + n_new
        states = self._decode_init(src, total, beams=W)
        dev = self.pos.device
        ys = torch.zeros((B * W, total), dtype=torch.int32, device=dev)
        ys[:, 0] = int(bos_id)
        # only beam 0 is live at first, or the first expansion picks W copies of one token
        scores = torch.full((B, W), float("-inf"), device=dev)
        scores[:, 0] = 0.0
        done = torch.zeros((B, W), dtype=torch.bool, device=dev)
        lengths = torch.zeros((B, W), dtype=torch.int32, device=dev)
        if eos_id is not None:
            frozen = torch.full((V,), float("-inf"), device=dev)
            frozen[int(eos_id)] = 0.0
        for t in range(n_new):
            logits, states = self.decode_step(ys[:, t], t, states)
            logp = torch.log_softmax(logits.float(), dim=-1).reshape(B, W, V)
            if eos_id is not None:
                logp = torch.where(done[:, :, None], frozen, logp)
            top_s, top_i = (scores[:, :, None] + logp).reshape(B, W * V).topk(W, dim=-1)
            beam_of, tok = top_i // V, (top_i % V).to(torch.int32)
            gather = (torch.arange(B, device=dev)[:, None] * W + beam_of).reshape(-1)
            ys = ys[gather]
            ys[:, t + 1] = tok.reshape(-1)
            if eos_id is not None:
                done_g, len_g = done.gather(1, beam_of), lengths.gather(1, beam_of)
                lengths = torch.where(done_g, len_g, len_g + 1)
                done = done_g | (tok == int(eos_id))
            for st in states:
                st["self"]["k"] = st["self"]["k"][gather]
                st["self"]["v"] = st["self"]["v"][gather]
            scores = top_s
        if eos_id is not None:
            scores = scores / torch.clamp(lengths, min=1).float() ** lp
        best = scores.argmax(dim=1)
        return ys.reshape(B, W, total)[torch.arange(B, device=dev), best]
