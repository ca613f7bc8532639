"""Transformer models (reference: ``heat_tpu/nn/models.py``).

``TransformerLM`` is the GPT-style causal language model of the reference:
token embedding + positions + pre-norm causal blocks + final LayerNorm +
LM head.  ``forward`` is the reference's teacher-forced ``apply`` and runs
the flash kernels in every block (forward, and dq and dk/dv under
``backward``).  ``generate`` decodes against a static KV cache: the
reference compiles the whole loop into one ``lax.scan``; here it is a
Python loop over a preallocated cache written in place, one
``decode_step`` per position, with no host round trip inside the loop.
"""

from __future__ import annotations

import math
import warnings

import torch

from .attention import MultiheadAttention
from .modules import GELU, Dropout, Embedding, LayerNorm, Linear, Sequential, _device

__all__ = ["transformer_encoder", "TransformerLM"]


def _ffn(embed_dim: int, mlp_ratio: int, device=None) -> Sequential:
    """THE transformer FFN: Linear, exact GELU, Linear."""
    return Sequential(Linear(embed_dim, mlp_ratio * embed_dim, device=device), GELU(),
                      Linear(mlp_ratio * embed_dim, embed_dim, device=device))


def _unported(num_experts, remat: bool) -> None:
    """The reference options this port does not have yet."""
    if num_experts:
        raise NotImplementedError("mixture-of-experts blocks (num_experts=) are not ported yet (ROADMAP A11)")
    if remat:
        warnings.warn("remat=True is ignored: activation checkpointing is not ported yet (ROADMAP A11); "
                      "every block keeps its activations for the backward", stacklevel=3)


class _TransformerBlock(torch.nn.Module):
    """Pre-norm transformer block: x + MHA(LN(x)), then x + FFN(LN(x))."""

    def __init__(self, embed_dim: int, num_heads: int, mlp_ratio: int = 4, causal: bool = False, comm=None,
                 rope: bool = False, num_kv_heads: int = None, dropout: float = 0.0, device=None):
        super().__init__()
        self.ln1 = LayerNorm(embed_dim, device=device)
        self.mha = MultiheadAttention(embed_dim, num_heads, comm=comm, rope=rope, num_kv_heads=num_kv_heads,
                                      device=device)
        self.ln2 = LayerNorm(embed_dim, device=device)
        self.ff = _ffn(embed_dim, mlp_ratio, device=device)
        self.drop = Dropout(dropout)  # torch TransformerEncoderLayer's residual-branch sites
        self.causal = causal

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x + self.drop(self.mha(self.ln1(x), causal=self.causal))
        return h + self.drop(self.ff(self.ln2(h)))

    def decode_step(self, x: torch.Tensor, cache: dict):
        """One-token block step against the KV cache: the last row of
        :meth:`forward` over the prefix (causal)."""
        a, cache = self.mha.decode_step(self.ln1(x), cache)
        h = x + a
        return h + self.ff(self.ln2(h)), cache


def transformer_encoder(embed_dim: int = 256, num_heads: int = 8, depth: int = 4, mlp_ratio: int = 4,
                        causal: bool = False, comm=None, remat: bool = False, num_experts: int = None,
                        dropout: float = 0.0, device=None) -> Sequential:
    """A stack of pre-norm transformer blocks over (B, S, embed_dim) input,
    bidirectional by default (``causal=True`` for decoder-style masking).
    ``num_experts`` raises ``NotImplementedError`` (MoE, ROADMAP A11),
    ``comm`` too (the ring, ROADMAP B6); ``remat`` is ignored with a warning
    (activation checkpointing is not ported yet)."""
    _unported(num_experts, remat)
    return Sequential(*[_TransformerBlock(embed_dim, num_heads, mlp_ratio, causal, comm, dropout=dropout,
                                          device=device) for _ in range(depth)])


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

    ``num_experts`` raises ``NotImplementedError`` (MoE, ROADMAP A11), as do
    ``num_kv_heads < num_heads`` (grouped-query, B5) and ``comm`` (the ring,
    B6).  ``remat`` is ignored, with a warning: activation checkpointing is
    not ported yet, so every block keeps its activations for the backward.
    ``dropout`` follows torch's module mode (active after ``train()``,
    torch's default, off after ``eval()``) where the reference takes
    ``apply(train=...)``; decoding never drops.
    """

    def __init__(self, vocab_size: int, embed_dim: int = 256, num_heads: int = 8, depth: int = 4,
                 mlp_ratio: int = 4, max_len: int = 1024, comm=None, remat: bool = False, num_experts: int = None,
                 positions: str = "learned", tie_embeddings: bool = False, num_kv_heads: int = None,
                 dropout: float = 0.0, device=None):
        super().__init__()
        if positions not in ("learned", "rope", "sinusoidal"):
            raise ValueError(f"positions must be 'learned', 'rope' or 'sinusoidal', got {positions!r}")
        if positions == "sinusoidal" and embed_dim % 2:
            raise ValueError("sinusoidal positions require an even embed_dim")
        _unported(num_experts, remat)
        self.vocab_size = vocab_size
        self.embed_dim = embed_dim
        self.max_len = max_len
        self.positions = positions
        self.tie_embeddings = tie_embeddings
        scale = 1.0 / math.sqrt(embed_dim)
        self.embed = Embedding(vocab_size, embed_dim, device=device)
        with torch.no_grad():
            self.embed.weight.mul_(scale)
        if positions == "learned":
            self.pos = torch.nn.Parameter(scale * torch.randn((max_len, embed_dim), device=_device(device)))
        self.blocks = torch.nn.ModuleList(
            _TransformerBlock(embed_dim, num_heads, mlp_ratio, causal=True, comm=comm, rope=positions == "rope",
                              num_kv_heads=num_kv_heads, dropout=dropout, device=device)
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
        """Teacher-forced forward: tokens (B, S) int -> logits (B, S, vocab)."""
        S = tokens.shape[1]
        if S > self.max_len:
            raise ValueError(f"sequence length {S} exceeds max_len {self.max_len}")
        h = self._positions(self.embed(tokens), torch.arange(S, device=tokens.device))
        for block in self.blocks:
            h = block(h)
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
