"""Mixture of experts with expert parallelism (reference: ``heat_tpu/nn/moe.py``).

Token-choice top-k routing, the reference's decisions exactly: the top
``top_k`` of each token's softmax gates, renormalized by their sum plus
1e-9; capacity slots claimed slot-major (every token's first choice before
any second choice, tokens in order within a slot); a zero-gate claim takes
no queue position; a claim past an expert's capacity ``max(1, ceil(top_k
· n / E · capacity_factor))`` is dropped and adds nothing for that expert.
The reference builds (n, E, C) one-hot dispatch and combine tensors and
contracts them; here each claim's slot index is computed (``_routing``),
the token rows are scattered into the (E, C, D) buffer (each slot holds at
most one token, so the buffer is exact) and the experts' rows gathered
back, weighted by the gates, into their tokens: the k terms of a token
are summed in another order than the reference's einsum.  Each expert is
D -> hidden -> D with the tanh GELU (``jax.nn.gelu``'s default, which the
reference's experts use; the dense FFN's GELU is the exact one).

With ``comm=`` over p ranks and ``num_experts % p == 0`` the experts are
sharded: this rank holds experts [r·E/p, (r + 1)·E/p) (``w1``, ``b1``,
``w2``, ``b2`` of E/p rows; ``router`` whole), routes ITS tokens (the
caller passes this rank's HeAT chunk of the flattened batch, as
``TransformerLM(comm=)`` passes its block of the sequence) at the capacity
of its own token count (the reference's per-shard guarantee), ships the
(E, C_r, D) buffer to the experts' owners with one ``Alltoall`` (split
along experts, concatenated along capacity), applies its local experts
and ships the results back with a second; both are autograd functions
whose backward is the reverse ``Alltoall``.  The reference pads the
tokens to a multiple of p and shards them evenly; HeAT's chunks are
ragged, so where p does not divide n and capacity binds, the drops differ
from the reference's.  An expert shard's gradient is complete on its
owner (every rank's tokens reach it through the backward ``Alltoall``):
sum it over a data-parallel group only, never over ``comm``
(``split_parameters``).  ``num_experts % p != 0`` warns and every rank
holds and runs all experts on its own tokens (the dense path).

``batch_axis`` names a mesh axis in the reference; here dp x ep composes
by giving ``MoE`` the expert-parallel subgroup (``comm.Split``) and
summing gradients over the data-parallel one (``DataParallel``,
``core.collectives.bucketed_grad_allreduce``), so ``batch_axis=`` raises.
``decode_apply`` is the drop-free per-token path decoding uses (it needs
every expert on this rank); ``load_balance_loss`` is the Switch loss E ·
Σ_e f_e · P_e.  Each forward keeps ``aux_loss`` (the Switch loss of the
tokens it routed, with its gradient) and ``route_stats`` (dropped and
valid claims, a device tensor read without a host sync until asked).
"""

from __future__ import annotations

import math
import warnings

import torch
import torch.nn.functional as F

from .modules import _device

__all__ = ["MoE", "split_parameters"]

_EXPERT_PARAMS = ("w1", "b1", "w2", "b2")


def _topk_gates(gates: torch.Tensor, top_k: int):
    """The top-k experts of each token and their gates renormalized by
    their sum (+1e-9): the one routing rule of the capacity and the decode
    paths."""
    val, idx = gates.topk(top_k, dim=-1)
    return val / (val.sum(dim=-1, keepdim=True) + 1e-9), idx


def _routing(gates: torch.Tensor, top_k: int, capacity: int):
    """Each claim (slot-major: all first choices, then all second choices,
    tokens in order) as (token, slot, weight, kept, valid): ``slot`` =
    expert · capacity + queue position, the spare slot E · capacity where
    the claim is dropped or has zero gate; ``weight`` is 0 there; ``valid``
    marks the claims of nonzero gate."""
    n, E = gates.shape
    val, idx = _topk_gates(gates, top_k)
    expert = idx.t().reshape(-1)  # (k n,)
    weight = val.t().reshape(-1)
    valid = weight > 0
    claims = F.one_hot(expert, E) * valid[:, None]
    pos = (torch.cumsum(claims, dim=0) - claims).gather(1, expert[:, None])[:, 0]  # claims strictly before
    kept = valid & (pos < capacity)
    slot = torch.where(kept, expert * capacity + pos, torch.full_like(pos, E * capacity))
    token = torch.arange(n, device=gates.device).repeat(top_k)
    return token, slot, torch.where(kept, weight, torch.zeros_like(weight)), kept, valid


class _Alltoall(torch.autograd.Function):
    """``comm.Alltoall``; the gradient goes back by the reverse Alltoall."""

    @staticmethod
    def forward(ctx, x, comm, split_axis: int, concat_axis: int, send_counts, recv_counts):
        ctx.comm, ctx.axes, ctx.counts = comm, (split_axis, concat_axis), (send_counts, recv_counts)
        return comm.Alltoall(x.contiguous(), split_axis, concat_axis, send_counts=send_counts,
                             recv_counts=recv_counts)

    @staticmethod
    def backward(ctx, g):
        (split_axis, concat_axis), (send, recv) = ctx.axes, ctx.counts
        return (ctx.comm.Alltoall(g.contiguous(), concat_axis, split_axis, send_counts=recv, recv_counts=send),
                None, None, None, None, None)


class MoE(torch.nn.Module):
    """Token-choice top-k mixture of GELU FFN experts (module docstring).

    ``forward(x)`` with x (..., D) (this rank's tokens under ``comm``).
    Parameters: ``router`` (D, E), ``w1`` (E_local, D, hidden), ``b1``
    (E_local, hidden), ``w2`` (E_local, hidden, D), ``b2`` (E_local, D), the
    reference's names and initialization (router and w1 uniform in
    ±1/sqrt(D), w2 in ±1/sqrt(hidden), biases 0), drawn for all E experts
    and cut to this rank's, so that one seed gives one model at any world
    size."""

    def __init__(self, embed_dim: int, num_experts: int, hidden_dim: int = None, top_k: int = 2,
                 capacity_factor: float = 1.5, comm=None, batch_axis=None, device=None, dtype=None):
        super().__init__()
        if top_k < 1 or top_k > num_experts:
            raise ValueError(f"top_k {top_k} must be in [1, num_experts={num_experts}]")
        if batch_axis is not None:
            raise ValueError("batch_axis names a mesh axis of the JAX package; here dp x ep composes by giving MoE "
                             "the expert-parallel subgroup (comm.Split) and summing the gradients over the "
                             "data-parallel group (DataParallel, bucketed_grad_allreduce)")
        self.embed_dim, self.num_experts = embed_dim, num_experts
        self.hidden_dim = hidden_dim or 4 * embed_dim
        self.top_k, self.capacity_factor, self.comm = top_k, capacity_factor, comm
        p = comm.size if comm is not None else 1
        self.sharded = p > 1 and num_experts % p == 0
        self.local_experts = num_experts // p if self.sharded else num_experts
        self.expert_offset = comm.rank * self.local_experts if self.sharded else 0
        dev = _device(device)
        D, H, E = embed_dim, self.hidden_dim, num_experts
        self.router = torch.nn.Parameter(torch.empty((D, E), device=dev, dtype=dtype))
        self.w1 = torch.nn.Parameter(torch.empty((self.local_experts, D, H), device=dev, dtype=dtype))
        self.b1 = torch.nn.Parameter(torch.zeros((self.local_experts, H), device=dev, dtype=dtype))
        self.w2 = torch.nn.Parameter(torch.empty((self.local_experts, H, D), device=dev, dtype=dtype))
        self.b2 = torch.nn.Parameter(torch.zeros((self.local_experts, D), device=dev, dtype=dtype))
        self.aux_loss = None
        self.route_stats = None
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self) -> None:
        D, H, E = self.embed_dim, self.hidden_dim, self.num_experts
        own = slice(self.expert_offset, self.expert_offset + self.local_experts)
        b1, b2 = 1.0 / math.sqrt(D), 1.0 / math.sqrt(H)
        self.router.uniform_(-b1, b1)
        self.w1.copy_(torch.empty((E, D, H), device=self.w1.device, dtype=self.w1.dtype).uniform_(-b1, b1)[own])
        self.w2.copy_(torch.empty((E, H, D), device=self.w2.device, dtype=self.w2.dtype).uniform_(-b2, b2)[own])
        self.b1.zero_()
        self.b2.zero_()

    def _capacity(self, n_tokens: int) -> int:
        return max(1, math.ceil(self.top_k * n_tokens / self.num_experts * self.capacity_factor))

    def _experts(self, buf: torch.Tensor) -> torch.Tensor:
        """The local experts on their (E_local, C, D) rows."""
        h = F.gelu(torch.baddbmm(self.b1[:, None, :], buf, self.w1), approximate="tanh")
        return torch.baddbmm(self.b2[:, None, :], h, self.w2)

    def _gates(self, x2d: torch.Tensor) -> torch.Tensor:
        return torch.softmax(x2d @ self.router, dim=-1)

    def _keep_stats(self, gates: torch.Tensor, kept: torch.Tensor, valid: torch.Tensor) -> None:
        self.aux_loss = self._balance(gates)
        with torch.no_grad():
            self.route_stats = torch.stack([valid.sum() - kept.sum(), valid.sum()])

    def _balance(self, gates: torch.Tensor) -> torch.Tensor:
        E = self.num_experts
        f = F.one_hot(gates.argmax(dim=-1), E).to(gates.dtype).mean(dim=0)
        return E * (f * gates.mean(dim=0)).sum()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        D = self.embed_dim
        x2d = x.reshape(-1, D)
        n, E = x2d.shape[0], self.num_experts
        gates = self._gates(x2d)
        cap = self._capacity(n)
        token, slot, weight, kept, valid = _routing(gates, self.top_k, cap)
        self._keep_stats(gates, kept, valid)
        # the spare row E·cap takes the dropped claims' rows; it is never read back
        buf = x2d.new_zeros((E * cap + 1, D)).index_add(0, slot, x2d.index_select(0, token))[: E * cap]
        buf = buf.view(E, cap, D)
        if self.sharded:
            out = self._shipped(buf, cap)
        else:
            if self.comm is not None and self.comm.size > 1:
                warnings.warn(
                    f"MoE: num_experts={E} not divisible by mesh size {self.comm.size}; running the dense "
                    "(replicated-expert) path. This changes ROUTING NUMERICS, not just speed: capacity is budgeted "
                    "over this rank's tokens with every expert replicated, so drop decisions (and therefore "
                    "outputs) can differ from the expert-parallel path for the same config", stacklevel=2)
            out = self._experts(buf)
        rows = torch.cat([out.reshape(E * cap, D), out.new_zeros((1, D))])
        y = x2d.new_zeros((n, D)).index_add(0, token, rows.index_select(0, slot) * weight[:, None].to(rows.dtype))
        return y.reshape(x.shape)

    def _shipped(self, buf: torch.Tensor, cap: int) -> torch.Tensor:
        """The (E, C_r, D) buffer through the experts' owners and back."""
        comm, p, e = self.comm, self.comm.size, self.local_experts
        mine = torch.tensor([cap], dtype=torch.int64, device=comm._scratch_device())
        caps = [int(c) for c in torch.cat(comm.Allgather(mine)).tolist()]
        owned = _Alltoall.apply(buf, comm, 0, 1, [e] * p, caps)  # (E/p, Σ C_s, D)
        return _Alltoall.apply(self._experts(owned), comm, 1, 0, caps, [e] * p)

    def decode_apply(self, x: torch.Tensor) -> torch.Tensor:
        """Drop-free per-token path: each token through its top-k experts'
        gathered weights, no capacity buffer; equals ``forward`` wherever
        forward's capacity did not bind."""
        if self.local_experts != self.num_experts:
            raise ValueError("decode_apply needs every expert on this rank; the experts are sharded over comm")
        x2d = x.reshape(-1, self.embed_dim)
        val, idx = _topk_gates(self._gates(x2d), self.top_k)
        h = F.gelu(torch.einsum("nd,nkdh->nkh", x2d, self.w1[idx]) + self.b1[idx], approximate="tanh")
        y = torch.einsum("nkh,nkhd->nkd", h, self.w2[idx]) + self.b2[idx]
        return torch.einsum("nk,nkd->nd", val, y).reshape(x.shape)

    def load_balance_loss(self, x: torch.Tensor) -> torch.Tensor:
        """Switch's auxiliary loss E · Σ_e f_e · P_e over the tokens of x: f_e
        the share whose top choice is e, P_e the mean gate; 1 for a uniform
        router.  Add ``coef · load_balance_loss`` to the training loss."""
        return self._balance(self._gates(x.reshape(-1, self.embed_dim)))


def split_parameters(module: torch.nn.Module):
    """(replicated, expert shards) of ``module``'s parameters: the expert
    shards of its sharded ``MoE`` layers are complete on this rank and are
    summed over a data-parallel group only; the rest are summed over every
    rank that computed with them."""
    shards = {id(getattr(m, name)) for m in module.modules() if isinstance(m, MoE) and m.sharded
              for name in _EXPERT_PARAMS}
    params = list(module.parameters())
    return [p for p in params if id(p) not in shards], [p for p in params if id(p) in shards]
