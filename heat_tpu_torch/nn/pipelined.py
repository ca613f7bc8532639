"""Pipeline-parallel execution of a stack of one block (reference: ``heat_tpu/nn/pipelined.py``).

``Pipelined(block, depth, comm)`` runs ``depth`` independently initialized
copies of ``block`` as ``comm.size`` pipeline stages of ``depth // p``
blocks each (``parallel.pipeline_apply``); this rank holds only its
stage's blocks (``blocks``: copies of ``block`` whose parameters are drawn
again with each submodule's ``reset_parameters``), so depth scales with
the ranks.  The block maps (mb, ...) to the same shape.  ``forward(x)``
microbatches ``x`` along axis 0 (``n_microbatches``, default p, must
divide it); the result is the last stage's, on every rank.  ``remat=True``
checkpoints each block.  ``train=``/``key=`` keywords warn, as the
reference's ``apply`` does, and change nothing: stochastic layers follow
torch's module mode here.  ``comm=None`` (or one rank) runs the whole
stack in order.
"""

from __future__ import annotations

import copy
import warnings

import torch
from torch.utils.checkpoint import checkpoint

from ..parallel.pipeline import pipeline_apply

__all__ = ["Pipelined"]


def _fresh_copy(block: torch.nn.Module) -> torch.nn.Module:
    """A copy of ``block`` whose parameters are drawn again."""
    out = copy.deepcopy(block)
    for m in reversed(list(out.modules())):  # a parent's own rule last
        if hasattr(m, "reset_parameters"):
            m.reset_parameters()
    return out


class Pipelined(torch.nn.Module):
    """A ``depth``-deep stack of ``block``, pipeline-parallel over ``comm``
    (module docstring)."""

    def __init__(self, block: torch.nn.Module, depth: int, comm, n_microbatches: int = None, remat: bool = False,
                 batch_axis=None):
        super().__init__()
        p = comm.size if comm is not None else 1
        if depth % p:
            raise ValueError(f"depth {depth} not divisible by pipeline stages {p}")
        if batch_axis is not None:
            raise ValueError("batch_axis names a mesh axis of the JAX package; here dp x pp composes by giving "
                             "Pipelined the pipeline subgroup (comm.Split) and summing the gradients over the "
                             "data-parallel group (DataParallel, bucketed_grad_allreduce)")
        self.depth, self.comm, self.n_microbatches, self.remat = depth, comm, n_microbatches, remat
        self.blocks = torch.nn.ModuleList(_fresh_copy(block) for _ in range(depth // p))

    def _stage(self, blocks, h: torch.Tensor) -> torch.Tensor:
        for block in blocks:
            h = checkpoint(block, h, use_reentrant=False) if self.remat and torch.is_grad_enabled() else block(h)
        return h

    def forward(self, x: torch.Tensor, **kw) -> torch.Tensor:
        if kw.get("train") or kw.get("key") is not None:
            warnings.warn("Pipelined.apply ignores train=/key=: per-microbatch RNG is not threaded through the "
                          "pipeline schedule; stochastic layers (e.g. dropout) follow the module's train()/eval() "
                          "mode", stacklevel=2)
        if self.comm is None or self.comm.size == 1:
            return self._stage(self.blocks, x)
        return pipeline_apply(self._stage, self.blocks, x, self.comm, n_microbatches=self.n_microbatches)
