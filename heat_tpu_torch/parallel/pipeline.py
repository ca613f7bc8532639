"""Pipeline parallelism: a GPipe microbatch schedule over the ranks (reference: ``heat_tpu/parallel/pipeline.py``).

``pipeline_apply(stage_fn, stage_params, x, comm, n_microbatches)`` keeps
the reference's semantics: ``x`` (N, ...) is global and the same on every
rank, cut into M equal microbatches along axis 0 (M = p by default, and M
must divide N); stage r computes ``stage_fn(stage_params, mb)`` for each
microbatch; the result, the last stage's output shaped like ``x``, is the
same on every rank.  One stage needs no communication.

The reference runs one compiled ``lax.scan`` of M + p - 1 ticks with
``ppermute`` shifts and gets the backward schedule from autodiff.  Here
each rank runs its own stage's loop: stage r receives microbatch m's
activation from stage r - 1 (``Sendrecv``), computes it and sends the
result to stage r + 1, so the stages overlap as the ticks do; the last
stage's buffer is then broadcast (the reference's masked ``psum``).
torch's autograd does not cross a send, so the receive, the send and the
broadcast are ``torch.autograd.Function``s whose backward runs the reverse
shifts: ``loss.backward()`` on every rank gives each stage the gradient of
its own parameters.  The broadcast's backward takes the mean of the
ranks' output gradients (each rank holds the same loss of the same
output, so its gradient is that loss's).  The backward runs microbatches
in the reverse order on every stage (autograd takes the most recent
ready node first), so every link's sends and receives pair up in order.
``stage_params`` is passed to ``stage_fn`` as it is: this rank's stage
(the reference stacks every stage's parameters on a leading axis sharded
over the mesh).  ``batch_axis`` names a mesh axis in the reference; here
dp x pp composes by giving the pipeline the pipeline subgroup
(``comm.Split``) and summing the gradients over the data-parallel one, so
``batch_axis=`` raises.  Under gloo a CUDA activation is staged through
host memory (``Communication.Send``); under NCCL it goes as it is.
"""

from __future__ import annotations

from typing import Callable

import torch

__all__ = ["pipeline_apply"]


class _RecvPrev(torch.autograd.Function):
    """Receive microbatch activation from the previous stage; the gradient
    goes back to it."""

    @staticmethod
    def forward(ctx, anchor, comm, shape, dtype):
        ctx.comm = comm
        return comm.Sendrecv(torch.empty((0,), dtype=dtype, device=anchor.device), None, comm.rank - 1, shape)

    @staticmethod
    def backward(ctx, g):
        ctx.comm.Sendrecv(g.contiguous(), ctx.comm.rank - 1, None)
        return None, None, None, None


class _SendNext(torch.autograd.Function):
    """Send an activation to the next stage; returns a 0-d token to join the
    graph, whose backward receives the activation's gradient from it."""

    @staticmethod
    def forward(ctx, y, comm):
        ctx.comm, ctx.shape = comm, tuple(y.shape)
        comm.Sendrecv(y.detach(), comm.rank + 1, None)
        return y.new_zeros(())  # y's dtype: the gradient received in backward has it

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.Sendrecv(g.new_empty((0,)), None, ctx.comm.rank + 1, ctx.shape), None


class _Broadcast(torch.autograd.Function):
    """The last stage's output to every rank; its gradient is the mean of
    the ranks' gradients, on the last stage."""

    @staticmethod
    def forward(ctx, out, token, comm):
        ctx.comm = comm
        return comm.Bcast(out.detach().clone(), root=comm.size - 1)

    @staticmethod
    def backward(ctx, g):
        comm = ctx.comm
        g = comm.Reduce(g.contiguous().clone(), root=comm.size - 1) / comm.size
        return g, torch.zeros((), device=g.device, dtype=g.dtype), None


def pipeline_apply(stage_fn: Callable, stage_params, x: torch.Tensor, comm, n_microbatches: int = None,
                   batch_axis=None) -> torch.Tensor:
    """The last of ``comm.size`` pipelined stages applied to ``x``, GPipe's
    schedule (module docstring); the same tensor on every rank."""
    if batch_axis is not None:
        raise ValueError("batch_axis names a mesh axis of the JAX package; here dp x pp composes by giving the "
                         "pipeline the pipeline subgroup (comm.Split) and summing the gradients over the "
                         "data-parallel group (DataParallel, bucketed_grad_allreduce)")
    p = comm.size if comm is not None else 1
    M = int(n_microbatches) if n_microbatches else p
    n = x.shape[0]
    if n % M:
        raise ValueError(f"leading dim {n} not divisible by n_microbatches={M}")
    if p == 1:
        return stage_fn(stage_params, x)
    rank, mb = comm.rank, n // M
    anchor = torch.zeros((), device=x.device, requires_grad=True)
    outs, tokens = [], []
    for m in range(M):
        if rank == 0:
            inp = x[m * mb:(m + 1) * mb]
        else:
            inp = _RecvPrev.apply(anchor, comm, (mb,) + tuple(x.shape[1:]), x.dtype)
        y = stage_fn(stage_params, inp)
        if tuple(y.shape) != (mb,) + tuple(x.shape[1:]):
            raise ValueError(f"a stage must map microbatches {(mb,) + tuple(x.shape[1:])} to the same shape, got "
                             f"{tuple(y.shape)}")
        if rank < p - 1:
            tokens.append(_SendNext.apply(y, comm))
        else:
            outs.append(y)
    out = torch.cat(outs) if outs else torch.zeros_like(x)
    token = torch.stack(tokens).sum() if tokens else anchor * 0.0
    return _Broadcast.apply(out, token, comm)
