"""The communicator (reference: ``heat/core/communication.py``), on ``torch.distributed``.

Each process holds one local tensor; a :class:`Communication` knows this
process's rank and the world size, does the shard math of the split axis,
and issues the collectives the estimators need.  World size 1 needs no
process group: every collective is then the identity.  The process group
is created by :func:`heat_tpu_torch.core.bootstrap.init_distributed`, with
gloo for CPU tensors and NCCL for CUDA tensors.  A group of gloo alone
(several processes on one card, where NCCL refuses to run) takes CUDA
tensors in its collectives but not in send/recv: ``Send`` stages them
through host memory.

Shard math follows HeAT, not the JAX package: ``chunk`` gives the first
``n % size`` ranks one extra row, and nothing is padded.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["Communication", "get_comm", "sanitize_comm"]

_OPS = {
    "sum": dist.ReduceOp.SUM,
    "prod": dist.ReduceOp.PRODUCT,
    "max": dist.ReduceOp.MAX,
    "min": dist.ReduceOp.MIN,
}


class Communication:
    """A communicator over the world process group when one is initialized,
    and over a world of one process otherwise."""

    @property
    def _active(self) -> bool:
        return dist.is_available() and dist.is_initialized()

    @property
    def size(self) -> int:
        """Number of processes (the reference's ``comm.size``)."""
        return dist.get_world_size() if self._active else 1

    @property
    def rank(self) -> int:
        """This process's rank in the group."""
        return dist.get_rank() if self._active else 0

    def is_distributed(self) -> bool:
        return self.size > 1

    def __repr__(self) -> str:
        return f"Communication(rank={self.rank}, size={self.size})"

    # ------------------------------------------------------------------ #
    # shard math (pure, no communication)
    # ------------------------------------------------------------------ #
    def chunk(
        self, shape, split: Optional[int], rank: Optional[int] = None
    ) -> Tuple[int, Tuple[int, ...], Tuple[slice, ...]]:
        """Offset, local shape and slices of ``rank``'s part of a global ``shape``.

        HeAT's rule: each rank gets ``n // size`` entries of the split axis and
        the first ``n % size`` ranks one more.
        """
        shape = tuple(int(s) for s in shape)
        if split is None:
            return 0, shape, tuple(slice(0, s) for s in shape)
        split = split % len(shape)
        rank = self.rank if rank is None else int(rank)
        n, p = shape[split], self.size
        c, rem = divmod(n, p)
        if rank < rem:
            c += 1
            start = rank * c
        else:
            start = rank * c + rem
        end = start + c
        lshape = shape[:split] + (c,) + shape[split + 1 :]
        slices = tuple(
            slice(start, end) if i == split else slice(0, s) for i, s in enumerate(shape)
        )
        return start, lshape, slices

    def counts_displs_shape(self, shape, split: int) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
        """Per-rank counts and displacements along ``split``."""
        counts, displs = [], []
        for r in range(self.size):
            off, lsh, _ = self.chunk(shape, split, r)
            counts.append(lsh[split])
            displs.append(off)
        return tuple(counts), tuple(displs)

    def lshape_map(self, shape, split: Optional[int]) -> np.ndarray:
        """(size, ndim) array of every rank's local shape."""
        out = np.empty((self.size, len(shape)), dtype=np.int64)
        for r in range(self.size):
            out[r] = self.chunk(shape, split, r)[1]
        return out

    # ------------------------------------------------------------------ #
    # collectives
    # ------------------------------------------------------------------ #
    def Allreduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """Reduce ``x`` over all ranks, in place; returns ``x``."""
        if op not in _OPS:
            raise ValueError(f"op must be one of {sorted(_OPS)}, got {op!r}")
        if self.is_distributed():
            dist.all_reduce(x, op=_OPS[op])
        return x

    def Bcast(self, x: torch.Tensor, root: int = 0) -> torch.Tensor:
        """Overwrite ``x`` with ``root``'s ``x``, in place; returns ``x``."""
        if self.is_distributed():
            dist.broadcast(x, src=root)
        return x

    def Allgather(self, x: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's ``x`` (all of the same shape), in rank order."""
        if not self.is_distributed():
            return [x]
        out = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(out, x.contiguous())
        return out

    def Send(self, x: torch.Tensor, shift: int = 1) -> torch.Tensor:
        """Ring shift (reference ``comm.Send``): every rank sends ``x`` to rank
        ``(rank + shift) % size`` and returns the tensor it receives from rank
        ``(rank - shift) % size``, of ``x``'s shape and dtype on ``x``'s
        device.  One ``batch_isend_irecv`` pair; the identity at world size 1.

        Under NCCL a CUDA tensor goes as it is.  gloo's send/recv read CPU
        buffers only (on an H100 a CUDA tensor's send fails with ``writev
        ... Bad address``, where gloo's collectives take one), so under gloo
        a CUDA tensor is staged through host memory: copied to the host,
        exchanged, copied back.  That is the transport, not a fallback: whatever
        computes on ``x`` still runs on the card (:meth:`transport` names
        the route)."""
        p = self.size
        if p == 1 or shift % p == 0:
            return x
        rank = self.rank
        staged = self._host_staged(x)
        buf = x.detach().contiguous()
        if staged:
            buf = buf.cpu()
        recv = torch.empty_like(buf)
        ops = [dist.P2POp(dist.isend, buf, (rank + shift) % p), dist.P2POp(dist.irecv, recv, (rank - shift) % p)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return recv.to(x.device) if staged else recv

    def transport(self, x: torch.Tensor) -> str:
        """How :meth:`Send` moves ``x``: ``'local'`` at world size 1,
        ``'gloo-host-staged'`` for a CUDA tensor under gloo, else the
        backend's name."""
        if not self.is_distributed():
            return "local"
        if self._host_staged(x):
            return "gloo-host-staged"
        return "nccl" if x.is_cuda else "gloo"

    def _host_staged(self, x: torch.Tensor) -> bool:
        """A CUDA tensor in a process group with no CUDA backend (gloo alone)."""
        return x.is_cuda and "nccl" not in str(dist.get_backend()).lower()

    def Allgatherv(self, x: torch.Tensor, axis: int = 0) -> torch.Tensor:
        """Every rank's ``x``, concatenated along ``axis`` in rank order.

        The ranks' extents along ``axis`` may differ; all other extents match.
        """
        if not self.is_distributed():
            return x
        axis = axis % x.ndim
        sizes = self.Allgather(torch.tensor([x.shape[axis]], dtype=torch.int64, device=x.device))
        sizes = [int(s.item()) for s in sizes]
        pad_shape = list(x.shape)
        pad_shape[axis] = max(sizes) - x.shape[axis]
        padded = torch.cat([x, x.new_zeros(pad_shape)], dim=axis) if pad_shape[axis] else x
        parts = self.Allgather(padded)
        return torch.cat([p.narrow(axis, 0, s) for p, s in zip(parts, sizes)], dim=axis)


_default_comm: Optional[Communication] = None


def get_comm() -> Communication:
    """The default communicator (the world group)."""
    global _default_comm
    if _default_comm is None:
        _default_comm = Communication()
    return _default_comm


def sanitize_comm(comm: Optional[Communication]) -> Communication:
    if comm is None:
        return get_comm()
    if isinstance(comm, Communication):
        return comm
    raise TypeError(f"Unknown communication, must be a Communication, got {type(comm)}")
