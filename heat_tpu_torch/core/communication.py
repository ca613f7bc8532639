"""The communicator (reference: ``heat/core/communication.py``), on ``torch.distributed``.

Each process holds one local tensor; a :class:`Communication` knows this
process's rank and the world size, does the shard math of the split axis,
and issues the collectives the estimators need.  World size 1 needs no
process group: every collective is then the identity.  The process group
is created by :func:`heat_tpu_torch.core.bootstrap.init_distributed`, with
gloo for CPU tensors and NCCL for CUDA tensors.  A group of gloo alone
(several processes on one card, where NCCL refuses to run) takes CUDA
tensors in its collectives but not in send/recv: ``Send``, ``Exscan`` and
``Scan`` (the point-to-point ones) stage them through host memory.

Shard math follows HeAT, not the JAX package: ``chunk`` gives the first
``n % size`` ranks one extra row, and nothing is padded.  Collectives that
take uneven pieces (``Alltoall``, ``ReduceScatter``, ``Gather``,
``Scatter``, ``Allgatherv``) carry them as they are or zero-pad them to the
largest piece on the wire; the caller never sees a pad.

Every collective passes through one accounting choke point
(:meth:`Communication._account_bytes`): calls and wire bytes per collective
name, the payload times the JAX package's traffic factor of that collective
(``traffic()``).  The runtime hooks ride the same point, as in the JAX
package: the flight recorder's sequence stamp, the ``comm.collective``
fault site (under the deadline watchdog when a :meth:`deadline` is armed),
the telemetry account (``comm.<name>.calls``/``.bytes``) and the
recorder's ``enter`` mark as the rank goes into the transport.  ``Wait`` and
``Barrier`` block under the same watchdog.

:meth:`Communication.Split` makes subgroup communicators (MPI's
``comm.Split(color, key)``) over ``torch.distributed.new_group``: every
rank of the world creates every group, in one order.  ``Iallreduce``,
``Ireduce_scatter`` and ``Iallgather`` return a request whose ``wait()``
gives the result; under NCCL the wait orders the current stream after the
collective without blocking the host.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["Communication", "get_comm", "sanitize_comm", "use_comm", "world"]

# The collectives that gloo refuses CUDA tensors for: its send and recv
# (``writev ... Bad address``).  Every other collective of the communicator
# took CUDA tensors under gloo on an H100 (torch 2.11: all_to_all_single,
# reduce_scatter, gather, scatter, reduce, barrier, all_reduce, broadcast,
# all_gather), so only the point-to-point ones are staged through the host.
_GLOO_HOST_STAGED = frozenset({"Send", "Exscan", "Scan"})

# flight-recorder hook (``utils.flightrec.enable()`` pokes the module in,
# ``disable()`` clears it): every collective is seq-stamped at the
# ``_account_bytes`` choke point.  Disabled cost: one module-global load.
# The module bottom re-arms against an env-armed recorder that loaded first.
_FLIGHTREC = None
_HEALTH_MOD = None
_TELEMETRY_MOD = None
_FAULTS_MOD = None


def _health():
    global _HEALTH_MOD
    if _HEALTH_MOD is None:
        from ..utils import health

        _HEALTH_MOD = health
    return _HEALTH_MOD


def _telemetry():
    global _TELEMETRY_MOD
    if _TELEMETRY_MOD is None:
        from ..utils import telemetry

        _TELEMETRY_MOD = telemetry
    return _TELEMETRY_MOD


def _faults():
    global _FAULTS_MOD
    if _FAULTS_MOD is None:
        from ..utils import faults

        _FAULTS_MOD = faults
    return _FAULTS_MOD


_OPS = {
    "sum": dist.ReduceOp.SUM,
    "prod": dist.ReduceOp.PRODUCT,
    "max": dist.ReduceOp.MAX,
    "min": dist.ReduceOp.MIN,
}


class Communication:
    """A communicator over the world process group when one is initialized,
    and over a world of one process otherwise; or, made by :meth:`Split`,
    over a subgroup (``group``) of the world's ranks ``ranks``, in their
    order."""

    def __init__(self, group=None, ranks: Optional[Sequence[int]] = None):
        self._traffic: Dict[str, Dict[str, int]] = {}
        self.group = group
        self._ranks = None if ranks is None else tuple(int(r) for r in ranks)
        self._splits: Dict = {}  # (color, key) of every rank -> the communicator Split made

    @property
    def _active(self) -> bool:
        return dist.is_available() and dist.is_initialized()

    @property
    def size(self) -> int:
        """Number of processes (the reference's ``comm.size``)."""
        if self._ranks is not None:
            return len(self._ranks)
        return dist.get_world_size() if self._active else 1

    @property
    def rank(self) -> int:
        """This process's rank in the group."""
        if self._ranks is not None:
            return self._ranks.index(dist.get_rank()) if self._active else 0
        return dist.get_rank() if self._active else 0

    @property
    def ranks(self) -> Tuple[int, ...]:
        """The world ranks of this communicator's processes, in its rank order."""
        return self._ranks if self._ranks is not None else tuple(range(self.size))

    def _world_rank(self, rank: int) -> int:
        """The world rank of this communicator's ``rank`` (a collective's root or peer)."""
        return self.ranks[rank]

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
    # accounting: the one choke point of every collective
    # ------------------------------------------------------------------ #
    def _account(self, name: str, x: torch.Tensor, factor: float) -> None:
        """Count one collective that runs: ``calls`` += 1 and ``bytes`` +=
        this rank's payload times ``factor``, the collective's wire cost in
        payload units as the JAX package counts it (``_account``/
        ``_account_bytes`` there): Allreduce and Bcast 2(p-1)/p, Allgather
        and Gather p-1, Alltoall and ReduceScatter (p-1)/p, Send 1, Exscan
        ceil(log2 p)+1, Scan ceil(log2 p).  Reduce and Scatter, which the JAX
        package builds from Allreduce and Bcast, take those factors under
        their own names.  At world size 1 every collective is the identity
        and nothing is counted."""
        self._account_bytes(name, int(round(x.numel() * x.element_size() * factor)), x=x)

    def _account_bytes(self, name: str, nbytes: int, x=None, src_split: Optional[int] = None,
                       dst_split: Optional[int] = None) -> None:
        """Count one call of ``name`` moving ``nbytes`` wire bytes (the
        bucketed sync and the tiled resplit account their stages here,
        telescoped), with the JAX package's hooks in its order: the flight
        recorder's stamp FIRST (a hang at the fault site then leaves the
        collective it hung on as the rank's last record), then the
        ``comm.collective`` fault site (under ``health.guard_blocking``
        when a deadline is armed, which refuses a blown deadline and turns
        an injected hang into ``CollectiveTimeoutError``), then the
        telemetry account, and last the recorder's ``enter`` mark: past the
        staging point, the rank goes into the transport.  These collectives
        block until every rank joins, so a rank wedged at staging stops its
        peers at the same seq, and only the marks tell the post-mortem
        which rank the others wait on."""
        entry = self._traffic.setdefault(name, {"calls": 0, "bytes": 0})
        entry["calls"] += 1
        entry["bytes"] += int(nbytes)
        rec = _FLIGHTREC
        seq = rec.record_collective(name, nbytes, x, src_split, dst_split) if rec is not None else None
        flt, hlth = _faults(), _health()
        if hlth.active_deadline() is None:
            flt.fire("comm.collective")
        else:
            hlth.guard_blocking(lambda: flt.fire("comm.collective"), f"comm.{name}")
        _telemetry().account_collective(name, nbytes)
        if seq is not None:
            rec.record_enter(seq)

    def traffic(self) -> Dict[str, Dict[str, int]]:
        """``{collective: {"calls": n, "bytes": wire bytes}}`` of this
        communicator since the last :meth:`reset_traffic`, counted by
        :meth:`_account`.  The telemetry store's ``comm.*`` counters hold
        the process's totals over every communicator, never reset, in the
        format the rank files export."""
        return {name: dict(entry) for name, entry in self._traffic.items()}

    def reset_traffic(self) -> None:
        self._traffic.clear()

    # ------------------------------------------------------------------ #
    # collectives
    # ------------------------------------------------------------------ #
    def Allreduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """Reduce ``x`` over all ranks, in place; returns ``x``."""
        if op not in _OPS:
            raise ValueError(f"op must be one of {sorted(_OPS)}, got {op!r}")
        if self.is_distributed():
            p = self.size
            self._account("Allreduce", x, 2.0 * (p - 1) / p)
            dist.all_reduce(x, op=_OPS[op], group=self.group)
        return x

    def Bcast(self, x: torch.Tensor, root: int = 0) -> torch.Tensor:
        """Overwrite ``x`` with ``root``'s ``x``, in place; returns ``x``."""
        if self.is_distributed():
            p = self.size
            self._account("Bcast", x, 2.0 * (p - 1) / p)
            dist.broadcast(x, src=self._world_rank(root), group=self.group)
        return x

    def Reduce(self, x: torch.Tensor, root: int = 0, op: str = "sum") -> torch.Tensor:
        """``x`` reduced over all ranks on ``root`` (in place there); every
        other rank receives zeros, as in the JAX package, and keeps its ``x``."""
        if op not in _OPS:
            raise ValueError(f"op must be one of {sorted(_OPS)}, got {op!r}")
        if not self.is_distributed():
            return x
        p = self.size
        self._account("Reduce", x, 2.0 * (p - 1) / p)
        buf = x if self.rank == root else x.clone()
        dist.reduce(buf, dst=self._world_rank(root), op=_OPS[op], group=self.group)
        return x if self.rank == root else torch.zeros_like(x)

    def Allgather(self, x: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's ``x`` (all of the same shape), in rank order."""
        if not self.is_distributed():
            return [x]
        self._account("Allgather", x, self.size - 1)
        out = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(out, x.contiguous(), group=self.group)
        return out

    def Allgatherv(self, x: torch.Tensor, axis: int = 0, counts: Optional[Sequence[int]] = None) -> torch.Tensor:
        """Every rank's ``x``, concatenated along ``axis`` in rank order.

        The ranks' extents along ``axis`` may differ (``counts``: each rank's,
        gathered when not given); all other extents match.  Each piece goes
        zero-padded to the largest."""
        if not self.is_distributed():
            return x
        axis = axis % x.ndim
        if counts is None:
            counts = self._extents(x, axis)
        pad_shape = list(x.shape)
        pad_shape[axis] = max(counts) - x.shape[axis]
        padded = torch.cat([x, x.new_zeros(pad_shape)], dim=axis) if pad_shape[axis] else x
        parts = self.Allgather(padded)
        return torch.cat([p.narrow(axis, 0, c) for p, c in zip(parts, counts)], dim=axis)

    def _extents(self, x: torch.Tensor, axis: int) -> List[int]:
        """Every rank's extent of ``x`` along ``axis`` (one Allgather)."""
        sizes = self.Allgather(torch.tensor([x.shape[axis]], dtype=torch.int64, device=x.device))
        return [int(s) for s in torch.cat(sizes).tolist()]

    def Alltoall(
        self,
        x: torch.Tensor,
        split_axis: int,
        concat_axis: int,
        send_counts: Optional[Sequence[int]] = None,
        recv_counts: Optional[Sequence[int]] = None,
    ) -> torch.Tensor:
        """Cut ``x`` along ``split_axis`` into one piece a rank (HeAT's chunks
        of its extent, or ``send_counts``), send piece ``r`` to rank ``r``, and
        concatenate what arrives along ``concat_axis`` in rank order (the JAX
        package's tiled ``all_to_all``).  Every rank cuts by the same counts;
        the ranks' extents along ``concat_axis`` may differ (``recv_counts``:
        each rank's, gathered when not given).  One ``all_to_all_single`` of
        the pieces' bytes, with uneven split sizes."""
        if not self.is_distributed():
            return x
        p = self.size
        self._account("Alltoall", x, (p - 1) / p)
        split_axis, concat_axis = split_axis % x.ndim, concat_axis % x.ndim
        if split_axis == concat_axis:
            raise ValueError("Alltoall needs split_axis != concat_axis")
        if send_counts is None:
            send_counts = self.counts_displs_shape(x.shape, split_axis)[0]
        if recv_counts is None:
            recv_counts = self._extents(x, concat_axis)
        shapes = []
        for count in recv_counts:
            shape = list(x.shape)
            shape[split_axis] = send_counts[self.rank]
            shape[concat_axis] = count
            shapes.append(shape)
        got = self._exchange(torch.split(x, list(send_counts), dim=split_axis), shapes, x)
        return torch.cat(got, dim=concat_axis)

    def exchange(self, pieces, shapes, like: torch.Tensor) -> List[torch.Tensor]:
        """``pieces[r]`` goes to rank ``r``; returns the piece each rank sent
        here, the one from rank ``s`` of ``shapes[s]``, which the caller
        knows.  One ``all_to_all_single`` of bytes (any dtype, bool too),
        accounted as an ``Alltoall`` of the bytes that leave this rank: a
        piece kept here costs nothing."""
        if not self.is_distributed():
            return [pieces[0]]
        sent = sum(pc.numel() for r, pc in enumerate(pieces) if r != self.rank)
        self._account_bytes("Alltoall", sent * like.element_size())
        return self._exchange(pieces, shapes, like)

    def _exchange(self, pieces, shapes, like: torch.Tensor) -> List[torch.Tensor]:
        """``pieces[r]`` goes to rank ``r``; returns what every rank sent
        here, the piece from rank ``s`` of ``shapes[s]``: one
        ``all_to_all_single`` of bytes, any dtype."""
        item = like.element_size()
        send = torch.cat([pc.contiguous().reshape(-1).view(torch.uint8) for pc in pieces])
        send_sizes = [pc.numel() * item for pc in pieces]
        recv_sizes = [math.prod(sh) * item for sh in shapes]
        recv = send.new_empty(sum(recv_sizes))
        dist.all_to_all_single(recv, send, recv_sizes, send_sizes, group=self.group)
        return [part.view(like.dtype).reshape(sh) for part, sh in zip(torch.split(recv, recv_sizes), shapes)]

    def ReduceScatter(self, x: torch.Tensor, axis: int = 0, op: str = "sum") -> torch.Tensor:
        """``x`` reduced over all ranks, of which each rank keeps its HeAT
        chunk along ``axis`` (uneven chunks go zero-padded to the largest on
        the wire)."""
        if op not in _OPS:
            raise ValueError(f"op must be one of {sorted(_OPS)}, got {op!r}")
        if not self.is_distributed():
            return x
        p = self.size
        self._account("ReduceScatter", x, (p - 1) / p)
        axis = axis % x.ndim
        counts = self.counts_displs_shape(x.shape, axis)[0]
        width = max(counts)
        pieces = [_pad_rows(piece, width) for piece in torch.split(x.movedim(axis, 0), list(counts))]
        out = torch.empty_like(pieces[0])
        dist.reduce_scatter(out, pieces, op=_OPS[op], group=self.group)
        return out[: counts[self.rank]].movedim(0, axis).contiguous()

    def Scatter(self, x: torch.Tensor, root: int = 0, axis: int = 0) -> torch.Tensor:
        """``root``'s ``x`` cut along ``axis`` into HeAT's chunks, one a rank.
        Every rank passes a tensor of ``root``'s shape and dtype; only
        ``root``'s values are read."""
        if not self.is_distributed():
            return x
        p = self.size
        self._account("Scatter", x, 2.0 * (p - 1) / p)
        axis = axis % x.ndim
        counts = self.counts_displs_shape(x.shape, axis)[0]
        width = max(counts)
        xm = x.movedim(axis, 0)
        out = x.new_empty((width,) + tuple(xm.shape[1:]))
        pieces = [_pad_rows(piece, width) for piece in torch.split(xm, list(counts))] if self.rank == root else None
        dist.scatter(out, pieces, src=self._world_rank(root), group=self.group)
        return out[: counts[self.rank]].movedim(0, axis).contiguous()

    def Gather(self, x: torch.Tensor, root: int = 0, axis: int = 0) -> torch.Tensor:
        """Every rank's ``x`` concatenated along ``axis`` on ``root``; every
        other rank receives zeros of that shape, as in the JAX package.  The
        extents along ``axis`` may differ (gathered first)."""
        if not self.is_distributed():
            return x
        axis = axis % x.ndim
        counts = self._extents(x, axis)
        self._account("Gather", x, self.size - 1)
        xm = _pad_rows(x.movedim(axis, 0), max(counts))
        parts = [torch.empty_like(xm) for _ in range(self.size)] if self.rank == root else None
        dist.gather(xm, parts, dst=self._world_rank(root), group=self.group)
        shape = (sum(counts),) + tuple(xm.shape[1:])
        if self.rank != root:
            return x.new_zeros(shape).movedim(0, axis).contiguous()
        return torch.cat([part[:c] for part, c in zip(parts, counts)]).movedim(0, axis).contiguous()

    def Isend(self, x: torch.Tensor, shift: int = 1) -> "_Shift":
        """:meth:`Send` without waiting: posts the send and the receive and
        returns a request whose :meth:`Wait` (or ``.wait()``) gives the
        received tensor, so that work on the card overlaps the transfer."""
        p = self.size
        if p == 1 or shift % p == 0:
            return _Shift(x)
        self._account("Send", x, 1.0)
        rank = self.rank
        staged = self._host_staged(x, "Send")
        buf = x.detach().contiguous()
        if staged:
            buf = buf.cpu()
        recv = torch.empty_like(buf)
        ops = [dist.P2POp(dist.isend, buf, self._world_rank((rank + shift) % p), self.group),
               dist.P2POp(dist.irecv, recv, self._world_rank((rank - shift) % p), self.group)]
        return _Shift(recv, dist.batch_isend_irecv(ops), x.device if staged else None, buf)

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
        return self.Isend(x, shift).wait()

    def Sendrecv(self, x: torch.Tensor, dst: Optional[int], src: Optional[int], shape=None) -> Optional[torch.Tensor]:
        """MPI's ``Sendrecv``: send ``x`` to rank ``dst`` and receive a tensor
        of ``shape`` (default x's) and x's dtype from rank ``src``; either
        rank may be None.  Returns what arrived (on x's device), or None.
        Staged through host memory where :meth:`Send` is."""
        if dst is not None:
            self._account("Send", x, 1.0)
        return self._p2p(x, dst, src, "Send", shape)

    def _p2p(self, x: torch.Tensor, dst: Optional[int], src: Optional[int], name: str,
             shape=None) -> Optional[torch.Tensor]:
        """Send ``x`` to ``dst`` and receive a tensor of ``shape`` (default
        x's) from ``src`` (either may be None); returns what arrived, or None."""
        staged = self._host_staged(x, name)
        buf = x.detach().contiguous()
        if staged:
            buf = buf.cpu()
        ops, recv = [], None
        if dst is not None:
            ops.append(dist.P2POp(dist.isend, buf, self._world_rank(dst), self.group))
        if src is not None:
            recv = torch.empty(buf.shape if shape is None else tuple(shape), dtype=buf.dtype, device=buf.device)
            ops.append(dist.P2POp(dist.irecv, recv, self._world_rank(src), self.group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        if recv is None:
            return None
        return recv.to(x.device) if staged else recv

    def _inclusive_scan(self, x: torch.Tensor, op: str, name: str) -> torch.Tensor:
        """Hillis-Steele recursive doubling over the ranks: ceil(log2 p)
        rounds of one send and one receive, the lower ranks' part combined
        first."""
        combine = _COMBINE[op]
        acc, rank, p, shift = x, self.rank, self.size, 1
        while shift < p:
            got = self._p2p(acc, rank + shift if rank + shift < p else None, rank - shift if rank >= shift else None,
                            name)
            if got is not None:
                acc = combine(got, acc)
            shift *= 2
        return acc

    def Scan(self, x: torch.Tensor) -> torch.Tensor:
        """Inclusive prefix sum across ranks: rank r gets the sum of ``x``
        over ranks 0..r."""
        if not self.is_distributed():
            return x
        self._account("Scan", x, float(_log2(self.size)))
        return self._inclusive_scan(x, "sum", "Scan")

    def Exscan(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """Exclusive prefix reduction across ranks: rank r gets ``x`` of ranks
        0..r-1 combined by ``op``, rank 0 the op's identity (zeros for a
        sum).  Exact: the inclusive scan shifted one rank down, never
        ``inclusive - x``."""
        if op not in _COMBINE:
            raise ValueError(f"op must be one of {sorted(_COMBINE)}, got {op!r}")
        unit = torch.full_like(x, _unit(op, x.dtype))
        if not self.is_distributed():
            return unit
        rank, p = self.rank, self.size
        self._account("Exscan", x, float(_log2(p)) + 1.0)
        inc = self._inclusive_scan(x, op, "Exscan")
        got = self._p2p(inc, rank + 1 if rank + 1 < p else None, rank - 1 if rank > 0 else None, "Exscan")
        return unit if got is None else got

    @staticmethod
    def Wait(x):
        """Block until ``x`` is done: a request of :meth:`Isend` (returns the
        received tensor), a ``torch.distributed`` work handle, or a tensor on
        the card (its stream is synchronised; returns the tensor).

        Deadline-guarded: under an armed :meth:`deadline` a wait on a
        collective whose peer died raises ``CollectiveTimeoutError`` (after
        a stack dump) instead of hanging.  The ``comm.collective`` fault
        site fires inside the guard, so an injected hang trips it too."""

        def _wait():
            _faults().fire("comm.collective")
            if isinstance(x, torch.Tensor):
                if x.is_cuda:
                    torch.cuda.current_stream(x.device).synchronize()
                return x
            return x.wait()

        return _health().guard_blocking(_wait, "comm.Wait")

    def Barrier(self) -> None:
        """Every rank waits for all the others; deadline-guarded like
        :meth:`Wait` (the same watchdog and fault site)."""

        def _barrier():
            _faults().fire("comm.collective")
            if self.is_distributed():
                dist.barrier(group=self.group)

        _health().guard_blocking(_barrier, "comm.Barrier")

    def deadline(self, seconds: float):
        """Arm a collective deadline for the block (``with comm.deadline(30):``):
        the blocking waits (:meth:`Wait`, :meth:`Barrier`) run under a
        watchdog that raises ``utils.health.CollectiveTimeoutError``, after
        dumping every thread's stack, once the budget is spent, and the
        collectives refuse to start past it."""
        return _health().deadline(seconds)

    # ------------------------------------------------------------------ #
    # subgroups and asynchronous collectives
    # ------------------------------------------------------------------ #
    def Split(self, color: int, key: Optional[int] = None) -> "Communication":
        """MPI's ``comm.Split``: the ranks that pass the same ``color`` form
        one new communicator, ranked by ``key`` (default: the rank here).
        Collective: every rank calls it, and every rank creates every group
        (``torch.distributed.new_group``, in the order of the colors), as
        NCCL and gloo require.  torch ranks a group's members in world-rank
        order, so ``key`` must order them the same way.  Splitting by the
        same colors and keys again returns the same communicator.  Only the
        world communicator splits."""
        key = self.rank if key is None else int(key)
        if not self.is_distributed():
            return Communication(self.group, self._ranks)
        if self.group is not None:
            raise NotImplementedError("Split of a subgroup communicator: split the world communicator")
        mine = torch.tensor([int(color), key], dtype=torch.int64, device=self._scratch_device())
        table = [tuple(int(v) for v in t.tolist()) for t in self._raw_allgather(mine)]
        if tuple(table) in self._splits:
            return self._splits[tuple(table)]
        groups = {}
        for world_rank, (c, k) in enumerate(table):
            groups.setdefault(c, []).append((k, world_rank))
        made = None
        for c in sorted(groups):
            members = [r for _, r in sorted(groups[c])]
            if members != sorted(members):
                raise ValueError(f"Split: key orders color {c}'s ranks as {members}; torch ranks a group's "
                                 "members in world-rank order")
            group = dist.new_group(members)
            if c == int(color):
                made = Communication(group, members)
        self._splits[tuple(table)] = made
        return made

    def _scratch_device(self) -> torch.device:
        """Where a small control tensor of this communicator lives: the
        card under NCCL alone, else the host."""
        backend = str(dist.get_backend(self.group)).lower()
        if "nccl" in backend and "gloo" not in backend:
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device("cpu")

    def _raw_allgather(self, x: torch.Tensor) -> List[torch.Tensor]:
        out = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(out, x, group=self.group)
        return out

    def _ialltoall_rows(self, send: torch.Tensor, recv: torch.Tensor, send_counts: Sequence[int],
                        recv_counts: Sequence[int]) -> "_Request":
        """Rows ``send_counts[r]`` of ``send`` (in rank order) go to rank r;
        ``recv`` takes ``recv_counts[s]`` rows from each rank s, in rank
        order: one asynchronous ``all_to_all_single``, accounted as an
        ``Alltoall``.  ``wait()`` gives ``recv``."""
        p = self.size
        if p == 1:
            recv.copy_(send)
            return _Request(recv)
        self._account("Alltoall", send, (p - 1) / p)
        return _Request(recv, dist.all_to_all_single(recv, send, list(map(int, recv_counts)),
                                                     list(map(int, send_counts)), group=self.group, async_op=True))

    def Iallreduce(self, x: torch.Tensor, op: str = "sum", account: bool = True) -> "_Request":
        """:meth:`Allreduce` without waiting: reduces ``x`` in place and
        returns a request whose ``wait()`` gives ``x``.  ``account=False``
        leaves the call out of :meth:`traffic` (the bucketed sync accounts
        its stages itself, on the caller's communicator)."""
        if op not in _OPS:
            raise ValueError(f"op must be one of {sorted(_OPS)}, got {op!r}")
        if not self.is_distributed():
            return _Request(x)
        if account:
            p = self.size
            self._account("Allreduce", x, 2.0 * (p - 1) / p)
        return _Request(x, dist.all_reduce(x, op=_OPS[op], group=self.group, async_op=True))

    def Ireduce_scatter(self, x: torch.Tensor, op: str = "sum", account: bool = True) -> "_Request":
        """``x`` (1-D, its length a multiple of the size) reduced over the
        ranks, of which rank r keeps the r-th of ``size`` equal pieces;
        ``wait()`` gives that piece.  ``account`` as in :meth:`Iallreduce`."""
        if op not in _OPS:
            raise ValueError(f"op must be one of {sorted(_OPS)}, got {op!r}")
        p = self.size
        if x.ndim != 1 or x.numel() % p:
            raise ValueError(f"Ireduce_scatter takes a 1-D tensor of a multiple of {p} elements, got {tuple(x.shape)}")
        if p == 1:
            return _Request(x)
        if account:
            self._account("ReduceScatter", x, (p - 1) / p)
        out = x.new_empty(x.numel() // p)
        return _Request(out, dist.reduce_scatter(out, list(x.chunk(p)), op=_OPS[op], group=self.group,
                                                 async_op=True))

    def Iallgather(self, x: torch.Tensor, out: Optional[torch.Tensor] = None, account: bool = True) -> "_Request":
        """Every rank's 1-D ``x`` (one length on all ranks) concatenated in
        rank order, into ``out`` where given; ``wait()`` gives the
        concatenation.  ``account`` as in :meth:`Iallreduce`."""
        if x.ndim != 1:
            raise ValueError(f"Iallgather takes a 1-D tensor, got {tuple(x.shape)}")
        p = self.size
        if out is None:
            out = x.new_empty(x.numel() * p)
        if p == 1:
            out.copy_(x)
            return _Request(out)
        if account:
            self._account("Allgather", x, p - 1)
        return _Request(out, dist.all_gather(list(out.chunk(p)), x, group=self.group, async_op=True))

    # ------------------------------------------------------------------ #
    # redistribution (the reference's resplit, by Alltoall)
    # ------------------------------------------------------------------ #
    def resplit(
        self,
        x,
        gshape,
        src_split: Optional[int],
        dst_split: Optional[int],
        counts: Optional[Sequence[int]] = None,
        memory_budget=None,
        donate: bool = False,
    ) -> torch.Tensor:
        """This rank's part of the global array of shape ``gshape``, held
        split along ``src_split`` (every rank's extent ``counts``, HeAT's
        chunks when not given), redistributed to ``dst_split``'s chunks:
        split to split by one :meth:`Alltoall`, split to None by
        :meth:`Allgatherv`, None to split by a local slice (a copy).  The
        identity at world size 1 and where the splits agree.

        ``memory_budget`` (bytes or a K/M/G string; ``None``: the process
        default of ``set_redistribution_budget``/``HEAT_TPU_RESPLIT_BUDGET``;
        0: unbounded) bounds the bytes of the global array moved a step:
        where the plan of ``core.redistribution`` tiles, the transfer runs as
        its K tiled collectives.  With ``donate``, ``x`` is a one-element list
        holding the only reference to this rank's chunk; the list is emptied
        and the chunk dropped once its last tile has left it (the in-place
        ``resplit_``)."""
        from . import redistribution

        t = x[0] if donate else x
        plan = None
        if src_split != dst_split and self.is_distributed():
            gshape = tuple(int(s) for s in gshape)
            plan = redistribution.make_plan(self, gshape, t.element_size(), src_split, dst_split, memory_budget)
        if plan is not None and plan.n_tiles > 1:
            del t
            return redistribution.execute_plan(self, x, plan, counts, donate=donate)
        if donate:
            x.pop()
        if src_split == dst_split or not self.is_distributed():
            return t
        return self._resplit_whole(t, gshape, src_split, dst_split, counts)

    # the reference's explicit entry of the tiled path: the same planner decides
    resplit_tiled = resplit

    def _resplit_whole(self, x: torch.Tensor, gshape, src_split, dst_split, counts) -> torch.Tensor:
        """The monolithic resplit: one collective of the whole chunk."""
        if counts is None and src_split is not None:
            counts = self.counts_displs_shape(gshape, src_split)[0]
        if dst_split is None:
            return self.Allgatherv(x, src_split, counts=counts)
        if src_split is None:
            return x[self.chunk(gshape, dst_split)[2]].clone(memory_format=torch.contiguous_format)
        return self.Alltoall(x, dst_split, src_split, send_counts=self.counts_displs_shape(gshape, dst_split)[0],
                             recv_counts=counts)

    def redistribute(self, x: torch.Tensor, axis: int, counts: Sequence[int], target: Sequence[int]) -> torch.Tensor:
        """Move rows along ``axis`` from the layout ``counts`` (every rank's
        extent, in rank order) to ``target``: each rank sends the rows of its
        range that fall in each other rank's target range.  One
        :meth:`Alltoall`-priced ``all_to_all_single`` of bytes."""
        if not self.is_distributed() or list(counts) == list(target):
            return x
        if sum(counts) != sum(target):
            raise ValueError(f"target map holds {sum(target)} rows, the array {sum(counts)}")
        p, rank = self.size, self.rank
        self._account("Alltoall", x, (p - 1) / p)
        src_off = np.concatenate([[0], np.cumsum(counts)])
        dst_off = np.concatenate([[0], np.cumsum(target)])

        def overlap(a, b):
            lo, hi = max(src_off[a], dst_off[b]), min(src_off[a + 1], dst_off[b + 1])
            return int(max(hi - lo, 0))

        send = [overlap(rank, r) for r in range(p)]
        recv = [overlap(r, rank) for r in range(p)]
        shapes = []
        for count in recv:
            shape = list(x.shape)
            shape[axis] = count
            shapes.append(shape)
        return torch.cat(self._exchange(torch.split(x, send, dim=axis), shapes, x), dim=axis)

    def transport(self, x: torch.Tensor, op: str = "Send") -> str:
        """How collective ``op`` moves ``x``: ``'local'`` at world size 1,
        ``'gloo-host-staged'`` for a CUDA tensor under gloo alone where gloo
        refuses CUDA buffers (its send and recv: ``Send``, ``Exscan``,
        ``Scan``), else the backend's name."""
        if not self.is_distributed():
            return "local"
        if self._host_staged(x, op):
            return "gloo-host-staged"
        return "nccl" if x.is_cuda and self._nccl() else "gloo"

    def _nccl(self) -> bool:
        return "nccl" in str(dist.get_backend(self.group)).lower()

    def _host_staged(self, x: torch.Tensor, op: str = "Send") -> bool:
        """A CUDA tensor in a process group with no CUDA backend (gloo alone),
        for a collective that gloo takes only from host memory."""
        return x.is_cuda and op in _GLOO_HOST_STAGED and not self._nccl()


class _Shift:
    """A posted ring shift of :meth:`Communication.Isend`: ``wait()`` (or
    ``comm.Wait``) completes it and returns the received tensor."""

    def __init__(self, recv: torch.Tensor, reqs=(), device=None, sent=None):
        self._recv, self._reqs, self._device, self._sent = recv, list(reqs), device, sent

    def wait(self) -> torch.Tensor:
        for req in self._reqs:
            req.wait()
        self._reqs, self._sent = [], None
        if self._device is not None:  # host-staged: back to the card
            self._recv, self._device = self._recv.to(self._device), None
        return self._recv

    Wait = wait


class _Request:
    """An asynchronous collective's request: ``wait()`` (or ``Wait``)
    completes it and returns its result tensor.  Under NCCL the wait
    makes the current stream wait for the collective; the host goes on."""

    def __init__(self, result: torch.Tensor, work=None):
        self._result, self._work = result, work

    def wait(self) -> torch.Tensor:
        if self._work is not None:
            self._work.wait()
            self._work = None
        return self._result

    Wait = wait


def _pad_rows(t: torch.Tensor, width: int) -> torch.Tensor:
    """``t`` zero-padded to ``width`` rows along axis 0, contiguous: one
    piece of a collective that takes pieces of one shape."""
    if t.shape[0] < width:
        t = torch.cat([t, t.new_zeros((width - t.shape[0],) + tuple(t.shape[1:]))])
    return t.contiguous()


def _log2(p: int) -> int:
    """ceil(log2 p): the rounds of a recursive-doubling scan over p ranks."""
    return max(p - 1, 0).bit_length()


_COMBINE = {"sum": torch.add, "prod": torch.mul, "max": torch.maximum, "min": torch.minimum}


def _unit(op: str, dtype: torch.dtype):
    """The identity of scan op ``op`` in ``dtype``: a sum's 0, a product's 1,
    a maximum's lowest value, a minimum's highest."""
    if op in ("sum", "prod"):
        one = op == "prod"
        return one if dtype == torch.bool else int(one)
    high = op == "min"
    if dtype == torch.bool:
        return high
    if dtype.is_floating_point:
        return float("inf") if high else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if high else info.min


_world_comm: Optional[Communication] = None
_default_comm: Optional[Communication] = None


def world() -> Communication:
    """The communicator over the world process group (the reference's
    ``MPI_WORLD``); over a world of one process where no group is
    initialized."""
    global _world_comm
    if _world_comm is None:
        _world_comm = Communication()
    return _world_comm


def get_comm() -> Communication:
    """The default communicator: the one :func:`use_comm` set, else :func:`world`."""
    return _default_comm if _default_comm is not None else world()


def use_comm(comm: Optional[Communication] = None) -> None:
    """Make ``comm`` the default communicator of every factory and op that
    is given none; ``None`` restores :func:`world`."""
    global _default_comm
    if comm is not None and not isinstance(comm, Communication):
        raise TypeError(f"Expected Communication, got {type(comm)}")
    _default_comm = comm


def sanitize_comm(comm: Optional[Communication]) -> Communication:
    if comm is None:
        return get_comm()
    if isinstance(comm, Communication):
        return comm
    raise TypeError(f"Unknown communication, must be a Communication, got {type(comm)}")


# the flight recorder may have been env-armed before this module finished
# importing: its poke then hit the half-initialized module and the
# `_FLIGHTREC = None` line above clobbered it
def _rearm_flightrec() -> None:
    global _FLIGHTREC
    import sys

    fr = sys.modules.get("heat_tpu_torch.utils.flightrec")
    if fr is not None and getattr(fr, "enabled", lambda: False)():
        _FLIGHTREC = fr


_rearm_flightrec()
