"""Halo exchange (reference: ``heat_tpu/parallel/halo.py``; HeAT's
``DNDarray.get_halo``).

Each rank receives the ``halo_size`` elements of the split axis that
precede its block globally and the ``halo_size`` that follow it (zeros
past the global edges), and computes on ``[halo_prev | block |
halo_next]``: the skeleton of a stencil or a convolution.  The reference's
``ppermute`` neighbour shifts become ``Sendrecv`` of the edge rows to the
neighbours.  HeAT's ``chunk`` can leave a rank fewer rows than the halo
(and a rank none); the halo then spans several ranks, and every rank's
edge rows (at most ``halo_size`` of each end) are gathered instead
(``Allgatherv``), from which each rank takes the rows it needs.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ..core.communication import Communication

__all__ = ["halo_exchange", "with_halos"]


def _take(t: torch.Tensor, axis: int, start: int, stop: int) -> torch.Tensor:
    return t.narrow(axis, start, max(stop - start, 0))


def halo_exchange(block: torch.Tensor, halo_size: int, comm: Communication, split_axis: int = 0,
                  counts: Optional[Sequence[int]] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(halo_prev, halo_next) of this rank's local ``block``: the
    ``halo_size`` slices of the split axis before and after it in the global
    array, zeros past its edges.  ``counts`` are every rank's extents along
    the axis (gathered when not given).  Collective."""
    h = int(halo_size)
    ax = split_axis % block.ndim
    shape = list(block.shape)
    shape[ax] = h
    zeros = block.new_zeros(shape)
    p, r = comm.size, comm.rank
    if p == 1 or h == 0:
        return zeros, zeros.clone()
    if counts is None:
        counts = comm._extents(block, ax)
    counts = [int(c) for c in counts]
    n = block.shape[ax]
    if min(counts) >= h:  # each neighbour holds the whole halo: one shift each way
        tail = _take(block, ax, n - h, n).contiguous()
        head = _take(block, ax, 0, h).contiguous()
        prev = comm.Sendrecv(tail, r + 1 if r + 1 < p else None, r - 1 if r > 0 else None)
        nxt = comm.Sendrecv(head, r - 1 if r > 0 else None, r + 1 if r + 1 < p else None)
        return (zeros if prev is None else prev), (zeros.clone() if nxt is None else nxt)
    # short chunks: gather every rank's first and last min(h, count) slices
    k = [min(h, c) for c in counts]
    heads = comm.Allgatherv(_take(block, ax, 0, k[r]).contiguous(), ax, k)
    tails = comm.Allgatherv(_take(block, ax, n - k[r], n).contiguous(), ax, k)
    offs = [sum(k[:i]) for i in range(p)]
    before, got = [], 0
    for q in range(r - 1, -1, -1):  # the slices before this block, nearest first
        if got == h:
            break
        take = min(h - got, k[q])
        before.insert(0, _take(tails, ax, offs[q] + k[q] - take, offs[q] + k[q]))
        got += take
    shape[ax] = h - got
    prev = torch.cat([block.new_zeros(shape)] + before, ax)
    after, got = [], 0
    for q in range(r + 1, p):
        if got == h:
            break
        take = min(h - got, k[q])
        after.append(_take(heads, ax, offs[q], offs[q] + take))
        got += take
    shape[ax] = h - got
    nxt = torch.cat(after + [block.new_zeros(shape)], ax)
    return prev.contiguous(), nxt.contiguous()


def with_halos(array, halo_size: int, split_axis: Optional[int] = None, comm: Optional[Communication] = None):
    """This rank's block extended with its halos, ``[halo_prev | local |
    halo_next]`` along the split axis, as a local tensor.  ``array`` is a
    DNDarray (its split axis and communicator by default) or a local tensor
    with ``split_axis`` and ``comm``.  The reference returns the global
    array of all ranks' extended blocks; here each rank holds its own."""
    from ..core.dndarray import DNDarray

    counts = None
    if isinstance(array, DNDarray):
        split_axis = array.split if split_axis is None else split_axis
        comm = array.comm if comm is None else comm
        if array.split is not None and array.is_distributed():
            counts = array.counts_displs()[0]
        array = array.larray
    if split_axis is None or comm is None:
        raise ValueError("with_halos needs a split axis and a communicator")
    prev, nxt = halo_exchange(array, halo_size, comm, split_axis, counts)
    return torch.cat([prev, array, nxt], split_axis % array.ndim)
