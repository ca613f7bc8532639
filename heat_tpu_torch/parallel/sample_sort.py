"""The distributed sample sort and exact order statistics (reference:
``heat_tpu/parallel/sample_sort.py``).

HeAT's design, with exact splitters: every rank sorts its chunk, the p - 1
splitters at the canonical ``chunk`` boundaries are found as global order
statistics, one ``exchange`` sends each rank the runs of every other rank's
sorted chunk that fall in its range (runs of any size: the ranks hold
tensors of any size, so the reference's padded exchange, its overflow
fallback and its 32-bit key coders are not needed), and each rank merges
what it received.  The result lands in ``chunk``'s layout, and each element
crosses the wire at most once.

Keys are int64 order keys (:func:`order_key`): a float's bits with the
magnitude bits of negatives flipped, -0.0 as 0.0 and every NaN the largest
key; an integer as itself; the bitwise complement for a descending order.
Ties are broken by global position, so the order is stable.

An order statistic is found by radix selection: each round splits the
interval that holds the target rank into 64 bins, every rank counts the
keys of its sorted chunk at most each bin's top (``searchsorted``), one
``Allreduce`` sums the counts (512 bytes a target), and the bin that
reaches the target becomes the next interval.
The first interval is [global min, global max], so float32 data in [0, 1)
takes 5 rounds and any int64 data at most 11.  Keys equal to a splitter are cut by global
position: the ranks' counts of the equal keys (one ``Allgather``) say how
many of each rank's lie below the boundary.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

__all__ = ["ALONE", "decode_key", "first_occurrence_mask", "order_key", "order_statistics_1d", "sample_sort_1d"]

_I64_MIN, _I64_MAX = -(2**63), 2**63 - 1
# bits of the key resolved by each selection round (2^_RADIX bins a round)
_RADIX = 6
_BITS = {torch.float16: (torch.int16, 16), torch.bfloat16: (torch.int16, 16), torch.float32: (torch.int32, 32),
         torch.float64: (torch.int64, 64)}


class _Alone:
    """The communicator of an array every rank holds whole: no peers, so
    the functions below run locally on it."""

    size, rank = 1, 0

    @staticmethod
    def is_distributed() -> bool:
        return False


ALONE = _Alone()


def order_key(t: torch.Tensor, descending: bool = False) -> torch.Tensor:
    """int64 keys whose order is ``t``'s ascending order (NaN last; -0.0 and
    0.0 equal), or its descending order (NaN first)."""
    if t.dtype in _BITS:
        view, bits = _BITS[t.dtype]
        t = torch.where(t == 0, torch.zeros((), dtype=t.dtype, device=t.device), t)
        b = t.view(view)
        k = b ^ ((b >> (bits - 1)) & torch.iinfo(view).max)
        k = torch.where(torch.isnan(t), torch.iinfo(view).max, k).to(torch.int64)
    elif t.is_complex():
        raise TypeError("complex values have no order key; sort_complex orders them")
    else:
        k = t.to(torch.int64)
    return torch.bitwise_not(k) if descending else k


def decode_key(k: torch.Tensor, dtype: torch.dtype, descending: bool = False) -> torch.Tensor:
    """The values of ``dtype`` whose :func:`order_key` is ``k`` (a NaN key
    decodes to a NaN, a zero to +0.0)."""
    if descending:
        k = torch.bitwise_not(k)
    if dtype in _BITS:
        view, bits = _BITS[dtype]
        b = k.to(view)
        return (b ^ ((b >> (bits - 1)) & torch.iinfo(view).max)).view(dtype)
    return k.to(dtype)


def _sorted_counter(keys: torch.Tensor):
    """Counts of sorted ``keys`` at most each bound: one ``searchsorted``."""
    def count(bounds: torch.Tensor) -> torch.Tensor:
        return torch.searchsorted(keys, bounds.reshape(-1), right=True).reshape(bounds.shape)

    return count


def _key_range(comm, kmin: Optional[int], kmax: Optional[int], device) -> Tuple[Optional[int], Optional[int]]:
    """The global least and greatest key (None where no rank holds one):
    one ``Allgather`` of each rank's pair."""
    has = kmin is not None
    t = torch.tensor([int(has), kmin if has else 0, kmax if has else 0], dtype=torch.int64, device=device)
    rows = torch.stack(comm.Allgather(t)).tolist()
    rows = [r for r in rows if r[0]]
    if not rows:
        return None, None
    return min(r[1] for r in rows), max(r[2] for r in rows)


def _select(comm, count, targets: Sequence[int], lo: int, hi: int, device) -> Tuple[List[int], List[int]]:
    """Radix selection: for each global sorted position in ``targets``, the
    key there and the global count of keys below it.  ``count(bounds)``
    gives this rank's counts of keys at most each bound of a (targets,
    2^_RADIX) int64 tensor; ``[lo, hi]`` holds every key."""
    span = hi - lo + 1
    width = 1 << (_RADIX * -(-(span - 1).bit_length() // _RADIX)) if span > 1 else 1
    los = [lo] * len(targets)
    below = [0] * len(targets)
    bins = 1 << _RADIX
    while width > 1 and targets:
        w = width // bins
        tops = [[min(lo_j + w * d - 1, _I64_MAX) for d in range(1, bins + 1)] for lo_j in los]
        bounds = torch.tensor(tops, dtype=torch.int64, device=device)
        counts = comm.Allreduce(count(bounds).contiguous()).cpu()
        # each target's bin: one batched search of every row
        bins_of = torch.searchsorted(counts, torch.tensor(targets, dtype=counts.dtype).reshape(-1, 1),
                                     right=True).reshape(-1).tolist()
        for j, b in enumerate(bins_of):
            if b > 0:
                below[j] = int(counts[j, b - 1])
            los[j] += b * w
        width = w
    return los, below


def order_statistics_1d(comm, values: torch.Tensor, ranks: Sequence[int]) -> torch.Tensor:
    """The values at the given global sorted positions (0-based) of the
    array whose chunk this rank holds as ``values`` (any shape, read flat;
    NaN sorts last), the same on every rank, without moving the array:
    each rank sorts its chunk, and radix selection over the ranks' counts
    (``searchsorted`` in the sorted chunk) finds each key.  At world size
    1 the sorted chunk is the answer."""
    flat = values.reshape(-1)
    device = flat.device
    s = torch.sort(flat).values  # NaN last, as the order keys
    if not comm.is_distributed():
        return s[torch.tensor([int(r) for r in ranks], dtype=torch.int64, device=device)]
    ks = order_key(s)
    del s
    lo, hi = _key_range(comm, int(ks[0]) if ks.numel() else None, int(ks[-1]) if ks.numel() else None, device)
    if lo is None:
        raise ValueError("order statistics of an empty array")
    keys, _ = _select(comm, _sorted_counter(ks), [int(r) for r in ranks], lo, hi, device)
    return decode_key(torch.tensor(keys, dtype=torch.int64, device=device), values.dtype)


def sample_sort_1d(comm, keys: torch.Tensor, payloads: Sequence[torch.Tensor], counts: Sequence[int],
                   key_of=None) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Sort the 1-D array whose chunk this rank holds by the int64 ``keys``
    (this rank's), carrying each of ``payloads`` (tensors of this rank's
    length) along: stable by global position, the result in ``chunk``'s
    layout.  ``counts`` are every rank's lengths (in rank order).  Where
    ``key_of(payloads[0])`` recomputes the keys, they do not travel.
    Returns this rank's sorted keys and payloads."""
    p, rank = comm.size, comm.rank
    ks, order = torch.sort(keys, stable=True)
    payloads = [pl[order] for pl in payloads]
    if p == 1:
        return ks, payloads
    n = int(sum(counts))
    device = keys.device
    target = comm.counts_displs_shape((n,), 0)
    bounds = list(target[1][1:])  # the first global position of ranks 1..p-1
    lo, hi = _key_range(comm, int(ks[0]) if ks.numel() else None, int(ks[-1]) if ks.numel() else None, device)
    if lo is None:
        return ks, payloads
    split_keys, split_below = _select(comm, _sorted_counter(ks), bounds, lo, hi, device)
    kt = torch.tensor(split_keys, dtype=torch.int64, device=device)
    less = torch.searchsorted(ks, kt, right=False)
    equal = torch.searchsorted(ks, kt, right=True) - less
    table = torch.stack(comm.Allgather(equal)).cpu()  # (p, p - 1): every rank's equal keys at each splitter
    before = table[:rank].sum(0)
    take = (torch.tensor(bounds) - torch.tensor(split_below) - before).clamp(min=0)
    cuts = (less.cpu() + torch.minimum(take, equal.cpu())).tolist()
    edges = [0] + cuts + [ks.numel()]
    send = [edges[r + 1] - edges[r] for r in range(p)]
    sent = torch.stack(comm.Allgather(torch.tensor(send, dtype=torch.int64, device=device))).cpu()
    recv = sent[:, rank].tolist()
    moving = list(payloads) if key_of is not None else [ks] + list(payloads)
    got = [torch.cat(comm.exchange(list(torch.split(t, send)), [[c] + list(t.shape[1:]) for c in recv], t))
           for t in moving]
    if key_of is not None:
        rk, rp = key_of(got[0]), got
    else:
        rk, rp = got[0], got[1:]
    rk, order = torch.sort(rk, stable=True)  # runs arrive in source order: a stable sort keeps position order
    return rk, [t[order] for t in rp]


def first_occurrence_mask(comm, values: torch.Tensor, counts: Sequence[int]) -> torch.Tensor:
    """Bool mask of the first occurrences in this rank's chunk of a sorted
    1-D array (NaN equal to NaN): each element against its predecessor,
    the first against the last element of the nearest earlier rank that
    holds one (one ``Allgather`` of every rank's last element)."""
    same = values[1:] == values[:-1]
    if values.is_floating_point():
        same |= torch.isnan(values[1:]) & torch.isnan(values[:-1])
    first = torch.ones(values.shape[0], dtype=torch.bool, device=values.device)
    first[1:] = ~same
    if comm.is_distributed():
        wire = values.view(torch.uint8) if values.dtype == torch.bool else values
        lasts = comm.Allgather((wire[-1:] if values.numel() else wire.new_zeros(1)).contiguous())
        prev = [r for r in range(comm.rank) if counts[r] > 0]
        if prev and values.numel():
            v, head = lasts[prev[-1]].view(values.dtype), values[:1]
            eq = (v == head) | (torch.isnan(v) & torch.isnan(head)) if values.is_floating_point() else v == head
            first[0] = ~eq[0]
    return first
