"""Shape and layout manipulations, order and set ops (reference:
``heat_tpu/core/manipulations.py``).

The reference's names, signatures and result splits; the work is HeAT's:
each rank holds a local tensor and the communicator moves what must move.

- An op that keeps the split axis's order moves no data: each rank works on
  its own chunk (``repeat`` along the split axis then leaves an unbalanced
  result, as slicing does).
- ``reshape`` moves only the elements whose owner changes, in one exchange
  by flat index; ``concatenate`` along the split axis sends each operand's
  rows to the result's ``chunk`` layout; ``flip``, ``roll``, ``take`` and
  ``shuffle`` along the split axis go through the indexing core's exchange
  (only the rows that change rank move).
- ``sort`` of a 1-D split array is the distributed sample sort
  (``parallel.sample_sort``); along the split axis of an n-D array the
  transpose method (resplit to another axis, sort there, resplit back);
  ``unique`` sorts, marks the first occurrences and keeps each rank's.
- Where the reference's result is replicated (``split``'s parts along the
  split axis, ``unique``'s inverse lookup table, ``resize``), or its
  docstring says it gathers, the port gathers too, and warns as the
  reference's ``_warn_implicit_gather`` does.

No result shares storage with its source: the reference's arrays are
immutable, so a torch view is copied.  Sort and order indices are int32
where every index fits (int64 past 2^31 - 1).
"""

from __future__ import annotations

import builtins
import collections
import functools
import math
import warnings
from typing import List, Optional

import numpy as np
import torch

from . import factories, types
from ._operations import _wrap
from .dndarray import DNDarray
from .indexing import _index_dtype
from .stride_tricks import sanitize_axis, sanitize_shape

__all__ = [
    "append",
    "apply_along_axis",
    "apply_over_axes",
    "argpartition",
    "argsort",
    "argwhere",
    "array2string",
    "array_repr",
    "array_split",
    "array_str",
    "ascontiguousarray",
    "asfortranarray",
    "astype",
    "atleast_1d",
    "atleast_2d",
    "atleast_3d",
    "balance",
    "broadcast_arrays",
    "broadcast_to",
    "choose",
    "collect",
    "column_stack",
    "compress",
    "concat",
    "concatenate",
    "copyto",
    "delete",
    "diag",
    "diagflat",
    "diagonal",
    "dsplit",
    "dstack",
    "expand_dims",
    "extract",
    "fill_diagonal",
    "flatten",
    "flip",
    "fliplr",
    "flipud",
    "hsplit",
    "hstack",
    "insert",
    "intersect1d",
    "lexsort",
    "matrix_transpose",
    "moveaxis",
    "ndim",
    "pad",
    "partition",
    "permute_dims",
    "piecewise",
    "place",
    "put",
    "put_along_axis",
    "putmask",
    "ravel",
    "redistribute",
    "repeat",
    "reshape",
    "resize",
    "resplit",
    "roll",
    "rollaxis",
    "rot90",
    "row_stack",
    "searchsorted",
    "select",
    "setdiff1d",
    "setxor1d",
    "shape",
    "shuffle",
    "size",
    "sort",
    "sort_complex",
    "split",
    "squeeze",
    "stack",
    "swapaxes",
    "take",
    "take_along_axis",
    "tile",
    "topk",
    "trim_zeros",
    "unfold",
    "union1d",
    "unique",
    "unique_all",
    "unique_counts",
    "unique_inverse",
    "unique_values",
    "unwrap",
    "vsplit",
    "vstack",
]

# element count below which a gather stays silent (a 5-element gather is not a trap)
_GATHER_WARN_THRESHOLD = 512


def _warn_implicit_gather(op: str, x: DNDarray) -> None:
    """The reference's warning where an op gathers a split axis onto every rank."""
    if x.is_distributed() and x.size >= _GATHER_WARN_THRESHOLD:
        warnings.warn(
            f"{op} on a split array falls back to a global formulation that gathers the split axis "
            f"({x.shape[x.split]} elements onto every device); this is a communication- and memory-heavy operation.",
            stacklevel=3,
        )


def _dnd(a, proto: DNDarray) -> DNDarray:
    """``a`` as a DNDarray on ``proto``'s device and communicator (replicated)."""
    if isinstance(a, DNDarray):
        return a
    return factories.array(a, device=proto.device, comm=proto.comm)


def _proto(arrays) -> DNDarray:
    for a in arrays:
        if isinstance(a, DNDarray):
            return a
    raise TypeError("at least one operand must be a DNDarray")


def _full(x: DNDarray) -> torch.Tensor:
    """The whole of ``x`` on every rank (gathered where split)."""
    return x.resplit(None).larray if x.is_distributed() else x.larray


def _own(t: torch.Tensor, source: torch.Tensor) -> torch.Tensor:
    """``t``, copied where it shares storage with ``source``."""
    if t.untyped_storage().data_ptr() == source.untyped_storage().data_ptr():
        return t.clone(memory_format=torch.contiguous_format)
    return t


def _local(x: DNDarray, t: torch.Tensor, gshape, split, balanced=None) -> DNDarray:
    """A result made by each rank from its own chunk (no communication)."""
    t = _own(t, x.larray)
    return _wrap(t, tuple(gshape), split, x, x.balanced if balanced is None else balanced)


def _scatter_chunk(x: DNDarray, t: torch.Tensor, gshape, split) -> DNDarray:
    """``t``, the whole result on every rank, as a DNDarray split ``split``:
    each rank keeps its chunk (a copy)."""
    gshape = tuple(gshape)
    if split is not None and split >= len(gshape):
        split = None
    if split is not None and x.comm.is_distributed():
        t = t[x.comm.chunk(gshape, split)[2]]
    return _wrap(t.clone(memory_format=torch.contiguous_format), gshape, split if len(gshape) else None, x)


def _to_split(y: DNDarray, split: Optional[int]) -> DNDarray:
    """``y`` with split ``split`` (None where ``y`` has no such axis)."""
    if split is not None and (y.ndim == 0 or split >= y.ndim):
        split = None
    if y.split == split:
        return y
    if not y.comm.is_distributed():
        return DNDarray(y.larray, y.gshape, y.dtype, split, y.device, y.comm, True)
    return y.resplit(split)


# ---------------------------------------------------------------------- #
# shapes
# ---------------------------------------------------------------------- #
def ndim(x) -> int:
    """Number of dimensions."""
    return x.ndim if isinstance(x, DNDarray) else np.ndim(x)


def size(x) -> int:
    """Number of elements."""
    return x.size if isinstance(x, DNDarray) else np.size(x)


def shape(x) -> tuple:
    """Global shape."""
    return x.shape if isinstance(x, DNDarray) else np.shape(x)


def expand_dims(x: DNDarray, axis: int) -> DNDarray:
    """``x`` with a new axis of length 1 at ``axis``; the split shifts past it."""
    nd = x.ndim + 1
    axis = axis % nd
    split = x.split + 1 if x.split is not None and axis <= x.split else x.split
    gshape = x.gshape[:axis] + (1,) + x.gshape[axis:]
    return _local(x, x.larray.unsqueeze(axis), gshape, split)


def squeeze(x: DNDarray, axis=None) -> DNDarray:
    """``x`` without its length-1 axes (those of ``axis``); a split axis
    that goes is gathered (its one row)."""
    if axis is None:
        axes = [a for a in range(x.ndim) if x.gshape[a] == 1]
    else:
        axes = [a % x.ndim for a in (axis if isinstance(axis, (tuple, list)) else (axis,))]
        for a in axes:
            if x.gshape[a] != 1:
                raise ValueError("cannot select an axis to squeeze out which has size not equal to one")
    if x.split in axes:
        x = x.resplit(None)
    split = None if x.split is None else x.split - builtins.sum(1 for a in axes if a < x.split)
    gshape = tuple(s for i, s in enumerate(x.gshape) if i not in axes)
    t = x.larray.reshape([s for i, s in enumerate(x.lshape) if i not in axes])
    return _local(x, t, gshape, split)


def atleast_1d(*arrays):
    """Each input with at least one axis."""
    res = [reshape(a, (1,)) if a.ndim == 0 else a for a in (_atleast_in(a) for a in arrays)]
    return res[0] if len(res) == 1 else res


def atleast_2d(*arrays):
    """Each input with at least two axes; a 1-D array becomes (1, N)."""
    res = []
    for a in (_atleast_in(a) for a in arrays):
        res.append(reshape(a, (1, 1)) if a.ndim == 0 else expand_dims(a, 0) if a.ndim == 1 else a)
    return res[0] if len(res) == 1 else res


def atleast_3d(*arrays):
    """Each input with at least three axes (numpy's promotion)."""
    res = []
    for a in (_atleast_in(a) for a in arrays):
        if a.ndim == 0:
            a = reshape(a, (1, 1, 1))
        elif a.ndim == 1:
            a = expand_dims(expand_dims(a, 0), -1)
        elif a.ndim == 2:
            a = expand_dims(a, -1)
        res.append(a)
    return res[0] if len(res) == 1 else res


def _atleast_in(a):
    return a if isinstance(a, DNDarray) else factories.array(a)


def _flat_indices(shape, split: Optional[int], offset: int, count: int, device) -> torch.Tensor:
    """The flat global indices (row-major in ``shape``) of the chunk of
    ``count`` entries of axis ``split`` from ``offset``, in the chunk's
    row-major order (increasing)."""
    if split is None:
        return torch.arange(math.prod(shape), dtype=torch.int64, device=device)
    outer, n, inner = math.prod(shape[:split]), shape[split], math.prod(shape[split + 1:])
    o = torch.arange(outer, dtype=torch.int64, device=device)[:, None, None]
    j = torch.arange(offset, offset + count, dtype=torch.int64, device=device)[None, :, None]
    i = torch.arange(inner, dtype=torch.int64, device=device)[None, None, :]
    return ((o * n + j) * inner + i).reshape(-1)


def _owner(flat: torch.Tensor, shape, split: int, counts) -> torch.Tensor:
    """The rank that holds each flat index of an array of ``shape`` split
    along ``split`` in the extents ``counts``."""
    inner = math.prod(shape[split + 1:])
    coord = (flat // inner) % shape[split]
    ends = torch.tensor(np.cumsum(counts), dtype=torch.int64, device=flat.device)
    return torch.searchsorted(ends, coord, right=True)


def _relayout(x: DNDarray, shape, split: int) -> torch.Tensor:
    """This rank's chunk of ``x`` reshaped to ``shape`` and split along
    ``split``: one exchange of the elements whose owner changes, each sent
    in flat order, placed by its flat index (which the receiver knows, so
    no index travels).  Split 0 to split 0 moves contiguous flat runs."""
    comm, dev = x.comm, x.larray.device
    rank, p = comm.rank, comm.size
    src_counts, src_displs = x.counts_displs()
    dst_counts, dst_displs = comm.counts_displs_shape(shape, split)
    lshape = comm.chunk(shape, split)[1]
    t = x.larray.reshape(-1)
    if x.split == 0 and split == 0:
        inner_s, inner_d = math.prod(x.gshape[1:]), math.prod(shape[1:])
        lo, hi = src_displs[rank] * inner_s, (src_displs[rank] + src_counts[rank]) * inner_s
        dlo = [d * inner_d for d in dst_displs]
        dhi = [(d + c) * inner_d for c, d in zip(dst_counts, dst_displs)]
        send = [builtins.max(builtins.min(hi, dhi[q]) - builtins.max(lo, dlo[q]), 0) for q in range(p)]
        recv = [builtins.max(builtins.min((src_displs[s] + src_counts[s]) * inner_s, dhi[rank]) -
                             builtins.max(src_displs[s] * inner_s, dlo[rank]), 0) for s in range(p)]
        got = comm.exchange(list(torch.split(t, send)), [[n] for n in recv], t)
        return torch.cat(got).reshape(lshape)
    mine = _flat_indices(x.gshape, x.split, src_displs[rank], src_counts[rank], dev)
    dest = _owner(mine, shape, split, dst_counts)
    order = torch.argsort(dest, stable=True)
    send = torch.bincount(dest, minlength=p).tolist()
    target = _flat_indices(shape, split, dst_displs[rank], dst_counts[rank], dev)
    src = _owner(target, x.gshape, x.split, src_counts)
    recv = torch.bincount(src, minlength=p).tolist()
    got = torch.cat(comm.exchange(list(torch.split(t[order], send)), [[n] for n in recv], t))
    out = torch.empty_like(got)
    out[torch.argsort(src, stable=True)] = got
    return out.reshape(lshape)


def _reshape_split(x: DNDarray, shape) -> Optional[int]:
    """The reference's output split of ``reshape``: the input's split axis
    where the new shape has it, else 0 (None for a replicated input)."""
    if x.split is None:
        return None
    return x.split if x.split < len(shape) else (0 if len(shape) else None)


def reshape(x: DNDarray, *shape, new_split: Optional[int] = None, **kwargs) -> DNDarray:
    """``x`` in a new shape (numpy's row-major order).  The result's split
    is the reference's (l.459-461: the same axis where it still exists, else
    0) unless ``new_split`` is given.  Only the elements whose owner
    changes move, in one exchange by flat index."""
    if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
        shape = tuple(shape[0])
    shape = tuple(int(s) for s in shape)
    if -1 in shape:
        known = math.prod(s for s in shape if s != -1)
        shape = tuple(x.size // known if s == -1 else s for s in shape)
    if math.prod(shape) != x.size:
        raise ValueError(f"cannot reshape array of size {x.size} into shape {shape}")
    split = _reshape_split(x, shape) if new_split is None else sanitize_axis(shape, new_split)
    if split is not None and not shape:
        split = None
    if not x.is_distributed():
        t = x.larray.reshape(shape)
        if split is not None and x.comm.is_distributed():  # replicated in, split out: this rank's chunk
            return _scatter_chunk(x, t, shape, split)
        return _local(x, t, shape, split, True)
    if split is None:
        return _local(x, _full(x).reshape(shape), shape, None, True)
    if shape == x.gshape and split == x.split:  # nothing moves
        return _local(x, x.larray.clone(), shape, split)
    if x.size == 0:
        return _wrap(x.larray.new_empty(x.comm.chunk(shape, split)[1]), shape, split, x)
    return _wrap(_relayout(x, shape, split), shape, split, x)


def flatten(x: DNDarray) -> DNDarray:
    """``x`` as 1-D; a split array stays split along 0."""
    return reshape(x, (-1,) if x.size else (0,))


def ravel(x: DNDarray) -> DNDarray:
    return flatten(x)


def broadcast_to(x: DNDarray, shape) -> DNDarray:
    """``x`` broadcast to ``shape``; the split shifts by the new leading
    axes.  A split axis of length 1 that broadcasts is gathered first (its
    one row) and the result cut to chunks."""
    shape = sanitize_shape(shape)
    lead = len(shape) - x.ndim
    split = x.split + lead if x.split is not None else None
    if x.is_distributed() and x.gshape[x.split] != shape[split]:
        return _scatter_chunk(x, _full(x).broadcast_to(shape), shape, split)
    lshape = list(shape)
    if x.is_distributed():
        lshape[split] = x.lshape[x.split]
    t = x.larray.broadcast_to(lshape).clone(memory_format=torch.contiguous_format)
    if not x.is_distributed() and split is not None and x.comm.is_distributed():
        return _scatter_chunk(x, t, shape, split)
    return _local(x, t, shape, split)


def broadcast_arrays(*arrays) -> List[DNDarray]:
    """The arrays broadcast against each other."""
    proto = _proto(arrays)
    arrays = [_dnd(a, proto) for a in arrays]
    shape = tuple(torch.broadcast_shapes(*[a.gshape for a in arrays]))
    return [broadcast_to(a, shape) for a in arrays]


def moveaxis(x: DNDarray, source, destination) -> DNDarray:
    """Axes moved (each rank permutes its chunk; the split moves with its axis)."""
    from ..linalg.basics import transpose

    src = [s % x.ndim for s in np.atleast_1d(source)]
    dst = [d % x.ndim for d in np.atleast_1d(destination)]
    order = [a for a in range(x.ndim) if a not in src]
    for d, s in sorted(zip(dst, src)):
        order.insert(d, s)
    return transpose(x, order)


def swapaxes(x: DNDarray, axis1: int, axis2: int) -> DNDarray:
    from ..linalg.basics import transpose

    a1, a2 = sanitize_axis(x.shape, axis1), sanitize_axis(x.shape, axis2)
    order = list(range(x.ndim))
    order[a1], order[a2] = order[a2], order[a1]
    return transpose(x, order)


def permute_dims(a: DNDarray, axes=None) -> DNDarray:
    """The array-API name of ``transpose``."""
    from ..linalg.basics import transpose

    return transpose(a, axes)


def matrix_transpose(a: DNDarray) -> DNDarray:
    """The last two axes swapped."""
    if a.ndim < 2:
        raise ValueError("matrix_transpose requires ndim >= 2")
    return swapaxes(a, -1, -2)


def rollaxis(a: DNDarray, axis: int, start: int = 0) -> DNDarray:
    axis = sanitize_axis(a.shape, axis)
    if start < 0:
        start += a.ndim
    return moveaxis(a, axis, start if start <= axis else start - 1)


# ---------------------------------------------------------------------- #
# joins and splits
# ---------------------------------------------------------------------- #
def _overlap(a0: int, a1: int, b0: int, b1: int) -> int:
    return builtins.max(builtins.min(a1, b1) - builtins.max(a0, b0), 0)


def _join(arrays: List[DNDarray], axis: int, split: Optional[int]) -> DNDarray:
    """The arrays (one ndim) concatenated along ``axis`` into a result split
    along ``split``.  Along another axis each rank joins its chunks (the
    operands brought to ``split``'s chunks first); along the split axis each
    operand's rows go to the ranks whose result chunk holds them, one
    exchange an operand (a replicated operand is cut locally)."""
    proto = arrays[0]
    comm, rank = proto.comm, proto.comm.rank
    dt = arrays[0].larray.dtype
    for a in arrays[1:]:
        dt = torch.promote_types(dt, a.larray.dtype)
    gshape = list(arrays[0].gshape)
    gshape[axis] = builtins.sum(a.gshape[axis] for a in arrays)
    gshape = tuple(gshape)
    if split is None or not comm.is_distributed():
        t = torch.cat([_full(a).to(dt) for a in arrays], dim=axis)
        return _wrap(t, gshape, split, proto)
    if split != axis:
        parts = []
        for a in arrays:
            a = _to_split(a, split)
            if not a.balanced:
                a = a.resplit(None).resplit(split) if not a.is_distributed() else _balanced(a)
            parts.append(a.larray.to(dt))
        return _wrap(torch.cat(parts, dim=axis), gshape, split, proto)
    counts, displs = comm.counts_displs_shape(gshape, axis)
    lo, hi = displs[rank], displs[rank] + counts[rank]
    parts, off = [], 0
    for a in arrays:
        n = a.gshape[axis]
        if not a.is_distributed():
            s0, s1 = builtins.min(builtins.max(lo - off, 0), n), builtins.min(hi - off, n)
            parts.append(a.larray.narrow(axis, s0, builtins.max(s1 - s0, 0)).to(dt))
        else:
            a = a if a.split == axis else a.resplit(axis)
            ac, ad = a.counts_displs()
            mine0 = off + ad[rank]
            send = [_overlap(mine0, mine0 + ac[rank], displs[q], displs[q] + counts[q]) for q in range(comm.size)]
            recv = [_overlap(off + ad[s], off + ad[s] + ac[s], lo, hi) for s in range(comm.size)]
            t = a.larray.to(dt)
            shapes = [[c if i == axis else s for i, s in enumerate(t.shape)] for c in recv]
            parts.append(torch.cat(comm.exchange(list(torch.split(t, send, dim=axis)), shapes, t), dim=axis))
        off += n
    return _wrap(torch.cat(parts, dim=axis), gshape, axis, proto)


def _balanced(a: DNDarray) -> DNDarray:
    b = DNDarray(a.larray, a.gshape, a.dtype, a.split, a.device, a.comm, a.balanced)
    b.balance_()
    return b


def _first_split(arrays) -> Optional[int]:
    return next((a.split for a in arrays if isinstance(a, DNDarray) and a.split is not None), None)


def concatenate(arrays, axis: int = 0) -> DNDarray:
    """Arrays joined along an existing axis; the first split operand's split wins."""
    arrays = list(arrays)
    proto = _proto(arrays)
    arrays = [_dnd(a, proto) for a in arrays]
    axis = sanitize_axis(proto.shape, axis)
    for a in arrays:
        if a.ndim != proto.ndim or any(a.gshape[i] != proto.gshape[i] for i in range(a.ndim) if i != axis):
            raise ValueError("all the input array dimensions except for the concatenation axis must match exactly")
    return _join(arrays, axis, _first_split(arrays))


concat = concatenate


def stack(arrays, axis: int = 0, out: Optional[DNDarray] = None) -> DNDarray:
    """Arrays joined along a new axis; the first DNDarray's split (shifted) wins."""
    arrays = list(arrays)
    proto = _proto(arrays)
    arrays = [_dnd(a, proto) for a in arrays]
    nd = proto.ndim + 1
    axis = axis % nd
    split = proto.split + 1 if proto.split is not None and axis <= proto.split else proto.split
    res = _join([expand_dims(a, axis) for a in arrays], axis, split)
    if out is not None:
        out.larray.copy_(res.larray)
        return out
    return res


def _stack_split(arrays, promoted: dict) -> Optional[int]:
    """The first split operand's split, moved where its promotion (ndim ->
    split) sends it."""
    for a in arrays:
        if isinstance(a, DNDarray) and a.split is not None:
            return promoted.get(a.ndim, {}).get(a.split, a.split)
    return None


def hstack(arrays) -> DNDarray:
    arrays = list(arrays)
    proto = _proto(arrays)
    arrays = [atleast_1d(_dnd(a, proto)) for a in arrays]
    axis = 0 if arrays[0].ndim == 1 else 1
    return _join(arrays, axis, _first_split(arrays))


def vstack(arrays) -> DNDarray:
    arrays = list(arrays)
    proto = _proto(arrays)
    split = _stack_split(arrays, {1: {0: 1}})
    return _join([atleast_2d(_dnd(a, proto)) for a in arrays], 0, split)


row_stack = vstack


def dstack(arrays) -> DNDarray:
    arrays = list(arrays)
    proto = _proto(arrays)
    split = _stack_split(arrays, {1: {0: 1}})
    return _join([atleast_3d(_dnd(a, proto)) for a in arrays], 2, split)


def column_stack(arrays) -> DNDarray:
    arrays = list(arrays)
    proto = _proto(arrays)
    cols = []
    for a in arrays:
        a = _dnd(a, proto)
        cols.append(expand_dims(a, 1) if a.ndim == 1 else a)
    return _join(cols, 1, _first_split(arrays))


def split(x: DNDarray, indices_or_sections, axis: int = 0) -> List[DNDarray]:
    """Parts along ``axis`` (numpy's rules).  Parts along the split axis are
    replicated, as the reference's are (the array is gathered); along
    another axis each rank cuts its chunk."""
    axis = sanitize_axis(x.shape, axis)
    n = x.gshape[axis]
    if isinstance(indices_or_sections, DNDarray):
        indices_or_sections = indices_or_sections.numpy()
    if isinstance(indices_or_sections, (list, tuple, np.ndarray)):
        bounds = [builtins.min(builtins.max(int(b) + (n if int(b) < 0 else 0), 0), n) for b in
                  np.asarray(indices_or_sections).ravel()]
    else:
        sec = int(indices_or_sections)
        if sec <= 0 or n % sec:
            raise ValueError("array split does not result in an equal division")
        bounds = [n // sec * i for i in range(1, sec)]
    edges = [0] + bounds + [n]
    src = x
    if x.split == axis and x.is_distributed():
        _warn_implicit_gather("split", x)
        src = x.resplit(None)
    out_split = None if axis == x.split else x.split
    res = []
    for a, b in zip(edges[:-1], edges[1:]):
        b = builtins.max(a, b)
        t = src.larray.narrow(axis, a, b - a).clone(memory_format=torch.contiguous_format)
        gshape = tuple(b - a if i == axis else s for i, s in enumerate(x.gshape))
        res.append(_wrap(t, gshape, out_split, x, src.balanced if out_split is not None else True))
    return res


def array_split(x: DNDarray, indices_or_sections, axis: int = 0) -> List[DNDarray]:
    """:func:`split` where the sections need not divide the axis."""
    axis = sanitize_axis(x.shape, axis)
    if isinstance(indices_or_sections, DNDarray):
        indices_or_sections = indices_or_sections.numpy()
    if isinstance(indices_or_sections, (list, tuple, np.ndarray)):
        return split(x, indices_or_sections, axis)
    n = int(indices_or_sections)
    if n <= 0:
        raise ValueError("number of sections must be larger than 0")
    length = x.shape[axis]
    sizes = [length // n + (1 if i < length % n else 0) for i in range(n)]
    return split(x, list(np.cumsum(sizes)[:-1]), axis)


def dsplit(x: DNDarray, indices_or_sections) -> List[DNDarray]:
    return split(x, indices_or_sections, axis=2)


def hsplit(x: DNDarray, indices_or_sections) -> List[DNDarray]:
    return split(x, indices_or_sections, axis=0 if x.ndim < 2 else 1)


def vsplit(x: DNDarray, indices_or_sections) -> List[DNDarray]:
    return split(x, indices_or_sections, axis=0)


def _take_axis(x: DNDarray, idx, axis: int, split: Optional[int] = None) -> DNDarray:
    """``x`` at the int indices ``idx`` (1-D) along ``axis``.  Along the
    split axis the result keeps that split: each rank builds its chunk from
    the rows it names, those another rank holds coming by one exchange."""
    idx = torch.as_tensor(np.asarray(idx) if not isinstance(idx, torch.Tensor) else idx,
                          dtype=torch.int64, device=x.larray.device).reshape(-1)
    key = (slice(None),) * axis + (idx,)
    if x.is_distributed() and x.split == axis:
        k = x._key(key)
        k.split = axis
        res = x._take(k)
    else:
        res = x[key]
    return _to_split(res, x.split if split is None else split)


def _values_block(values, x: DNDarray, axis: int, n: int, scalar_obj: bool) -> DNDarray:
    """numpy ``insert``'s block of values for ``n`` slots along ``axis``."""
    v = _full(values) if isinstance(values, DNDarray) else torch.as_tensor(np.asarray(values), device=x.larray.device)
    v = v.to(x.larray.dtype)
    if scalar_obj:
        while v.ndim < x.ndim:
            v = v.unsqueeze(0)
        v = v.movedim(0, axis)
        n = v.shape[axis] if v.ndim == x.ndim else n
    shape = tuple(n if i == axis else s for i, s in enumerate(x.gshape))
    v = v.broadcast_to(shape).contiguous()
    return _wrap(v, shape, None, x)


def insert(x: DNDarray, obj, values, axis: Optional[int] = None) -> DNDarray:
    """Values inserted before the indices ``obj`` along ``axis`` (numpy's
    rules; flattened for None): the values block joined to ``x``, then
    taken in numpy's order."""
    if axis is None:
        x, axis, out_split = flatten(x), 0, (0 if x.split is not None else None)
    else:
        axis = sanitize_axis(x.shape, axis)
        out_split = x.split
    if isinstance(obj, DNDarray):
        obj = obj.numpy()
    L = x.gshape[axis]
    scalar = np.ndim(obj) == 0 and not isinstance(obj, slice)
    if isinstance(obj, slice):
        obj = np.arange(*obj.indices(L))
    n = 1 if scalar else len(np.atleast_1d(obj))
    block = _values_block(values, x, axis, n, scalar)
    n = block.gshape[axis]
    order = np.insert(np.arange(L), int(obj) if scalar else obj, np.arange(L, L + n))
    joined = _join([x, block], axis, x.split)
    return _take_axis(joined, order, axis, out_split)


def delete(x: DNDarray, obj, axis: Optional[int] = None) -> DNDarray:
    """Sub-arrays at ``obj`` removed along ``axis`` (flattened for None)."""
    if axis is None:
        x, axis, out_split = flatten(x), 0, (0 if x.split is not None else None)
    else:
        axis = sanitize_axis(x.shape, axis)
        out_split = x.split
    if isinstance(obj, DNDarray):
        obj = obj.numpy()
    keep = np.delete(np.arange(x.gshape[axis]), obj)
    return _take_axis(x, keep, axis, out_split)


def append(arr: DNDarray, values, axis: Optional[int] = None) -> DNDarray:
    """Values appended (both raveled where ``axis`` is None)."""
    values = _dnd(values, arr)
    if axis is None:
        out_split = 0 if arr.split is not None else None
        return _join([flatten(arr), flatten(values)], 0, out_split)
    axis = sanitize_axis(arr.shape, axis)
    return _join([arr, values], axis, arr.split)


# ---------------------------------------------------------------------- #
# movement
# ---------------------------------------------------------------------- #
def flip(x: DNDarray, axis=None) -> DNDarray:
    """Order reversed along ``axis`` (all axes for None): a local flip, and
    along the split axis the indexing core's exchange of the rows that
    change rank."""
    axes = range(x.ndim) if axis is None else [a % x.ndim for a in np.atleast_1d(axis)]
    axes = sorted(set(int(a) for a in axes))
    if not x.is_distributed() or x.split not in axes:
        return _local(x, x.larray.flip(axes) if axes else x.larray.clone(), x.gshape, x.split)
    key = tuple(slice(None, None, -1) if i in axes else slice(None) for i in range(x.ndim))
    return _to_split(x[key], x.split)


def fliplr(x: DNDarray) -> DNDarray:
    return flip(x, 1)


def flipud(x: DNDarray) -> DNDarray:
    return flip(x, 0)


def rot90(x: DNDarray, k: int = 1, axes=(0, 1)) -> DNDarray:
    """Rotation by 90 degrees ``k`` times in the plane of ``axes`` (numpy's)."""
    a0, a1 = (a % x.ndim for a in axes)
    if a0 == a1:
        raise ValueError("Axes must be different.")
    k %= 4
    if k == 0:
        return _local(x, x.larray.clone(), x.gshape, x.split)
    if k == 2:
        return flip(flip(x, a0), a1)
    order = list(range(x.ndim))
    order[a0], order[a1] = order[a1], order[a0]
    from ..linalg.basics import transpose

    if k == 1:
        return transpose(flip(x, a1), order)
    return flip(transpose(x, order), a1)


def roll(x: DNDarray, shift, axis=None) -> DNDarray:
    """Elements rolled by ``shift`` along ``axis`` (the flattened array for
    None).  Along the split axis only the rows that cross a rank boundary
    move."""
    if axis is None:
        return reshape(roll(flatten(x), shift, 0), x.gshape, new_split=x.split)
    shifts = np.atleast_1d(shift)
    axes = np.atleast_1d(axis)
    shifts, axes = np.broadcast_arrays(shifts, axes)
    res = x
    for s, a in zip(shifts.tolist(), axes.tolist()):
        a = a % x.ndim
        n = x.gshape[a]
        if not res.is_distributed() or res.split != a:
            res = _local(res, torch.roll(res.larray, int(s), a), res.gshape, res.split)
        elif n:
            idx = (torch.arange(n, dtype=torch.int64, device=x.larray.device) - int(s)) % n
            res = _take_axis(res, idx, a)
    return res if res is not x else _local(x, x.larray.clone(), x.gshape, x.split)


def pad(x: DNDarray, pad_width, mode: str = "constant", constant_values=0) -> DNDarray:
    """``x`` padded (numpy's ``pad_width`` and modes).  A constant pad of the
    split axis joins the pad blocks to the rows (each row moves at most to
    the neighbouring ranks that the shift sends it); the other modes take
    rows by numpy's index map along each axis, through the indexing core
    along the split axis."""
    nd = x.ndim
    pw = np.broadcast_to(np.asarray(pad_width, dtype=np.int64), (nd, 2)) if np.ndim(pad_width) < 2 else \
        np.asarray(pad_width, dtype=np.int64)
    pw = np.broadcast_to(pw, (nd, 2))
    res = x
    if mode == "constant":
        cv = np.broadcast_to(np.asarray(constant_values), (nd, 2))
        for a in range(nd):
            b, e = int(pw[a, 0]), int(pw[a, 1])
            if b == 0 and e == 0:
                continue
            parts = []
            for w, v in ((b, cv[a, 0]), (None, None), (e, cv[a, 1])):
                if w is None:
                    parts.append(res)
                elif w:
                    shp = tuple(w if i == a else s for i, s in enumerate(res.gshape))
                    blk = torch.full(shp, float(v) if res.larray.is_floating_point() else v,
                                     dtype=res.larray.dtype, device=res.larray.device)
                    parts.append(_wrap(blk, shp, None, res))
            if res.is_distributed() and res.split != a:  # every rank pads its own chunk
                t = res.larray
                pieces = []
                for w, v in ((b, cv[a, 0]), (None, None), (e, cv[a, 1])):
                    if w is None:
                        pieces.append(t)
                    elif w:
                        shp = [w if i == a else s for i, s in enumerate(t.shape)]
                        pieces.append(torch.full(shp, v.item() if hasattr(v, "item") else v, dtype=t.dtype,
                                                 device=t.device))
                gshape = tuple(s + b + e if i == a else s for i, s in enumerate(res.gshape))
                res = _local(res, torch.cat(pieces, dim=a), gshape, res.split)
            else:
                res = _join(parts, a, res.split)
        return res if res is not x else _local(x, x.larray.clone(), x.gshape, x.split)
    np_mode = {"edge": "edge", "reflect": "reflect", "symmetric": "symmetric", "wrap": "wrap"}.get(mode)
    if np_mode is None:
        raise ValueError(f"mode {mode!r} is not supported")
    for a in range(nd):
        b, e = int(pw[a, 0]), int(pw[a, 1])
        if b or e:
            idx = np.pad(np.arange(res.gshape[a]), (b, e), mode=np_mode)
            res = _take_axis(res, idx, a)
    return res if res is not x else _local(x, x.larray.clone(), x.gshape, x.split)


def repeat(x: DNDarray, repeats, axis: Optional[int] = None) -> DNDarray:
    """Each element repeated (numpy's ``repeat``; flattened for None).  The
    split axis's order is kept, so each rank repeats its own rows and
    nothing moves (the result may be unbalanced)."""
    if axis is None:
        x, axis = flatten(x), 0
    axis = sanitize_axis(x.shape, axis)
    if isinstance(repeats, DNDarray):
        repeats = repeats.numpy()
    reps = np.asarray(repeats, dtype=np.int64)
    n = x.gshape[axis]
    if reps.ndim and reps.size != 1 and reps.size != n:
        raise ValueError("repeats must broadcast to the axis length")
    reps_full = np.broadcast_to(reps.reshape(-1) if reps.ndim else reps, (n,)).copy()
    total = int(reps_full.sum())
    gshape = tuple(total if i == axis else s for i, s in enumerate(x.gshape))
    mine = reps_full
    if x.is_distributed() and x.split == axis:
        c, d = x.counts_displs()
        mine = reps_full[d[x.comm.rank]:d[x.comm.rank] + c[x.comm.rank]]
        t = torch.repeat_interleave(x.larray, torch.as_tensor(mine, device=x.larray.device), dim=axis)
        counts = [int(reps_full[dd:dd + cc].sum()) for cc, dd in zip(c, d)]
        balanced = counts == list(x.comm.counts_displs_shape(gshape, axis)[0])
        return _wrap(t, gshape, axis, x, balanced)
    t = torch.repeat_interleave(x.larray, torch.as_tensor(mine, device=x.larray.device), dim=axis)
    return _local(x, t, gshape, x.split)


def tile(x: DNDarray, reps) -> DNDarray:
    """``x`` tiled ``reps`` times (numpy's ``tile``); the split shifts by the
    new leading axes.  Copies along the split axis are joined by
    :func:`concatenate`'s exchange; along the others each rank tiles its chunk."""
    reps = tuple(int(r) for r in np.atleast_1d(reps))
    nd = builtins.max(len(reps), x.ndim)
    reps = (1,) * (nd - len(reps)) + reps
    while x.ndim < nd:
        x = expand_dims(x, 0)
    local = [1 if (x.is_distributed() and i == x.split) else r for i, r in enumerate(reps)]
    y = _local(x, x.larray.repeat(*local), tuple(s * l for s, l in zip(x.gshape, local)), x.split)
    if x.is_distributed() and reps[x.split] != 1:
        y = _join([y] * reps[x.split], x.split, x.split)
    return y


def resize(a: DNDarray, new_shape) -> DNDarray:
    """numpy's ``resize`` (the flattened array repeated cyclically),
    replicated as the reference's is."""
    new_shape = sanitize_shape(new_shape)
    _warn_implicit_gather("resize", a)
    flat = _full(a).reshape(-1)
    n = math.prod(new_shape)
    t = flat.repeat(-(-n // builtins.max(flat.numel(), 1)))[:n] if flat.numel() else flat.new_zeros(n)
    return _wrap(t.reshape(new_shape).contiguous(), new_shape, None, a)


def unfold(x: DNDarray, axis: int, size: int, step: int = 1) -> DNDarray:
    """Windows of ``size`` every ``step`` along ``axis``, the window as a new
    last axis (torch's ``unfold``); along the split axis each rank fetches
    the rows of its windows, a halo from the next ranks."""
    axis = sanitize_axis(x.shape, axis)
    if size < 1 or step < 1:
        raise ValueError("size and step must be >= 1")
    n = x.shape[axis]
    if size > n:
        raise ValueError(f"size {size} exceeds axis length {n}")
    if not x.is_distributed() or x.split != axis:
        nw = (n - size) // step + 1
        gshape = tuple(nw if i == axis else s for i, s in enumerate(x.gshape)) + (size,)
        return _local(x, x.larray.unfold(axis, size, step).contiguous(), gshape, x.split)
    nw = (n - size) // step + 1
    starts = torch.arange(nw, dtype=torch.int64, device=x.larray.device) * step
    idx = (starts[:, None] + torch.arange(size, device=x.larray.device)[None, :])
    rows = _take_axis(x, idx.reshape(-1), axis)  # (.., nw * size, ..) split along axis
    w = reshape(rows, x.gshape[:axis] + (nw, size) + x.gshape[axis + 1:], new_split=axis)
    return moveaxis(w, axis + 1, -1)


def diagonal(x: DNDarray, offset: int = 0, dim1: int = 0, dim2: int = 1) -> DNDarray:
    """The diagonal of the ``dim1``/``dim2`` planes, as a last axis.  Split
    along one of the two, each rank takes the diagonal entries it holds and
    the ranks gather them (the reference's result is replicated then);
    split elsewhere, each rank takes its chunk's diagonals."""
    d1, d2 = dim1 % x.ndim, dim2 % x.ndim
    rest = [s for i, s in enumerate(x.gshape) if i not in (d1, d2)]
    n1, n2 = x.gshape[d1], x.gshape[d2]
    m = builtins.max(0, builtins.min(n1, n2 - offset) if offset >= 0 else builtins.min(n1 + offset, n2))
    gshape = tuple(rest) + (m,)
    if not x.is_distributed():
        t = torch.diagonal(x.larray, offset, d1, d2).clone(memory_format=torch.contiguous_format)
        split = None if x.split in (d1, d2) or x.split is None else 0
        return _wrap(t, gshape, split, x)
    if x.split in (d1, d2):
        off = x.counts_displs()[1][x.comm.rank]
        shift = off if x.split == d1 else -off
        t = torch.diagonal(x.larray, offset + shift, d1, d2).contiguous()
        counts = x.comm._extents(t, -1)
        t = x.comm.Allgatherv(t, t.ndim - 1, counts=counts)
        return _wrap(t.contiguous(), gshape, None, x)
    t = torch.diagonal(x.larray, offset, d1, d2).clone(memory_format=torch.contiguous_format)
    s = x.split - builtins.sum(1 for d in (d1, d2) if d < x.split)
    y = _wrap(t, gshape, s, x, x.balanced)
    return _to_split(y, 0)


def diag(x: DNDarray, offset: int = 0) -> DNDarray:
    """A 1-D array's diagonal matrix, or a 2-D array's diagonal; split 0
    where ``x`` is split."""
    if x.ndim == 2:
        return _to_split(diagonal(x, offset), 0 if x.split is not None else None)
    if x.ndim != 1:
        raise ValueError("Input must be 1- or 2-d.")
    n = x.gshape[0] + builtins.abs(offset)
    if not x.is_distributed():
        t = torch.diag(x.larray, offset)
        return _wrap(t, (n, n), 0 if x.split is not None else None, x)
    d = pad(x, (0, offset) if offset >= 0 else (-offset, 0))  # row r's entry, in the rows' layout
    c, dd = d.counts_displs()
    r0 = dd[x.comm.rank]
    rows = torch.arange(r0, r0 + c[x.comm.rank], device=x.larray.device)
    cols = rows + offset
    ok = (cols >= 0) & (cols < n)
    t = torch.zeros((c[x.comm.rank], n), dtype=x.larray.dtype, device=x.larray.device)
    t[(rows - r0)[ok], cols[ok]] = d.larray[ok]
    return _wrap(t, (n, n), 0, x)


def diagflat(v, k: int = 0) -> DNDarray:
    """The flattened input on diagonal ``k`` of a square matrix."""
    if not isinstance(v, DNDarray):
        raise TypeError("diagflat needs a DNDarray input")
    return diag(flatten(v), k)


def fill_diagonal(a: DNDarray, val, wrap: bool = False) -> None:
    """numpy's ``fill_diagonal``, in place: the flat positions ``0, step,
    2 step, ...`` (``step`` = 1 + the sum of the strides' cumulative
    products) set to ``val`` (cycled), each rank writing those it holds."""
    if a.ndim < 2:
        raise ValueError("array must be at least 2-d")
    if a.ndim == 2:
        step = a.gshape[1] + 1
        end = None if wrap else a.gshape[1] * a.gshape[1]
    else:
        if len(set(a.gshape)) != 1:
            raise ValueError("All dimensions of input must be of equal length")
        step = 1 + int(np.cumprod(a.gshape[:-1]).sum())
        end = None
    stop = a.size if end is None else builtins.min(end, a.size)
    put(a, np.arange(0, stop, step), val)


def resplit(x: DNDarray, axis: Optional[int] = None, memory_budget=None) -> DNDarray:
    """A copy of ``x`` split along ``axis`` (None: replicated); past
    ``memory_budget`` bytes it streams as K tiled collectives
    (``core.redistribution``)."""
    return x.resplit(axis, memory_budget)


def redistribute(x: DNDarray, lshape_map=None, target_map=None) -> DNDarray:
    """A copy of ``x`` with its rows moved to ``target_map``'s layout."""
    out = DNDarray(x.larray.clone(), x.gshape, x.dtype, x.split, x.device, x.comm, x.balanced)
    out.redistribute_(lshape_map, target_map)
    return out


def balance(x: DNDarray, copy: bool = False) -> DNDarray:
    """``x`` in ``chunk``'s layout: balanced in place (or a balanced copy)."""
    if copy:
        x = DNDarray(x.larray.clone(), x.gshape, x.dtype, x.split, x.device, x.comm, x.balanced)
    x.balance_()
    return x


def collect(x: DNDarray, target_rank: int = 0) -> DNDarray:
    """The whole array on every rank (the reference replicates it)."""
    return x.resplit(None)


def shuffle(x: DNDarray) -> DNDarray:
    """Rows permuted along axis 0 by ``random.permutation``'s stream; along
    the split axis only the rows that change rank move."""
    from . import random as ht_random

    perm = ht_random.permutation(x.shape[0], split=0 if x.split == 0 else None, device=x.device, comm=x.comm)
    return _take_axis(x, perm.resplit(None).larray if perm.is_distributed() else perm.larray, 0)


def astype(x: DNDarray, dtype, copy: bool = True) -> DNDarray:
    """``x`` cast to ``dtype``."""
    return x.astype(dtype, copy=copy)


def ascontiguousarray(a, dtype=None) -> DNDarray:
    """``a`` as a DNDarray (every local tensor is contiguous), cast to ``dtype``."""
    res = a if isinstance(a, DNDarray) else factories.array(a)
    return res.astype(dtype) if dtype is not None else res.astype(res.dtype)


asfortranarray = ascontiguousarray


def array2string(a: DNDarray, *args, **kwargs) -> str:
    """numpy's ``array2string`` of ``a``; a large array prints its edges
    only, which the ranks gather (``printing``)."""
    from . import printing

    opt = printing.get_printoptions()
    threshold = kwargs.get("threshold", opt["threshold"])
    if a.size > threshold:
        with np.printoptions(threshold=0, edgeitems=kwargs.get("edgeitems", opt["edgeitems"])):
            return np.array2string(printing._edges(a), *args, **kwargs)
    return np.array2string(a.numpy(), *args, **kwargs)


def array_str(a: DNDarray) -> str:
    return str(a)


def array_repr(a: DNDarray) -> str:
    return repr(a)


# ---------------------------------------------------------------------- #
# selection
# ---------------------------------------------------------------------- #
def take(a: DNDarray, indices, axis: Optional[int] = None) -> DNDarray:
    """Elements at global ``indices`` along ``axis`` (of the flattened array
    for None), numpy's; the split is the reference's.  Along the split axis
    each rank builds its chunk, the rows it lacks by one exchange."""
    idx = indices.numpy() if isinstance(indices, DNDarray) else np.asarray(indices)
    if axis is None:
        flat = flatten(a)
        res = _take_axis(flat, idx.reshape(-1), 0)
        res = reshape(res, idx.shape, new_split=0 if a.split is not None and idx.ndim else None)
        return _to_split(res, 0 if a.split is not None and idx.ndim else None)
    axis = sanitize_axis(a.shape, axis)
    n = a.gshape[axis]
    if a.split is None or a.split < axis:
        split = a.split
    elif a.split == axis:
        split = axis if idx.ndim >= 1 else None
    else:
        split = a.split + idx.ndim - 1
    res = _take_axis(a, np.where(idx < 0, idx + n, idx).reshape(-1), axis, a.split)
    shape = a.gshape[:axis] + idx.shape + a.gshape[axis + 1:]
    if res.gshape != shape:
        res = reshape(res, shape, new_split=split)
    return _to_split(res, split)


def _coords_key(a: DNDarray, indices: torch.Tensor, axis: int):
    """numpy's index tuple of ``take_along_axis``: ``indices`` on ``axis``,
    aranges broadcast on the others."""
    key = []
    for d in range(a.ndim):
        if d == axis:
            key.append(indices)
        else:
            shp = [1] * a.ndim
            shp[d] = a.gshape[d]
            key.append(torch.arange(a.gshape[d], device=indices.device).reshape(shp))
    return tuple(key)


def take_along_axis(a: DNDarray, indices, axis: int) -> DNDarray:
    """numpy's ``take_along_axis``; ``a``'s split.  Off the split axis each
    rank takes from its chunk; along it the indexing core's exchange."""
    axis = sanitize_axis(a.shape, axis)
    dev = a.larray.device
    if isinstance(indices, DNDarray):
        ind_d = indices
    else:
        ind_d = factories.array(np.asarray(indices), device=a.device, comm=a.comm)
    if not a.is_distributed():
        t = torch.take_along_dim(a.larray, _full(ind_d).to(dev, torch.int64) % builtins.max(a.gshape[axis], 1),
                                 dim=axis)
        return _wrap(t, tuple(t.shape), a.split if a.split is not None and a.split < t.ndim else None, a)
    if a.split != axis and ind_d.gshape[a.split] == a.gshape[a.split]:
        ind = _to_split(ind_d, a.split)
        if ind.balanced and a.balanced or ind.lshape[a.split] == a.lshape[a.split]:
            t = torch.take_along_dim(a.larray, ind.larray.to(torch.int64) % builtins.max(a.gshape[axis], 1),
                                     dim=axis)
            return _wrap(t, ind.gshape, a.split, a, a.balanced)
    ind = _full(ind_d).to(dev, torch.int64) % builtins.max(a.gshape[axis], 1)
    res = a[_coords_key(a, ind, axis)]
    return _to_split(res, a.split)


def put(a: DNDarray, ind, v, mode: str = "raise") -> None:
    """numpy's ``put``, in place: the flat positions ``ind`` set to ``v``
    (cycled); each rank writes the positions it holds (the last of equal
    positions wins)."""
    dev = a.larray.device
    ji = torch.as_tensor(ind.numpy() if isinstance(ind, DNDarray) else np.asarray(ind), device=dev).reshape(-1)
    ji = ji.to(torch.int64)
    jv = (_full(v) if isinstance(v, DNDarray) else torch.as_tensor(np.asarray(v), device=dev)).reshape(-1)
    n = a.size
    if mode == "raise":
        if ji.numel() and (int(ji.min()) < -n or int(ji.max()) >= n):
            raise IndexError(f"index out of range for array of size {n}")
        ji = torch.where(ji < 0, ji + n, ji)
    elif mode == "wrap":
        ji = ji % n
    elif mode == "clip":
        ji = ji.clamp(0, n - 1)
    else:
        raise ValueError(f"mode must be raise/wrap/clip, got {mode!r}")
    if ji.numel() == 0:
        return
    jv = jv.repeat(-(-ji.numel() // jv.numel()))[: ji.numel()].to(a.larray.dtype)
    # the last write of a position wins, as numpy's
    rev = torch.flip(torch.arange(ji.numel(), device=dev), [0])
    uniq, first = torch.unique(ji.flip(0), return_inverse=True)
    keep = torch.full((uniq.numel(),), -1, dtype=torch.int64, device=dev).scatter_reduce(0, first, rev, "amax")
    ji, jv = ji[keep], jv[keep]
    t = a.larray
    if a.is_distributed():
        c, d = a.counts_displs()
        coords = list(np.unravel_index(ji.cpu().numpy(), a.gshape))
        s = a.split
        rank = a.comm.rank
        mine = (coords[s] >= d[rank]) & (coords[s] < d[rank] + c[rank])
        coords[s] = coords[s] - d[rank]
        local = [torch.as_tensor(cc[mine], device=dev) for cc in coords]
        t[tuple(local)] = jv[torch.as_tensor(mine, device=dev)]
    else:
        t.view(-1)[ji] = jv


def put_along_axis(arr: DNDarray, indices, values, axis: int) -> None:
    """numpy's ``put_along_axis``, in place, through :func:`put`'s flat positions."""
    axis = sanitize_axis(arr.shape, axis)
    ind = indices.numpy() if isinstance(indices, DNDarray) else np.asarray(indices)
    grids = np.meshgrid(*[np.arange(s) for s in ind.shape], indexing="ij")
    coords = [g if d != axis else ind % arr.gshape[axis] for d, g in enumerate(grids)]
    flat = np.ravel_multi_index(tuple(np.broadcast_arrays(*coords)), arr.gshape)
    vals = values.numpy() if isinstance(values, DNDarray) else np.asarray(values)
    put(arr, flat.reshape(-1), np.broadcast_to(vals, flat.shape).reshape(-1))


def place(arr: DNDarray, mask, vals) -> None:
    """numpy's ``place``, in place: the masked elements set to ``vals``
    cycled over them, each rank writing its own."""
    m = mask if isinstance(mask, DNDarray) else factories.array(np.asarray(mask, dtype=bool), device=arr.device,
                                                                  comm=arr.comm)
    count = _count_true(m)
    v = np.asarray(vals.numpy() if isinstance(vals, DNDarray) else vals).reshape(-1)
    if count == 0:
        return
    if v.size == 0:
        raise ValueError("Cannot insert from an empty array!")
    arr[m] = np.resize(v, count).astype(np.float64 if v.dtype.kind == "f" else v.dtype)


def _count_true(m: DNDarray) -> int:
    n = int(m.larray.sum())
    if m.is_distributed():
        n = int(m.comm.Allreduce(torch.tensor([n], dtype=torch.int64, device=m.larray.device)).item())
    return n


def _cycled_local(a: DNDarray, values) -> torch.Tensor:
    """``values`` cycled over ``a``'s flat positions, this rank's chunk."""
    dev = a.larray.device
    v = (_full(values) if isinstance(values, DNDarray) else torch.as_tensor(np.asarray(values), device=dev))
    v = v.reshape(-1).to(a.larray.dtype)
    if v.numel() == 0:
        return a.larray
    c = a.counts_displs() if a.split is not None else None
    off, cnt = (c[1][a.comm.rank], c[0][a.comm.rank]) if c is not None else (0, a.gshape[0] if a.ndim else 1)
    flat = _flat_indices(a.gshape, a.split if a.is_distributed() else None, off, cnt, dev) if a.ndim else \
        torch.zeros(1, dtype=torch.int64, device=dev)
    return v[flat % v.numel()].reshape(a.lshape)


def putmask(a: DNDarray, mask, values) -> None:
    """numpy's ``putmask``, in place: where ``mask``, the value at the same
    flat position of ``values`` cycled over ``a``."""
    m = _local_like(a, mask)
    a.larray.copy_(torch.where(m, _cycled_local(a, values), a.larray))


def _local_like(a: DNDarray, m) -> torch.Tensor:
    """This rank's part of ``m`` (``a``'s shape or broadcasting to it)."""
    from .statistics import _local_part

    if not isinstance(m, DNDarray):
        m = torch.as_tensor(np.asarray(m), device=a.larray.device).broadcast_to(a.gshape)
    elif m.gshape != a.gshape:
        m = _full(m).broadcast_to(a.gshape)
    return _local_part(m, a).to(a.larray.device).to(torch.bool)


def copyto(dst: DNDarray, src, casting: str = "same_kind", where=True) -> None:
    """``src`` broadcast into ``dst``, in place (where ``where``)."""
    s = _dnd(src, dst)
    s = broadcast_to(s, dst.gshape) if s.gshape != dst.gshape else s
    from .statistics import _local_part

    v = _local_part(s, dst).to(dst.larray.dtype)
    if where is True:
        dst.larray.copy_(v)
    else:
        dst.larray.copy_(torch.where(_local_like(dst, where), v, dst.larray))


def compress(condition, a: DNDarray, axis: Optional[int] = None) -> DNDarray:
    """Slices where ``condition`` holds (flattened for None): a boolean mask,
    so the split axis's order is kept and nothing moves."""
    c = np.asarray(condition.numpy() if isinstance(condition, DNDarray) else condition, dtype=bool).reshape(-1)
    if axis is None:
        a, axis = flatten(a), 0
    axis = sanitize_axis(a.shape, axis)
    n = a.gshape[axis]
    if c.size > n:
        raise IndexError("condition longer than the axis")
    mask = np.zeros(n, dtype=bool)
    mask[: c.size] = c
    key = (slice(None),) * axis + (torch.as_tensor(mask, device=a.larray.device),)
    return _to_split(a[key], a.split)


def extract(condition, a: DNDarray) -> DNDarray:
    """The elements of ``a`` where ``condition`` holds, flattened."""
    fa = flatten(a)
    c = condition if isinstance(condition, DNDarray) else factories.array(np.asarray(condition), device=a.device,
                                                                           comm=a.comm)
    fc = flatten(c.astype(types.bool) if c.dtype is not types.bool else c)
    if fc.split != fa.split or (fa.is_distributed() and fc.lshape != fa.lshape):
        fc = _to_split(fc, fa.split)
        if fa.is_distributed():
            fc = DNDarray(fa.comm.redistribute(fc.larray, 0, fc.counts_displs()[0], fa.counts_displs()[0]),
                          fc.gshape, fc.dtype, 0, fc.device, fc.comm, fa.balanced)
    return _to_split(fa[fc], 0 if a.split is not None else None)


def select(condlist, choicelist, default=0) -> DNDarray:
    """The first matching choice of each element (numpy's ``select``); the
    first DNDarray's split."""
    from .indexing import where

    proto = _proto(list(condlist) + list(choicelist))
    choices = [_dnd(c, proto) for c in choicelist]
    base = _dnd(np.asarray(default), proto)
    shape = tuple(torch.broadcast_shapes(*[c.gshape for c in choices + [base]],
                                         *[c.gshape if isinstance(c, DNDarray) else np.shape(c) for c in condlist]))
    dt = functools.reduce(torch.promote_types, [c.larray.dtype for c in choices])
    if np.ndim(default):
        dt = torch.promote_types(dt, base.larray.dtype)
    htype = types.canonical_heat_type(dt)
    res = broadcast_to(base.astype(htype), shape)
    for cond, choice in reversed(list(zip(condlist, choices))):
        res = where(_dnd(cond, proto), choice.astype(htype), res)
    return _to_split(res, proto.split)


def choose(a: DNDarray, choices, mode: str = "raise") -> DNDarray:
    """numpy's ``choose``: each element of ``a`` picks from ``choices``; ``a``'s split."""
    from . import arithmetics
    from .indexing import where

    n = len(choices)
    sel = a
    if mode == "raise":
        lo = int(_global_min_max(a)[0]) if a.size else 0
        hi = int(_global_min_max(a)[1]) if a.size else 0
        if lo < 0 or hi >= n:
            raise ValueError(f"invalid entry in choice array (range [{lo}, {hi}], {n} choices)")
    elif mode == "wrap":
        sel = arithmetics.mod(a, n)
    elif mode == "clip":
        from .rounding import clip

        sel = clip(a, 0, n - 1)
    chs = [_dnd(c, a) for c in choices]
    shape = tuple(torch.broadcast_shapes(a.gshape, *[c.gshape for c in chs]))
    res = broadcast_to(chs[-1], shape)
    for i in range(n - 2, -1, -1):
        res = where(sel == i, chs[i], res)
    return _to_split(res, a.split)


def _global_min_max(a: DNDarray):
    t = a.larray.reshape(-1)
    vals = torch.stack([t.min(), t.max()]) if t.numel() else None
    if a.is_distributed():
        have = torch.tensor([vals is not None], device=t.device)
        v = vals if vals is not None else torch.zeros(2, dtype=t.dtype, device=t.device)
        allv = torch.stack(a.comm.Allgather(v))
        haves = torch.cat(a.comm.Allgather(have))
        allv = allv[haves]
        return allv[:, 0].min().item(), allv[:, 1].max().item()
    return vals[0].item(), vals[1].item()


def piecewise(x: DNDarray, condlist, funclist, *args, **kw) -> DNDarray:
    """numpy's ``piecewise``: each function (or constant) where its condition
    holds (the last, if one more, elsewhere), applied by each rank to its
    chunk; ``x``'s split."""
    conds = [_local_like(x, c) for c in condlist]
    if len(funclist) == len(conds) + 1:
        otherwise = ~torch.stack(conds).any(0) if conds else torch.ones_like(x.larray, dtype=torch.bool)
        conds.append(otherwise)
    t = x.larray
    res = torch.zeros_like(t)
    for c, f in zip(conds, funclist):
        v = f(t, *args, **kw) if callable(f) else torch.as_tensor(f, dtype=t.dtype, device=t.device)
        res = torch.where(c, torch.as_tensor(v, device=t.device).to(t.dtype), res)
    return _wrap(res, x.gshape, x.split, x, x.balanced)


def apply_along_axis(func1d, axis: int, arr: DNDarray, *args, **kwargs) -> DNDarray:
    """``func1d`` (on 1-D torch tensors) over the 1-D slices along ``axis``;
    along the split axis the array is resplit to another axis first (a
    1-D array is gathered)."""
    axis = sanitize_axis(arr.shape, axis)
    a = arr
    if a.is_distributed() and a.split == axis:
        a = a.resplit(next(i for i in range(a.ndim) if i != axis)) if a.ndim > 1 else a.resplit(None)
    t = a.larray.movedim(axis, -1)
    rows = t.reshape(-1, t.shape[-1])
    outs = [torch.as_tensor(func1d(r, *args, **kwargs), device=t.device) for r in rows]
    out = torch.stack(outs) if outs else torch.zeros((0,), device=t.device)
    lead = t.shape[:-1]
    out = out.reshape(tuple(lead) + tuple(out.shape[1:]))
    extra = out.ndim - len(lead)
    out = out.movedim(tuple(range(len(lead), out.ndim)), tuple(range(axis, axis + extra))) if extra else out
    gshape = list(out.shape)
    split = a.split if a.is_distributed() else None
    if split is not None:
        if split > axis:
            split += extra - 1
        gshape[split] = a.gshape[a.split]
    res = _wrap(out.contiguous(), tuple(gshape), split, arr, a.balanced if split is not None else True)
    want = arr.split if arr.split is not None and arr.split < res.ndim else None
    return _to_split(res, want)


def apply_over_axes(func, a: DNDarray, axes) -> DNDarray:
    """``func(a, axis)`` over each axis in turn, an axis the result lost put
    back with length 1 (numpy's)."""
    res = a
    for ax in np.atleast_1d(axes):
        ax = int(ax) % a.ndim
        r = func(res, ax)
        if r.ndim == res.ndim:
            res = r
        elif r.ndim == res.ndim - 1:
            res = expand_dims(r, ax)
        else:
            raise ValueError("function is not returning an array of the correct shape")
    return _to_split(res, a.split if a.split is not None and a.split < res.ndim else None)


def argwhere(x: DNDarray) -> DNDarray:
    """(nnz, ndim) global indices of the non-zero elements."""
    from .indexing import nonzero

    res = nonzero(x)
    if res.ndim == 1:
        return reshape(res, (res.gshape[0], 1), new_split=res.split)
    return res


def unwrap(p: DNDarray, discont=None, axis: int = -1, period: float = 2 * math.pi) -> DNDarray:
    """numpy's ``unwrap`` along ``axis``: the jumps above ``discont`` folded
    into ``period``; along the split axis each rank takes one halo row from
    its predecessor and the corrections' running sum continues across the
    ranks (an Exscan)."""
    axis = sanitize_axis(p.shape, axis)
    t = p.larray
    dt = t.dtype if t.is_floating_point() else torch.float32
    t = t.to(dt)
    if discont is None:
        discont = period / 2
    half = period / 2
    along = p.is_distributed() and p.split == axis
    if along:
        from .arithmetics import _halo

        counts = p.counts_displs()[0]
        prev = _halo(t, axis, counts, p.comm, before=True)
        ext = torch.cat([prev, t], dim=axis) if prev is not None else t
    else:
        ext = t
    dd = torch.diff(ext, dim=axis)
    ddmod = torch.remainder(dd + half, period) - half
    ddmod = torch.where((ddmod == -half) & (dd > 0), torch.full_like(ddmod, half), ddmod)
    corr = ddmod - dd
    corr = torch.where(dd.abs() < discont, torch.zeros_like(corr), corr)
    csum = torch.cumsum(corr, dim=axis)
    if along:
        n_new = csum.shape[axis]
        last = csum.narrow(axis, n_new - 1, 1) if n_new else torch.zeros(
            [1 if i == axis else s for i, s in enumerate(t.shape)], dtype=dt, device=t.device)
        off = p.comm.Exscan(last.contiguous())
        if prev is not None:
            res = t + csum + off
        else:
            first = t.narrow(axis, 0, builtins.min(1, t.shape[axis]))
            rest = t.narrow(axis, builtins.min(1, t.shape[axis]), builtins.max(t.shape[axis] - 1, 0)) + csum + off
            res = torch.cat([first, rest], dim=axis)
    else:
        n = t.shape[axis]
        first = t.narrow(axis, 0, builtins.min(1, n))
        rest = t.narrow(axis, builtins.min(1, n), builtins.max(n - 1, 0)) + csum
        res = torch.cat([first, rest], dim=axis)
    return _wrap(res, p.gshape, p.split, p, p.balanced)


def trim_zeros(x: DNDarray, trim: str = "fb") -> DNDarray:
    """A 1-D array without its leading ('f') and trailing ('b') zeros: the
    global first and last non-zero positions, then a slice (nothing moves)."""
    t = x.larray
    off = x.counts_displs()[1][x.comm.rank] if x.is_distributed() else 0
    nz = torch.nonzero(t != 0).reshape(-1) + off
    n = x.gshape[0]
    lo = int(nz.min()) if nz.numel() else n
    hi = int(nz.max()) + 1 if nz.numel() else 0
    if x.is_distributed():
        ext = x.comm.Allgather(torch.tensor([lo, -hi], dtype=torch.int64, device=t.device))
        lo = builtins.min(int(e[0]) for e in ext)
        hi = builtins.max(-int(e[1]) for e in ext)
    start = lo if "f" in trim.lower() else 0
    stop = hi if "b" in trim.lower() else n
    if stop < start:
        start = stop = 0 if hi == 0 else start
    return _to_split(x[start:stop], 0 if x.split is not None else None)


# ---------------------------------------------------------------------- #
# order
# ---------------------------------------------------------------------- #
def _key_of(descending: bool):
    from ..parallel.sample_sort import order_key

    return lambda v: order_key(v, descending)


def _sort_1d(x: DNDarray, descending: bool, with_indices: bool = True):
    """(values, global indices or None) of the 1-D split ``x`` sorted over
    the ranks by the sample sort, in ``chunk``'s layout."""
    from ..parallel.sample_sort import order_key, sample_sort_1d

    t = x.larray
    counts, displs = x.counts_displs()
    payloads = [t]
    if with_indices:
        payloads.append(torch.arange(displs[x.comm.rank], displs[x.comm.rank] + counts[x.comm.rank],
                                     dtype=torch.int64, device=t.device))
    wire_bool = t.dtype == torch.bool
    if wire_bool:
        payloads[0] = t.to(torch.uint8)
    _, out = sample_sort_1d(x.comm, order_key(payloads[0], descending), payloads, counts, _key_of(descending))
    vals = out[0].to(torch.bool) if wire_bool else out[0]
    return vals, (out[1] if with_indices else None)


def _local_sort(t: torch.Tensor, dim: int, descending: bool):
    """torch's stable sort (NaN last ascending, first descending, as the
    reference's); bools as uint8."""
    if t.dtype == torch.bool:
        v, i = torch.sort(t.to(torch.uint8), dim=dim, descending=descending, stable=True)
        return v.to(torch.bool), i
    if t.is_complex():
        raise TypeError("complex arrays are ordered by sort_complex")
    return torch.sort(t, dim=dim, descending=descending, stable=True)


def sort(x: DNDarray, axis: int = -1, descending: bool = False, out=None, method: str = "auto"):
    """Sorted values and their global indices along ``axis`` (stable; NaN
    last, or first where ``descending``).

    ``method``: ``'auto'`` and ``'sample'`` sort a 1-D split array by the
    distributed sample sort (``parallel.sample_sort``: exact splitters, one
    exchange, each element across the wire at most once) and an n-D array
    along its split axis by the transpose method (resplit to another axis,
    sort there, resplit back); ``'global'`` gathers the axis onto every rank
    (with the reference's warning) and sorts it whole."""
    if method not in ("auto", "global", "sample"):
        raise ValueError(f"unknown sort method {method!r}")
    axis = sanitize_axis(x.shape, axis)
    n = x.gshape[axis]
    idt = _index_dtype(builtins.max(n - 1, 0))
    if method == "sample" and not (x.ndim == 1 and (x.split == 0 or not x.comm.is_distributed())):
        raise ValueError("method='sample' needs a 1-D split-0 sort")
    if not x.is_distributed() or x.split != axis:
        v, i = _local_sort(x.larray, axis, descending)
        res = (_wrap(v, x.gshape, x.split, x, x.balanced), _wrap(i.to(idt), x.gshape, x.split, x, x.balanced))
    elif method == "global":
        _warn_implicit_gather("sort", x)
        v, i = _local_sort(_full(x), axis, descending)
        res = (_scatter_chunk(x, v, x.gshape, x.split), _scatter_chunk(x, i.to(idt), x.gshape, x.split))
    elif x.ndim == 1:
        v, i = _sort_1d(x, descending)
        res = (_wrap(v, x.gshape, 0, x), _wrap(i.to(idt), x.gshape, 0, x))
    else:
        other = next(a for a in range(x.ndim) if a != axis)
        y = x.resplit(other)
        v, i = _local_sort(y.larray, axis, descending)
        res = (_wrap(v, y.gshape, other, y).resplit(axis), _wrap(i.to(idt), y.gshape, other, y).resplit(axis))
    if out is not None:
        out.larray.copy_(res[0].larray)
        return out, res[1]
    return res


def argsort(x: DNDarray, axis: int = -1, descending: bool = False) -> DNDarray:
    """The global indices that sort ``x`` along ``axis`` (see :func:`sort`)."""
    return sort(x, axis=axis, descending=descending)[1]


def lexsort(keys, axis: int = -1) -> DNDarray:
    """Indirect stable sort on several keys, the last the primary: a stable
    sort by each key in turn (each a sample sort along a split axis); the
    first DNDarray key's split."""
    proto = _proto(keys)
    ks = [_dnd(k, proto) for k in keys]
    axis = sanitize_axis(proto.shape, axis)
    n = proto.gshape[axis]
    idt = _index_dtype(builtins.max(n - 1, 0))
    if proto.is_distributed() and proto.split == axis and proto.ndim == 1:
        cur = factories.arange(n, dtype=types.int64, split=0, device=proto.device, comm=proto.comm)
        for k in ks:
            kv = _take_axis(_to_split(k, 0), cur.resplit(None).larray, 0, 0)
            from ..parallel.sample_sort import order_key, sample_sort_1d

            c = kv.counts_displs()[0]
            curl = cur.larray if cur.lshape == kv.lshape else _to_split(cur, 0).larray
            _, (cl,) = sample_sort_1d(kv.comm, order_key(kv.larray), [curl], c)
            cur = _wrap(cl, (n,), 0, proto)
        return _wrap(cur.larray.to(idt), (n,), 0, proto)
    full = [_full(k) for k in ks]
    if proto.is_distributed() and proto.split != axis:
        full = [_full(k) for k in ks]
    idx = None
    for k in full:
        kk = k if idx is None else torch.take_along_dim(k, idx, dim=axis)
        o = _local_sort(kk, axis, False)[1]
        idx = o if idx is None else torch.take_along_dim(idx, o, dim=axis)
    return _scatter_chunk(proto, idx.to(idt), tuple(idx.shape), proto.split)


def sort_complex(x: DNDarray) -> DNDarray:
    """Sorted by real part, then imaginary part, along the last axis; complex."""
    cdt = x.larray.dtype if x.larray.is_complex() else (torch.complex128 if x.larray.dtype == torch.float64 else
                                                         torch.complex64)
    y = x.astype(types.canonical_heat_type(cdt))
    re = _wrap(y.larray.real.contiguous(), y.gshape, y.split, y, y.balanced)
    im = _wrap(y.larray.imag.contiguous(), y.gshape, y.split, y, y.balanced)
    idx = lexsort([im, re], axis=-1)
    return take_along_axis(y, idx, -1)


def _partition_order(t: torch.Tensor, kth: int, dim: int, arg: bool) -> torch.Tensor:
    """jnp's ``partition``/``argpartition`` along ``dim``: the kth + 1
    smallest ascending (stable), then the rest; values descending for
    ``partition``, indices ascending for ``argpartition``."""
    n = t.shape[dim]
    order = _local_sort(t, dim, False)[1]
    bottom = order.narrow(dim, 0, kth + 1)
    if arg:
        mark = torch.ones(t.shape, dtype=torch.bool, device=t.device).scatter(dim, bottom, False)
        rest = torch.sort(torch.where(mark, torch.arange(n, device=t.device).reshape(
            [-1 if i == dim % t.ndim else 1 for i in range(t.ndim)]).expand(t.shape), n), dim=dim).values
        return torch.cat([bottom, rest.narrow(dim, 0, n - kth - 1)], dim=dim)
    top = order.narrow(dim, kth + 1, n - kth - 1).flip(dim)
    return torch.cat([bottom, top], dim=dim)


def _partitioned(x: DNDarray, kth: int, axis: int, arg: bool) -> DNDarray:
    axis = sanitize_axis(x.shape, axis)
    kth = kth % x.gshape[axis] if kth < 0 else kth
    y = x
    if y.is_distributed() and y.split == axis:
        if y.ndim == 1:
            _warn_implicit_gather("partition", y)
            y = y.resplit(None)
        else:
            y = y.resplit(next(a for a in range(y.ndim) if a != axis))
    o = _partition_order(y.larray, kth, axis, arg)
    t = o.to(_index_dtype(builtins.max(x.gshape[axis] - 1, 0))) if arg else torch.take_along_dim(y.larray, o, axis)
    res = _wrap(t, y.gshape, y.split, y, y.balanced)
    return _to_split(res, x.split)


def partition(x: DNDarray, kth: int, axis: int = -1) -> DNDarray:
    """jnp's ``partition``: element ``kth`` in its sorted place, the smaller
    ones before it in ascending order, the rest after it descending."""
    return _partitioned(x, kth, axis, False)


def argpartition(x: DNDarray, kth: int, axis: int = -1) -> DNDarray:
    return _partitioned(x, kth, axis, True)


def _topk_keys(t: torch.Tensor, largest: bool) -> torch.Tensor:
    """int64 keys whose ascending order is ``lax.top_k``'s pick order (a
    NaN first; the smallest k by the order-reversed values)."""
    from ..parallel.sample_sort import order_key

    if not largest:
        t = -t if t.is_floating_point() else torch.bitwise_not(t.to(torch.int64) if t.dtype == torch.bool else t)
    return order_key(t, descending=True)


def _topk_1d(keys: torch.Tensor, k: int) -> torch.Tensor:
    """Positions of the ``k`` least ``keys``, ordered by key then position
    (``lax.top_k``'s stable pick): ``torch.topk`` for the threshold, the
    ties at it taken in position order."""
    k = builtins.min(k, keys.numel())
    if k == 0:
        return torch.zeros(0, dtype=torch.int64, device=keys.device)
    kth = torch.topk(keys, k, largest=False, sorted=False).values.max()
    less = torch.nonzero(keys < kth).reshape(-1)
    eq = torch.nonzero(keys == kth).reshape(-1)[: k - less.numel()]
    cand = torch.cat([less, eq])
    return cand[_stable_by(keys[cand], cand)]


def _stable_by(k: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """The order of (key, position) pairs."""
    o = torch.argsort(pos)
    return o[torch.sort(k[o], stable=True).indices]


def topk(x: DNDarray, k: int, dim: int = -1, largest: bool = True, sorted: bool = True, out=None):
    """The ``k`` largest (smallest) values along ``dim`` and their global
    indices, ``lax.top_k``'s order (ties by lower index, a NaN first).  A
    1-D split array: each rank's k candidates, one Allgather of the p k
    pairs, the final pick on every rank where k <= n / p; past that the
    sample sort in the asked direction and its first k gathered.  The
    result is replicated at every k and world size."""
    dim = sanitize_axis(x.shape, dim)
    n = x.gshape[dim]
    idt = _index_dtype(builtins.max(n - 1, 0))
    if x.is_distributed() and x.split == dim and x.ndim == 1:
        comm = x.comm
        if k <= n // comm.size:
            t = x.larray
            pos = _topk_1d(_topk_keys(t, largest), k)
            off = x.counts_displs()[1][comm.rank]
            kk = builtins.min(k, t.numel())
            lv = torch.zeros(k, dtype=t.dtype, device=t.device)
            li = torch.full((k,), -1, dtype=torch.int64, device=t.device)
            lv[:kk], li[:kk] = t[pos], pos + off
            vals, idxs = torch.cat(comm.Allgather(lv)), torch.cat(comm.Allgather(li))
            ok = idxs >= 0
            vals, idxs = vals[ok], idxs[ok]
            pick = _topk_1d(_topk_keys(vals, largest), k)
            o = _stable_by(_topk_keys(vals[pick], largest), idxs[pick])
            v, i = vals[pick][o], idxs[pick][o]
            res = (_wrap(v, (k,), None, x), _wrap(i.to(idt), (k,), None, x))
        else:  # past n / p candidates a rank: the sample sort, its first k gathered
            sv, si = sort(x, descending=largest)
            res = (_to_split(sv[:k], None), _to_split(si[:k], None))
    else:
        y = x
        if x.is_distributed() and x.split == dim:
            _warn_implicit_gather("topk", x)
            y = x.resplit(None)
        t = y.larray.movedim(dim, -1)
        keys = _topk_keys(t, largest)
        if t.ndim == 1:  # a selection, not a sort
            order = _topk_1d(keys, k)
        else:
            order = torch.sort(keys, dim=-1, stable=True).indices[..., :k]
        v = torch.take_along_dim(t, order, -1).movedim(-1, dim).contiguous()
        i = order.movedim(-1, dim).to(idt).contiguous()
        split = None if dim == x.split else y.split
        gshape = tuple(k if a == dim else s for a, s in enumerate(x.gshape))
        res = (_wrap(v, gshape, split, y, y.balanced if split is not None else True),
               _wrap(i, gshape, split, y, y.balanced if split is not None else True))
    if out is not None:
        out[0].larray.copy_(res[0].larray)
        out[1].larray.copy_(res[1].larray)
        return out
    return res


def searchsorted(a: DNDarray, v, side: str = "left", sorter=None) -> DNDarray:
    """Insertion indices of ``v`` into the sorted 1-D ``a``.  A split ``a``
    is never gathered: each rank searches its chunk and the counts are
    Allreduced (the queries, where split, are gathered first); the result
    takes ``v``'s split."""
    vd = v if isinstance(v, DNDarray) else None
    dev = a.larray.device
    q = _full(vd) if vd is not None else torch.as_tensor(np.asarray(v), device=dev)
    if sorter is not None:
        _warn_implicit_gather("searchsorted", a)
        s = _full(sorter) if isinstance(sorter, DNDarray) else torch.as_tensor(np.asarray(sorter), device=dev)
        base = _full(a)[s.to(torch.int64)]
        res = torch.searchsorted(base.contiguous(), q.to(base.dtype).contiguous(), side=side)
    else:
        local = a.larray.contiguous()
        dt = torch.promote_types(local.dtype, q.dtype)
        res = torch.searchsorted(local.to(dt), q.to(dt).contiguous(), side=side)
        if a.is_distributed():
            res = a.comm.Allreduce(res.contiguous())
    res = res.to(_index_dtype(a.gshape[0]))
    proto = vd if vd is not None else a
    gshape = tuple(q.shape)
    split = vd.split if vd is not None else None
    return _scatter_chunk(proto, res, gshape, split)


UniqueAllResult = collections.namedtuple("UniqueAllResult", "values indices inverse_indices counts")
UniqueCountsResult = collections.namedtuple("UniqueCountsResult", "values counts")
UniqueInverseResult = collections.namedtuple("UniqueInverseResult", "values inverse_indices")


def _unique_parts(x: DNDarray, with_index: bool):
    """The unique values of all of ``x`` (NaNs as one), on every rank, each
    with its first occurrence's global sorted position (and original flat
    index): a distributed sort, the first-occurrence mask, each rank's
    uniques, and one Allgatherv of the (few) uniques."""
    from ..parallel.sample_sort import ALONE, first_occurrence_mask

    f = flatten(x)
    if f.is_distributed():
        v, i = _sort_1d(f, False, with_index)
        counts = list(f.comm.counts_displs_shape(f.gshape, 0)[0])
        off = f.comm.counts_displs_shape(f.gshape, 0)[1][f.comm.rank]
        comm = f.comm
    else:
        v, i = _local_sort(f.larray, 0, False)
        counts, off, comm = [v.numel()], 0, None
    mask = first_occurrence_mask(comm if comm is not None else ALONE, v, counts)
    uv = v[mask]
    upos = torch.nonzero(mask).reshape(-1) + off
    ui = i[mask] if with_index else None
    if comm is not None:
        wire = uv.view(torch.uint8) if uv.dtype == torch.bool else uv
        cnt = comm._extents(wire, 0)
        uv = comm.Allgatherv(wire, 0, counts=cnt).view(uv.dtype)
        upos = comm.Allgatherv(upos, 0, counts=cnt)
        if with_index:
            ui = comm.Allgatherv(ui, 0, counts=cnt)
    return f, uv, upos, ui




def _inverse(x: DNDarray, uv: torch.Tensor) -> torch.Tensor:
    """Each local element's position in the sorted unique values ``uv``
    (a NaN at the last slot)."""
    t = x.larray
    wt = t.to(torch.uint8) if t.dtype == torch.bool else t
    wu = uv.to(torch.uint8) if uv.dtype == torch.bool else uv
    inv = torch.searchsorted(wu.contiguous(), wt.contiguous().reshape(-1)).reshape(t.shape)
    if t.is_floating_point():
        inv = torch.where(torch.isnan(t), torch.full_like(inv, uv.numel() - 1), inv)
    return inv


def unique(x: DNDarray, sorted: bool = False, return_inverse: bool = False, axis: Optional[int] = None):
    """The sorted unique values (NaNs as one), split 0 where ``x`` is split:
    a distributed sample sort, a neighbour compare, each rank's uniques
    (the array is never gathered).  ``return_inverse``: each element's
    position in the unique values (replicated on every rank for the lookup),
    laid out as ``x``.  With ``axis`` the reference's global path: the
    array is gathered and the unique slices found whole."""
    if axis is not None:
        axis = sanitize_axis(x.shape, axis)
        _warn_implicit_gather("unique", x)
        full = _full(x)
        vals, inv = torch.unique(full, sorted=True, return_inverse=True, dim=axis)
        v = _scatter_chunk(x, vals, tuple(vals.shape), 0 if x.split is not None else None)
        if return_inverse:
            return v, _wrap(inv.to(torch.int32), tuple(inv.shape), None, x)
        return v
    uv = _unique_parts(x, False)[1]
    split = 0 if x.split is not None else None
    v = _scatter_chunk(x, uv, (uv.numel(),), split)
    if not return_inverse:
        return v
    inv = _inverse(x, uv).to(_index_dtype(builtins.max(uv.numel() - 1, 0)))
    return v, _wrap(inv, x.gshape, x.split, x, x.balanced)


def unique_values(x: DNDarray) -> DNDarray:
    return unique(x)


def unique_inverse(x: DNDarray):
    v, inv = unique(x, return_inverse=True)
    return UniqueInverseResult(v, inv)


def _counts(upos: torch.Tensor, n: int) -> torch.Tensor:
    return torch.diff(torch.cat([upos, torch.tensor([n], dtype=upos.dtype, device=upos.device)]))


def unique_counts(x: DNDarray):
    f, uv, upos, _ = _unique_parts(x, False)
    s = 0 if x.split is not None else None
    c = _counts(upos, f.size).to(torch.int32)
    return UniqueCountsResult(_scatter_chunk(x, uv, (uv.numel(),), s), _scatter_chunk(x, c, (c.numel(),), s))


def unique_all(x: DNDarray):
    """(values, first indices into the flattened array, inverse, counts)."""
    f, uv, upos, ui = _unique_parts(x, True)
    s = 0 if x.split is not None else None
    idt = _index_dtype(builtins.max(x.size - 1, 0))
    c = _counts(upos, f.size).to(torch.int32)
    inv = _inverse(x, uv).to(_index_dtype(builtins.max(uv.numel() - 1, 0)))
    inv_d = _to_split(_wrap(inv, x.gshape, x.split, x, x.balanced), s if x.ndim else None)
    return UniqueAllResult(_scatter_chunk(x, uv, (uv.numel(),), s), _scatter_chunk(x, ui.to(idt), (ui.numel(),), s),
                           inv_d, _scatter_chunk(x, c, (c.numel(),), s))


def _set_values(a, proto: DNDarray) -> torch.Tensor:
    """The sorted unique values of ``a`` on every rank."""
    return _unique_parts(_dnd(a, proto), False)[1]


def _set_result(t: torch.Tensor, ar1, ar2, proto: DNDarray) -> DNDarray:
    split = 0 if (getattr(ar1, "split", None) is not None or getattr(ar2, "split", None) is not None) else None
    return _scatter_chunk(proto, t, (t.numel(),), split)


def _sorted_join(u1: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    dt = torch.promote_types(u1.dtype, u2.dtype)
    return _local_sort(torch.cat([u1.to(dt), u2.to(dt)]), 0, False)[0]


def union1d(ar1, ar2) -> DNDarray:
    """The sorted unique values of both arrays."""
    proto = _proto([ar1, ar2])
    u = _sorted_join(_set_values(ar1, proto), _set_values(ar2, proto))
    from ..parallel.sample_sort import ALONE, first_occurrence_mask

    return _set_result(u[first_occurrence_mask(ALONE, u, [u.numel()])], ar1, ar2, proto)


def intersect1d(ar1, ar2, assume_unique: bool = False) -> DNDarray:
    """The sorted values in both arrays."""
    proto = _proto([ar1, ar2])
    aux = _sorted_join(_set_values(ar1, proto), _set_values(ar2, proto))
    both = aux[1:][aux[1:] == aux[:-1]]
    return _set_result(both, ar1, ar2, proto)


def setdiff1d(ar1, ar2, assume_unique: bool = False) -> DNDarray:
    """The sorted unique values of ``ar1`` not in ``ar2``."""
    proto = _proto([ar1, ar2])
    u1, u2 = _set_values(ar1, proto), _set_values(ar2, proto)
    return _set_result(u1[~torch.isin(u1, u2.to(u1.dtype))], ar1, ar2, proto)


def setxor1d(ar1, ar2, assume_unique: bool = False) -> DNDarray:
    """The sorted values in exactly one of the arrays."""
    proto = _proto([ar1, ar2])
    aux = _sorted_join(_set_values(ar1, proto), _set_values(ar2, proto))
    if aux.numel() == 0:
        return _set_result(aux, ar1, ar2, proto)
    flag = torch.cat([torch.tensor([True], device=aux.device), aux[1:] != aux[:-1],
                      torch.tensor([True], device=aux.device)])
    return _set_result(aux[flag[1:] & flag[:-1]], ar1, ar2, proto)


DNDarray.expand_dims = expand_dims
DNDarray.flatten = flatten
DNDarray.ravel = ravel
DNDarray.flip = flip
DNDarray.reshape = reshape
DNDarray.roll = roll
DNDarray.squeeze = squeeze
DNDarray.sort = sort
DNDarray.topk = topk
DNDarray.unique = unique
DNDarray.repeat = repeat
DNDarray.tile = tile
DNDarray.swapaxes = swapaxes
DNDarray.moveaxis = moveaxis
DNDarray.broadcast_to = broadcast_to
DNDarray.concatenate = lambda self, others, axis=0: concatenate(
    [self] + ([others] if isinstance(others, DNDarray) else list(others)), axis=axis)
DNDarray.diagonal = diagonal
DNDarray.shuffle = shuffle
DNDarray.take = take
DNDarray.argsort = argsort
