"""Generalized op dispatch (reference: ``heat_tpu/core/_operations.py``).

HeAT's four helpers: sanitize, run the torch op on the local tensors, run
the collective the split demands, wrap the result.  ``_local_op`` runs an
element-wise op on the local tensor.  ``_binary_op`` broadcasts two operands:
it resplits the second where the splits disagree (with the reference's
warning), slices a replicated operand to the result's chunk along the split
axis, and moves an operand's rows to the other's layout where the two split
operands are laid out differently.  ``_reduce_op`` reduces locally (an empty
chunk gives the op's identity) and Allreduces over the ranks where the split
axis is reduced.  ``_cum_op`` scans locally and, along the split axis, adds
the Exscan of each rank's last partial.

Result dtypes follow the JAX package, which runs with 64-bit types off: a
result is never 64-bit unless an operand is (a Python scalar never widens
it).
"""

from __future__ import annotations

import warnings
from typing import Callable, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from . import sanitation, types
from .communication import _unit
from .dndarray import DNDarray
from .stride_tricks import broadcast_shape, sanitize_axis

__all__ = ["_local_op", "_binary_op", "_reduce_op", "_cum_op"]

_NARROW = {torch.float64: torch.float32, torch.int64: torch.int32, torch.complex128: torch.complex64}


def _narrow(t: torch.Tensor, *operands) -> torch.Tensor:
    """``t`` narrowed to 32 bits where it came out 64-bit from operands none
    of which was 64-bit: the JAX package (x64 off) has no such result."""
    narrow = _NARROW.get(t.dtype)
    if narrow is None or any(isinstance(o, torch.Tensor) and o.dtype in _NARROW for o in operands):
        return t
    return t.to(narrow)


# the metadata check at the dispatch tail: None (one global load) unless
# ``sanitation.enable_checks()`` sets it
_CHECKS = None


def _wrap(t: torch.Tensor, gshape, split, proto: DNDarray, balanced: bool = True) -> DNDarray:
    out = DNDarray(t, tuple(gshape), types.canonical_heat_type(t.dtype), split, proto.device, proto.comm, balanced)
    if _CHECKS is not None:
        _CHECKS(out, "dispatch")
    return out


def _out_buffer(out: DNDarray, gshape, split, device) -> DNDarray:
    """The ``out`` buffer checked against the result's metadata; a buffer of
    another split is resplit first, with the reference's warning."""
    sanitation.sanitize_in(out)
    if out.split != split and tuple(out.shape) == tuple(gshape):
        warnings.warn(f"Split axis of output buffer is inconsistent with split semantics (resplitting out from "
                      f"{out.split} to {split}).")
        out.resplit_(split)
    sanitation.sanitize_out(out, gshape, split, device)
    return out


def _write_out(out: DNDarray, t: torch.Tensor, gshape, split, device) -> DNDarray:
    """Copy the local result ``t`` into the ``out`` buffer's local tensor (in
    place, cast to its dtype)."""
    _out_buffer(out, gshape, split, device)
    if tuple(out.lshape) != tuple(t.shape):
        raise ValueError(f"output buffer's local shape {out.lshape} differs from the result's {tuple(t.shape)}")
    out.larray.copy_(t)
    return out


def _local_op(op: Callable, x: DNDarray, out: Optional[DNDarray] = None, **kwargs) -> DNDarray:
    """Element-wise op on the local tensor: no communication, the split and
    the layout are kept."""
    sanitation.sanitize_in(x)
    t = _narrow(op(x.larray, **kwargs), x.larray)
    if out is not None:
        return _write_out(out, t, x.gshape, x.split, x.device)
    return _wrap(t, x.gshape, x.split, x, x.balanced)


def _result_split(shapes_splits, out_ndim: int) -> Optional[int]:
    """Result split of a broadcast op: the first operand split, aligned to the
    output's axes."""
    for shape, split in shapes_splits:
        if split is not None:
            return split + (out_ndim - len(shape))
    return None


def _operand(t, proto: DNDarray):
    """A DNDarray or a Python scalar (kept as a weak scalar) for ``t``."""
    if isinstance(t, DNDarray):
        return t
    if isinstance(t, (bool, int, float, complex)):
        return t
    if isinstance(t, (np.ndarray, np.generic, list, tuple, torch.Tensor)):
        from . import factories

        return factories.array(t, device=proto.device, comm=proto.comm)
    raise TypeError(f"Unsupported operand type {type(t)}")


def _localize(a, k: Optional[int], nd: int, layout: Optional[DNDarray]):
    """The local operand of ``a`` for a result of ``nd`` axes split along
    ``k`` with ``layout``'s chunk map: a scalar as it is; a split operand
    (along ``k``, its rows moved to ``layout``'s map where they differ); a
    replicated one sliced to the chunk along ``k`` unless it broadcasts
    there."""
    if not isinstance(a, DNDarray):
        return a
    if k is None or not layout.is_distributed():
        return a.larray
    lead = nd - a.ndim
    axis = k - lead
    if a.split is not None and a.split != axis:  # split elsewhere: onto k, or replicated where it has no k
        a = a.resplit(axis if axis >= 0 and a.gshape[axis] != 1 else None)
    if a.split is not None:
        if a is layout or (a.balanced and layout.balanced and a.gshape[a.split] == layout.gshape[layout.split]):
            return a.larray
        counts, target = a.counts_displs()[0], layout.counts_displs()[0]
        if list(counts) == list(target):
            return a.larray
        return a.comm.redistribute(a.larray, a.split, counts, target)
    if axis < 0 or a.gshape[axis] == 1:
        return a.larray
    counts, displs = layout.counts_displs()
    rank = a.comm.rank
    return a.larray.narrow(axis, displs[rank], counts[rank])


def _binary_op(
    op: Callable,
    t1,
    t2,
    out: Optional[DNDarray] = None,
    where=None,
    fn_kwargs: Optional[dict] = None,
) -> DNDarray:
    """Broadcasting binary op with split reconciliation (reference
    ``__binary_op``): the result is split along the first operand's split
    axis (aligned to the output's axes); a second operand split elsewhere is
    resplit to it, with a warning."""
    fn_kwargs = fn_kwargs or {}
    if not isinstance(t1, DNDarray) and not isinstance(t2, DNDarray):
        raise TypeError(f"At least one operand must be a DNDarray, got {type(t1)}, {type(t2)}")
    proto = t1 if isinstance(t1, DNDarray) else t2
    a1, a2 = _operand(t1, proto), _operand(t2, proto)
    sh1 = a1.gshape if isinstance(a1, DNDarray) else ()
    sh2 = a2.gshape if isinstance(a2, DNDarray) else ()
    out_shape = tuple(broadcast_shape(sh1, sh2))
    nd = len(out_shape)
    s1 = a1.split if isinstance(a1, DNDarray) else None
    s2 = a2.split if isinstance(a2, DNDarray) else None
    if s1 is not None and s2 is not None and s1 + nd - len(sh1) != s2 + nd - len(sh2):
        target = s1 + nd - len(sh1) - (nd - len(sh2))
        warnings.warn(
            "Binary operation with mismatched splits triggers a redistribution "
            f"(split {s2} -> {target if target >= 0 else None}); this is a communication-heavy operation."
        )
        a2 = a2.resplit(target if target >= 0 else None)
        s2 = a2.split
    k = _result_split(((sh1, s1), (sh2, s2)), nd)

    # the operand whose layout the result takes: split along k, not broadcast
    # there; an operand split along an axis it broadcasts is replicated
    operands, layout = [a1, a2], None
    for i, (s, sh) in enumerate(((s1, sh1), (s2, sh2))):
        if s is None or s + nd - len(sh) != k:
            continue
        if sh[s] == out_shape[k]:
            layout = operands[i] if layout is None else layout
        elif operands[i].is_distributed():
            operands[i] = operands[i].resplit(None)
    a1, a2 = operands
    if k is not None and layout is None:
        # every split operand broadcasts along k: the result takes chunk's layout
        from . import factories

        layout = factories.empty(out_shape, dtype=types.bool, split=k, device=proto.device, comm=proto.comm)
    l1, l2 = _localize(a1, k, nd, layout), _localize(a2, k, nd, layout)
    res = _narrow(op(l1, l2, **fn_kwargs), l1, l2)
    balanced = layout.balanced if layout is not None else True
    if where is not None:
        w = _localize(_operand(where, proto), k, nd, layout)
        w = torch.as_tensor(w, device=res.device)
        if out is not None:
            res = torch.where(w, res.to(out.larray.dtype), _out_buffer(out, out_shape, k, proto.device).larray)
        else:
            res = torch.where(w, res, torch.zeros((), dtype=res.dtype, device=res.device))
    if out is not None:
        return _write_out(out, res, out_shape, k, proto.device)
    return _wrap(res, out_shape, k, proto, balanced)


class Reduction(NamedTuple):
    """A reduction for :func:`_reduce_op`: ``local(tensor, dims, keepdim)``
    reduces one rank's tensor, ``combine`` names the Allreduce op that joins
    the ranks' partials, ``dtype(torch dtype)`` gives the result dtype (the
    JAX package's) or None for the local result's."""

    local: Callable
    combine: str
    dtype: Optional[Callable] = None


def _reduce_op(
    op: Reduction,
    x: DNDarray,
    axis: Union[int, Tuple[int, ...], None] = None,
    keepdims: bool = False,
    out: Optional[DNDarray] = None,
    dtype=None,
) -> DNDarray:
    """Reduction with split bookkeeping (reference ``__reduce_op``).

    Reducing the split axis (or all axes) Allreduces the ranks' partials and
    gives a replicated result; other axes keep the (shifted) split.  An empty
    chunk's partial is the combine's identity."""
    sanitation.sanitize_in(x)
    axis = sanitize_axis(x.shape, axis)
    dims = tuple(range(x.ndim)) if axis is None else ((axis,) if isinstance(axis, int) else tuple(axis))
    split = x.split
    if split is None or split in dims:
        new_split = None
    else:
        new_split = split if keepdims else split - sum(1 for a in dims if a < split)
    t = x.larray
    lshape = [1 if i in dims else s for i, s in enumerate(t.shape)] if keepdims else \
        [s for i, s in enumerate(t.shape) if i not in dims]
    want = t.dtype if op.dtype is None else op.dtype(t.dtype)
    if t.numel() == 0 and any(t.shape[d] == 0 for d in dims):
        partial = torch.full(lshape, _unit(op.combine, want), dtype=want, device=t.device)
    else:
        partial = op.local(t, dims, keepdims).to(want)
    if split in dims and x.is_distributed():  # bools travel as uint8
        wire = partial.to(torch.uint8) if partial.dtype == torch.bool else partial.contiguous()
        partial = x.comm.Allreduce(wire, op.combine).to(want)
    if dtype is not None:
        partial = partial.to(types.canonical_heat_type(dtype).torch_type())
    gshape = [1 if i in dims else s for i, s in enumerate(x.gshape)] if keepdims else \
        [s for i, s in enumerate(x.gshape) if i not in dims]
    if out is not None:
        return _write_out(out, partial, tuple(gshape), new_split, x.device)
    return _wrap(partial, gshape, new_split, x, x.balanced if new_split is not None else True)


def _cum_op(
    op: Callable,
    x: DNDarray,
    axis: Optional[int],
    dtype=None,
    out: Optional[DNDarray] = None,
    combine: str = "sum",
) -> DNDarray:
    """Cumulative op along ``axis`` (reference ``__cum_op``): ``op(tensor,
    dim)`` scans the local tensor; along the split axis each rank then
    combines its scan with the Exscan (by ``combine``) of the ranks' last
    partials.  ``axis=None`` scans the flattened array (gathered first).
    Integers keep their dtype and bools scan as int32, as in the JAX
    package."""
    sanitation.sanitize_in(x)
    axis = sanitize_axis(x.shape, axis)
    if axis is None:
        flat = x.resplit(None) if x.split is not None else x
        t = flat.larray.reshape(-1)
        axis, split, gshape = 0, None, (t.numel(),)
    else:
        t, split, gshape = x.larray, x.split, x.gshape
    want = torch.int32 if t.dtype == torch.bool else t.dtype
    res = op(t, axis).to(want)
    if split == axis and x.is_distributed():
        if t.shape[axis] > 0:
            last = res.narrow(axis, t.shape[axis] - 1, 1)
        else:
            last = torch.full([1 if i == axis else s for i, s in enumerate(t.shape)], _unit(combine, want),
                              dtype=want, device=t.device)
        offset = x.comm.Exscan(last.contiguous(), combine)
        res = res + offset if combine == "sum" else res * offset
    if dtype is not None:
        res = res.to(types.canonical_heat_type(dtype).torch_type())
    if out is not None:
        return _write_out(out, res, gshape, split, x.device)
    return _wrap(res, gshape, split, x, x.balanced if split is not None else True)


if sanitation.checks_enabled():  # armed from the environment before this module loaded
    _CHECKS = sanitation.validate_dispatch
