"""Arithmetic operations (reference: ``heat_tpu/core/arithmetics.py``).

Every op runs through the dispatch core (``_operations``) on the local
tensors.  Where torch's type rules differ from the JAX package's (x64 off,
weakly typed Python scalars), the op converts first: bools computed as int32
in ``floordiv``, ``mod``, ``fmod``, ``pow`` and ``sub``; integer powers by the
JAX package's binary exponentiation (negative exponents included); an
integer division by zero gives the JAX package's values, where torch on the
CPU raises; ``mod`` is ``torch.remainder`` (the divisor's sign), never
``fmod``.  ``diff``,
``trapezoid`` and ``gradient`` along the split axis take one halo row from
the neighbouring rank (``Send``).
"""

from __future__ import annotations

import builtins
import math

import numpy as np
import torch

from . import types
from ._operations import Reduction, _binary_op, _cum_op, _local_op, _reduce_op, _narrow
from .dndarray import DNDarray
from .stride_tricks import sanitize_axis

__all__ = [
    "add",
    "bitwise_and",
    "bitwise_not",
    "bitwise_or",
    "bitwise_xor",
    "copysign",
    "cumprod",
    "cumsum",
    "diff",
    "div",
    "divide",
    "divmod",
    "float_power",
    "floordiv",
    "floor_divide",
    "fmod",
    "heaviside",
    "gcd",
    "hypot",
    "invert",
    "lcm",
    "ldexp",
    "left_shift",
    "mod",
    "mul",
    "multiply",
    "nanprod",
    "nansum",
    "neg",
    "negative",
    "pos",
    "positive",
    "pow",
    "power",
    "prod",
    "remainder",
    "right_shift",
    "sub",
    "subtract",
    "sum",
    "trapezoid",
    "trapz",
    "true_divide",
]


# ---------------------------------------------------------------------- #
# the JAX package's type rules on torch's ops
# ---------------------------------------------------------------------- #
def _int32(a):
    """A bool operand as the JAX package computes it in integer ops: int32."""
    if isinstance(a, torch.Tensor) and a.dtype == torch.bool:
        return a.to(torch.int32)
    return int(a) if isinstance(a, builtins.bool) else a


def _is_bool(a) -> builtins.bool:
    return isinstance(a, builtins.bool) or (isinstance(a, torch.Tensor) and a.dtype == torch.bool)


def _int_division(op, by_zero):
    """``op`` (floor_divide, remainder, fmod) with bools as int32 and an
    integer divisor of 0 giving the JAX package's value ``by_zero(x)`` where
    torch on the CPU raises."""

    def fn(a, b):
        a, b = _int32(a), _int32(b)
        dt = torch.result_type(a, b)
        if dt.is_floating_point or dt.is_complex:
            return op(a, b)
        x, y = torch.broadcast_tensors(*_tensors(a, b, dt))
        zero = y == 0
        return torch.where(zero, by_zero(x), op(x, torch.where(zero, torch.ones_like(y), y)))

    return fn


def _floordiv_by_zero(x):
    if not x.is_signed():
        return torch.full_like(x, -1)  # all ones
    return torch.where(x != 0, -2, -1).to(x.dtype)


def _sub(a, b):
    if _is_bool(a) and _is_bool(b):
        raise TypeError("subtract of two bools is not supported; use logical_xor")
    return torch.sub(_int32(a), _int32(b))


def _tensors(a, b, dtype=None):
    """Both operands as tensors of one dtype (torch's promotion, or ``dtype``)
    on the tensor operand's device, for ops that take no mixed dtypes."""
    dev = (a if isinstance(a, torch.Tensor) else b).device
    dt = dtype or torch.result_type(a, b)
    return torch.as_tensor(a, device=dev).to(dt), torch.as_tensor(b, device=dev).to(dt)


def _floating(a, b):
    """Both operands in their floating result type (float32 for integers)."""
    dt = torch.result_type(a, b)
    return _tensors(a, b, dt if dt.is_floating_point or dt.is_complex else torch.float32)


def _pow(a, b):
    """``a ** b``; integer powers by the JAX package's binary exponentiation
    (``_pow_int_int``: six bits of the exponent, read as unsigned, so a
    negative exponent gives what the JAX package gives, not an error)."""
    a, b = _int32(a), _int32(b)
    dt = torch.result_type(a, b)
    if dt.is_floating_point or dt.is_complex:
        return torch.pow(a, b)
    x1, x2 = torch.broadcast_tensors(*_tensors(a, b, dt))
    bits = x2.element_size() * 8
    acc = torch.where((x1 == 0) & (x2 != 0), 0, 1).to(dt)
    for _ in range(6):
        acc = torch.where((x2 & 1).bool(), acc * x1, acc)
        x1 = x1 * x1
        x2 = (x2 >> 1) & ((1 << (bits - 1)) - 1)  # a logical shift
    return acc


# ---------------------------------------------------------------------- #
# binary element-wise ops
# ---------------------------------------------------------------------- #
def add(t1, t2, out=None, where=None) -> DNDarray:
    """Elementwise addition ``t1 + t2``."""
    return _binary_op(torch.add, t1, t2, out=out, where=where)


def sub(t1, t2, out=None, where=None) -> DNDarray:
    """Elementwise subtraction ``t1 - t2``."""
    return _binary_op(_sub, t1, t2, out=out, where=where)


subtract = sub


def mul(t1, t2, out=None, where=None) -> DNDarray:
    """Elementwise multiplication ``t1 * t2``."""
    return _binary_op(torch.mul, t1, t2, out=out, where=where)


multiply = mul


def div(t1, t2, out=None, where=None) -> DNDarray:
    """Elementwise true division ``t1 / t2``."""
    return _binary_op(torch.true_divide, t1, t2, out=out, where=where)


divide = div
true_divide = div


def floordiv(t1, t2) -> DNDarray:
    """Elementwise floor division ``t1 // t2``."""
    return _binary_op(_int_division(torch.floor_divide, _floordiv_by_zero), t1, t2)


floor_divide = floordiv


def mod(t1, t2) -> DNDarray:
    """Elementwise modulo: the sign follows the divisor (Python semantics)."""
    return _binary_op(_int_division(torch.remainder, torch.zeros_like), t1, t2)


remainder = mod


def fmod(t1, t2) -> DNDarray:
    """Elementwise C-style fmod: the sign follows the dividend."""
    return _binary_op(_int_division(torch.fmod, torch.zeros_like), t1, t2)


def divmod(t1, t2):
    return (floordiv(t1, t2), mod(t1, t2))


def pow(t1, t2) -> DNDarray:
    """Elementwise power ``t1 ** t2``."""
    return _binary_op(_pow, t1, t2)


power = pow


def copysign(t1, t2) -> DNDarray:
    return _binary_op(lambda a, b: torch.copysign(*_floating(a, b)), t1, t2)


def hypot(t1, t2) -> DNDarray:
    return _binary_op(lambda a, b: torch.hypot(*_floating(a, b)), t1, t2)


def gcd(t1, t2) -> DNDarray:
    return _binary_op(lambda a, b: torch.gcd(*_tensors(_int32(a), _int32(b))), t1, t2)


def lcm(t1, t2) -> DNDarray:
    return _binary_op(lambda a, b: torch.lcm(*_tensors(_int32(a), _int32(b))), t1, t2)


def float_power(t1, t2) -> DNDarray:
    """``t1 ** t2`` in the widest float type the JAX package has (float32
    with 64-bit types off)."""
    return _binary_op(torch.float_power, t1, t2)


def ldexp(t1, t2) -> DNDarray:
    """Elementwise ``t1 * 2**t2`` (numpy ``ldexp``): the exponent must be an
    integer or a bool, as in the JAX package."""
    def fn(a, b):
        dev = (a if isinstance(a, torch.Tensor) else b).device
        e = torch.as_tensor(b, device=dev)
        if e.is_floating_point() or e.is_complex():
            raise ValueError(f"ldexp not supported for a {e.dtype} exponent; it takes integers")
        return torch.ldexp(_float(torch.as_tensor(a, device=dev)), _int32(e))

    return _binary_op(fn, t1, t2)


def _heaviside(a, b):
    """0 below zero, 1 above, ``b`` at zero and at nan (the JAX package's
    ``heaviside``), in the floating result type (float32 for integers and
    bools)."""
    x, h = _floating(a, b)
    return torch.where(x < 0, torch.zeros_like(h), torch.where(x > 0, torch.ones_like(h), h))


def heaviside(t1, t2) -> DNDarray:
    """Heaviside step function with ``t2`` as the value at 0 (and at nan)."""
    return _binary_op(_heaviside, t1, t2)


def bitwise_and(t1, t2) -> DNDarray:
    return _binary_op(torch.bitwise_and, t1, t2)


def bitwise_or(t1, t2) -> DNDarray:
    return _binary_op(torch.bitwise_or, t1, t2)


def bitwise_xor(t1, t2) -> DNDarray:
    return _binary_op(torch.bitwise_xor, t1, t2)


def _shift(op):
    """A shift whose two bool operands compute as int32, as in the JAX package."""

    def fn(a, b):
        if _is_bool(a) and _is_bool(b):
            a, b = _int32(a), _int32(b)
        return op(a, b)

    return fn


def left_shift(t1, t2) -> DNDarray:
    return _binary_op(_shift(torch.bitwise_left_shift), t1, t2)


def right_shift(t1, t2) -> DNDarray:
    return _binary_op(_shift(torch.bitwise_right_shift), t1, t2)


def nextafter(t1, t2) -> DNDarray:
    """Next representable float after ``t1`` toward ``t2``."""
    return _binary_op(lambda a, b: torch.nextafter(*_floating(a, b)), t1, t2)


# ---------------------------------------------------------------------- #
# unary element-wise ops
# ---------------------------------------------------------------------- #
def neg(x, out=None) -> DNDarray:
    """Elementwise negation."""
    return _local_op(torch.neg, x, out=out)


negative = neg


def pos(x, out=None) -> DNDarray:
    """Elementwise ``+x`` (a copy; bools too)."""
    return _local_op(lambda t: t.clone() if t.dtype == torch.bool else torch.positive(t), x, out=out)


positive = pos


def invert(x, out=None) -> DNDarray:
    """Elementwise bitwise NOT (logical NOT for bools)."""
    return _local_op(torch.bitwise_not, x, out=out)


bitwise_not = invert
bitwise_invert = invert
bitwise_left_shift = left_shift
bitwise_right_shift = right_shift


def _float(t: torch.Tensor) -> torch.Tensor:
    return t if t.is_floating_point() or t.is_complex() else t.to(torch.float32)


def reciprocal(x, out=None) -> DNDarray:
    """Elementwise ``1/x``."""
    return _local_op(lambda t: torch.reciprocal(_float(t)), x, out=out)


def spacing(x, out=None) -> DNDarray:
    """Distance to the next representable float away from zero (numpy
    ``spacing``)."""

    def fn(t):
        t = _float(t)
        return torch.nextafter(t, torch.where(t < 0, -math.inf, math.inf).to(t.dtype)) - t

    return _local_op(fn, x, out=out)


def i0(x) -> DNDarray:
    """Modified Bessel function of the first kind, order 0."""
    return _local_op(lambda t: torch.special.i0(_float(t)), x)


def bitwise_count(x, out=None) -> DNDarray:
    """Number of set bits of each element's magnitude, as uint8 (numpy
    ``bitwise_count``)."""

    def fn(t):
        if t.is_floating_point() or t.is_complex():
            raise TypeError("bitwise_count takes integer or bool arrays")
        if t.dtype == torch.bool:
            return t.to(torch.uint8)
        t = t.abs() if t.is_signed() else t
        count = torch.zeros(t.shape, dtype=torch.uint8, device=t.device)
        for i in range(t.element_size() * 8):
            count += ((t >> i) & 1).to(torch.uint8)
        return count

    return _local_op(fn, x, out=out)


# ---------------------------------------------------------------------- #
# reductions and scans
# ---------------------------------------------------------------------- #
def _sum_dtype(dt: torch.dtype) -> torch.dtype:
    """The JAX package's sum and product dtype: small integers and bools as
    int32 (uint8 sums to uint32 there, which torch lacks: int32 here)."""
    return torch.int32 if not (dt.is_floating_point or dt.is_complex) else dt


def _prod_local(t, dims, keepdim):
    for d in sorted(dims, reverse=True):
        t = torch.prod(t.to(_sum_dtype(t.dtype)) if t.dtype == torch.bool else t, dim=d, keepdim=keepdim)
    return t


def _nan_to(t, fill):
    return torch.where(torch.isnan(t), torch.full((), fill, dtype=t.dtype, device=t.device), t) \
        if t.is_floating_point() else t


_SUM = Reduction(lambda t, d, k: torch.sum(t, dim=d, keepdim=k), "sum", _sum_dtype)
_PROD = Reduction(_prod_local, "prod", _sum_dtype)
_NANSUM = Reduction(lambda t, d, k: torch.sum(_nan_to(t, 0), dim=d, keepdim=k), "sum", _sum_dtype)
_NANPROD = Reduction(lambda t, d, k: _prod_local(_nan_to(t, 1), d, k), "prod", _sum_dtype)


def sum(x, axis=None, out=None, keepdims=False, dtype=None) -> DNDarray:
    """Sum over ``axis``; reducing the split axis Allreduces the ranks' sums."""
    return _reduce_op(_SUM, x, axis=axis, keepdims=keepdims, out=out, dtype=dtype)


def prod(x, axis=None, out=None, keepdims=False, dtype=None) -> DNDarray:
    return _reduce_op(_PROD, x, axis=axis, keepdims=keepdims, out=out, dtype=dtype)


def nansum(x, axis=None, out=None, keepdims=False) -> DNDarray:
    return _reduce_op(_NANSUM, x, axis=axis, keepdims=keepdims, out=out)


def nanprod(x, axis=None, out=None, keepdims=False) -> DNDarray:
    return _reduce_op(_NANPROD, x, axis=axis, keepdims=keepdims, out=out)


def cumsum(x, axis, dtype=None, out=None) -> DNDarray:
    """Cumulative sum along ``axis``; along the split axis each rank adds the
    Exscan of the ranks' totals."""
    return _cum_op(torch.cumsum, x, axis, dtype=dtype, out=out)


def cumprod(x, axis, dtype=None, out=None) -> DNDarray:
    return _cum_op(torch.cumprod, x, axis, dtype=dtype, out=out, combine="prod")


cumproduct = cumprod


def nancumsum(x, axis: int = None, dtype=None, out=None) -> DNDarray:
    """Cumulative sum treating NaN as zero."""
    return _cum_op(lambda t, d: torch.cumsum(_nan_to(t, 0), d), x, axis, dtype=dtype, out=out)


def nancumprod(x, axis: int = None, dtype=None, out=None) -> DNDarray:
    """Cumulative product treating NaN as one."""
    return _cum_op(lambda t, d: torch.cumprod(_nan_to(t, 1), d), x, axis, dtype=dtype, out=out, combine="prod")


# ---------------------------------------------------------------------- #
# differences along an axis: halo rows from the neighbouring ranks
# ---------------------------------------------------------------------- #
def _balanced(x: DNDarray) -> DNDarray:
    """``x``, or a copy moved to ``chunk``'s layout: its empty ranks (if any)
    then come last, so a rank's neighbour rows are its neighbour ranks'."""
    if x.balanced:
        return x
    from .memory import copy

    x = copy(x)
    x.balance_()
    return x


def _halo(t: torch.Tensor, axis: int, counts, comm, before: builtins.bool = False):
    """The first row along ``axis`` of the next non-empty rank (or, with
    ``before``, the last row of the previous one), or None where there is
    none.  Empty ranks come last in ``counts``."""
    rank = comm.rank
    width = list(t.shape)
    width[axis] = 1
    if before:
        row = t.narrow(axis, t.shape[axis] - 1, 1) if t.shape[axis] else t.new_zeros(width)
        got = comm.Send(row.contiguous(), shift=1)
        return got if rank > 0 and counts[rank] > 0 else None
    row = t.narrow(axis, 0, 1) if t.shape[axis] else t.new_zeros(width)
    got = comm.Send(row.contiguous(), shift=-1)
    return got if rank + 1 < comm.size and counts[rank + 1] > 0 else None


def _layout(t: torch.Tensor, gshape, split, proto: DNDarray, counts) -> DNDarray:
    """Wrap a local tensor whose ranks hold ``counts`` along ``split``."""
    chunk = proto.comm.counts_displs_shape(gshape, split)[0]
    return DNDarray(t, tuple(gshape), types.canonical_heat_type(t.dtype), split, proto.device, proto.comm,
                    list(counts) == list(chunk))


def _diff_split(x: DNDarray, n: int, axis: int) -> DNDarray:
    """n-th difference along the split axis: n rounds of a one-row halo."""
    x = _balanced(x)
    comm, t = x.comm, x.larray
    counts = list(x.counts_displs()[0])
    for _ in range(n):
        nxt = _halo(t, axis, counts, comm)
        ext = torch.cat([t, nxt], dim=axis) if nxt is not None else t
        t = torch.diff(ext, dim=axis) if ext.shape[axis] > 0 else ext
        last = builtins.max((r for r, c in enumerate(counts) if c > 0), default=None)
        if last is not None:
            counts[last] -= 1
    gshape = list(x.gshape)
    gshape[axis] = builtins.max(x.gshape[axis] - n, 0)
    return _layout(t, gshape, axis, x, counts)


def diff(x, n: int = 1, axis: int = -1, prepend=None, append=None) -> DNDarray:
    """n-th discrete difference along ``axis``.  Along the split axis each
    round takes the next rank's first row; with ``prepend`` or ``append``
    there the array is gathered first."""
    from ._operations import _localize, _operand

    axis = sanitize_axis(x.shape, axis)
    if n == 0:
        return x
    if axis == x.split and x.is_distributed():
        if prepend is None and append is None:
            return _diff_split(x, n, axis)
        return diff(x.resplit(None), n, axis, prepend, append).resplit(x.split)
    kw, t = {}, x.larray
    for key, extra in (("prepend", prepend), ("append", append)):
        if extra is None:
            continue
        extra = _operand(extra, x)
        if not isinstance(extra, DNDarray) or extra.ndim == 0:
            shape = list(x.lshape)
            shape[axis] = 1
            value = extra.item() if isinstance(extra, DNDarray) else extra
            kw[key] = torch.full(shape, value, device=t.device, dtype=torch.result_type(t, value))
        else:
            kw[key] = _localize(extra, x.split, x.ndim, x)
    dt = t.dtype
    for extra in kw.values():
        dt = torch.promote_types(dt, extra.dtype)
    t = torch.diff(t.to(dt), n=n, dim=axis, **{key: extra.to(dt) for key, extra in kw.items()})
    gshape = list(x.gshape)
    gshape[axis] = t.shape[axis]
    return DNDarray(t, tuple(gshape), types.canonical_heat_type(t.dtype), x.split, x.device, x.comm, x.balanced)


def ediff1d(x, to_end=None, to_begin=None) -> DNDarray:
    """Differences of consecutive elements of the flattened array; split 0
    where ``x`` is split (rank order is the flat order along split 0)."""
    if x.split is None or not x.is_distributed():
        t = x.larray.reshape(-1)
        parts = [t[1:] - t[:-1]]
    else:
        x = _balanced(x.resplit(0) if x.split != 0 else x)
        t = x.larray.reshape(-1)
        width = math.prod(x.gshape[1:])
        counts = [c * width for c in x.counts_displs()[0]]
        nxt = _halo(t, 0, counts, x.comm)
        ext = torch.cat([t, nxt]) if nxt is not None else t
        parts = [ext[1:] - ext[:-1]]
    dt = parts[0].dtype
    comm = x.comm
    first, last = comm.rank == 0, comm.rank == comm.size - 1 or not x.is_distributed()
    if to_begin is not None and first:
        parts.insert(0, torch.as_tensor(np.asarray(to_begin), device=t.device).reshape(-1).to(dt))
    if to_end is not None and last:
        parts.append(torch.as_tensor(np.asarray(to_end), device=t.device).reshape(-1).to(dt))
    res = torch.cat(parts)
    if x.split is None or not x.is_distributed():
        return DNDarray(res, (res.numel(),), types.canonical_heat_type(dt), 0 if x.split is not None else None,
                        x.device, comm, True)
    counts = [int(c) for c in torch.cat(comm.Allgather(torch.tensor([res.numel()], device=res.device))).tolist()]
    return _layout(res, (builtins.sum(counts),), 0, x, counts)


def _trap(ext: torch.Tensor, axis: int, xs, dx: float, orred: builtins.bool) -> torch.Tensor:
    """The trapezoid sum along ``axis`` as the JAX package forms it: each
    neighbour pair added in ``ext``'s dtype (integers wrap; with ``orred``
    the pair of 0/1 bools is or'ed), times ``dx``/2 or the sample points'
    differences over 2, then summed.  Fewer than two rows give 0."""
    n = ext.shape[axis]
    hi, lo = ext.narrow(axis, builtins.min(1, n), builtins.max(n - 1, 0)), ext.narrow(axis, 0, builtins.max(n - 1, 0))
    pair = hi | lo if orred else hi + lo
    if xs is None:
        return torch.sum(pair * (0.5 * dx), dim=axis)
    d = torch.diff(xs, dim=axis if xs.ndim > 1 else 0)
    if xs.ndim == 1 and ext.ndim > 1:
        shape = [1] * ext.ndim
        shape[axis] = d.shape[0]
        d = d.reshape(shape)
    return torch.sum(pair * d * 0.5, dim=axis)


def trapz(y, x=None, dx: float = 1.0, axis: int = -1) -> DNDarray:
    """Trapezoidal-rule integral along ``axis``, by the JAX package's formula
    (neighbour sums in ``y``'s dtype: uint8 wraps as numpy's does, bools
    or).  Along the split axis each rank integrates its rows and the next
    rank's first row, and the ranks' parts are summed (Allreduce)."""
    axis = sanitize_axis(y.shape, axis)
    if isinstance(x, DNDarray) and x.ndim == 1:
        x = torch.as_tensor(x.numpy() if x.is_distributed() else x.larray, device=y.larray.device)
    elif x is not None and not isinstance(x, (DNDarray, torch.Tensor)):
        x = torch.as_tensor(np.asarray(x), device=y.larray.device)
    orred = y.larray.dtype == torch.bool
    if y.split != axis or not y.is_distributed():
        if isinstance(x, DNDarray):
            from ._operations import _localize

            x = _localize(x, y.split, y.ndim, y)
        t = _narrow(_trap(y.larray.to(torch.uint8) if orred else y.larray, axis, x, dx, orred), y.larray)
        split = None if y.split in (None, axis) else y.split - (y.split > axis)
        gshape = y.gshape[:axis] + y.gshape[axis + 1:]
        return DNDarray(t, gshape, types.canonical_heat_type(t.dtype), split, y.device, y.comm, y.balanced)
    y = _balanced(y)
    counts, displs = y.counts_displs()
    rank = y.comm.rank
    t = y.larray.to(torch.uint8) if orred else y.larray  # bools travel as uint8
    nxt = _halo(t, axis, counts, y.comm)
    ext = torch.cat([t, nxt], dim=axis) if nxt is not None else t
    xs = None
    if isinstance(x, DNDarray):  # sample points laid out as y
        x = _balanced(x).larray
        xn = _halo(x, axis, counts, y.comm)
        xs = torch.cat([x, xn], dim=axis) if xn is not None else x
    elif x is not None:
        xs = x[displs[rank]: displs[rank] + ext.shape[axis]]
    part = y.comm.Allreduce(_narrow(_trap(ext, axis, xs, dx, orred), y.larray).contiguous())
    return DNDarray(part, y.gshape[:axis] + y.gshape[axis + 1:], types.canonical_heat_type(part.dtype), None,
                    y.device, y.comm, True)


trapezoid = trapz


def gradient(f: DNDarray, *varargs, axis=None, edge_order: int = 1):
    """Central-difference gradient (numpy semantics, ``edge_order=1``): one
    DNDarray an axis (one for a single axis), each split as ``f``.  Along the
    split axis each rank takes its neighbours' boundary rows."""
    if edge_order != 1:
        raise NotImplementedError("gradient supports edge_order=1 only")
    axes = tuple(range(f.ndim)) if axis is None else sanitize_axis(f.shape, axis)
    single = isinstance(axes, int)
    axes = (axes,) if single else tuple(axes)
    if len(varargs) == 0:
        spacing = [1.0] * len(axes)
    elif len(varargs) == 1:
        spacing = list(varargs) * len(axes)
    else:
        spacing = list(varargs)
    f = _balanced(f) if f.is_distributed() else f
    t = _float(f.larray)
    out = []
    for ax, h in zip(axes, spacing):
        coords = None
        if isinstance(h, (DNDarray, np.ndarray, list, tuple, torch.Tensor)):
            coords = h.numpy() if isinstance(h, DNDarray) else np.asarray(h)
            coords = torch.as_tensor(coords, device=t.device).to(t.dtype)
        if ax != f.split or not f.is_distributed():
            lo, hi, ext = 0, 0, t
            c = coords
        else:
            counts, displs = f.counts_displs()
            rank = f.comm.rank
            prev = _halo(t, ax, counts, f.comm, before=True)
            nxt = _halo(t, ax, counts, f.comm)
            lo, hi = int(prev is not None), int(nxt is not None)
            ext = torch.cat([p for p in (prev, t, nxt) if p is not None], dim=ax)
            c = None if coords is None else coords[displs[rank] - lo: displs[rank] + counts[rank] + hi]
        if ext.shape[ax] == 0:
            g = ext
        else:
            g = torch.gradient(ext, spacing=(c,) if c is not None else float(h), dim=ax, edge_order=1)[0]
            g = g.narrow(ax, lo, ext.shape[ax] - lo - hi)
        out.append(DNDarray(g, f.gshape, types.canonical_heat_type(g.dtype), f.split, f.device, f.comm, f.balanced))
    return out[0] if single or len(out) == 1 else out


def interp(x, xp, fp, left=None, right=None, period=None) -> DNDarray:
    """1-D linear interpolation of ``x`` in the sample points (``xp``,
    ``fp``), which every rank holds whole; the result is split as ``x``."""
    from . import factories

    def whole(a, dev):
        a = a.numpy() if isinstance(a, DNDarray) else np.asarray(a)
        return _float(torch.as_tensor(a, device=dev)).to(torch.float32)

    proto = x if isinstance(x, DNDarray) else (xp if isinstance(xp, DNDarray) else fp)
    if not isinstance(x, DNDarray):
        x = factories.array(x, device=proto.device, comm=proto.comm)
    dev = x.larray.device
    xpt, fpt = whole(xp, dev), whole(fp, dev)

    def fn(q):
        q = _float(q).to(torch.float32)
        px, pf = xpt, fpt
        lo, hi = (pf[0] if left is None else left), (pf[-1] if right is None else right)
        if period is not None:
            q = torch.remainder(q, period)
            px = torch.remainder(px, period)
            order = torch.argsort(px)
            px, pf = px[order], pf[order]
            px = torch.cat([px[-1:] - period, px, px[:1] + period])
            pf = torch.cat([pf[-1:], pf, pf[:1]])
        j = (torch.searchsorted(px, q, right=True) - 1).clamp(0, px.numel() - 2)
        slope = (pf[j + 1] - pf[j]) / (px[j + 1] - px[j])
        res = pf[j] + slope * (q - px[j])
        res = torch.where(q == px[-1], pf[-1], res)
        if period is None:
            res = torch.where(q < px[0], torch.as_tensor(lo, dtype=res.dtype, device=dev), res)
            res = torch.where(q > px[-1], torch.as_tensor(hi, dtype=res.dtype, device=dev), res)
        return res

    return _local_op(fn, x)


__all__ += ["ediff1d", "gradient", "i0", "interp", "nancumprod", "nancumsum", "nextafter", "reciprocal", "spacing"]
__all__ += ["bitwise_count", "bitwise_invert", "bitwise_left_shift", "bitwise_right_shift"]


# ---------------------------------------------------------------------- #
# DNDarray operators and methods
# ---------------------------------------------------------------------- #
def _rbin(fn):
    return lambda self, other: fn(other, self)


def _iop(fn):
    """An in-place operator: the result is written into this array's local
    tensor (cast to its dtype)."""

    def inner(self, other):
        res = fn(self, other)
        if tuple(res.shape) != tuple(self.shape):
            raise ValueError(
                f"output shape {res.shape} of in-place operation does not match the array shape {self.shape} "
                "(in-place broadcasting growth is not allowed)"
            )
        if res.split != self.split:
            res.resplit_(self.split)
        self.larray.copy_(res.larray)
        return self

    return inner


DNDarray.__add__ = lambda self, other: add(self, other)
DNDarray.__radd__ = lambda self, other: add(self, other)
DNDarray.__sub__ = lambda self, other: sub(self, other)
DNDarray.__rsub__ = _rbin(sub)
DNDarray.__mul__ = lambda self, other: mul(self, other)
DNDarray.__rmul__ = lambda self, other: mul(self, other)
DNDarray.__truediv__ = lambda self, other: div(self, other)
DNDarray.__rtruediv__ = _rbin(div)
DNDarray.__floordiv__ = lambda self, other: floordiv(self, other)
DNDarray.__rfloordiv__ = _rbin(floordiv)
DNDarray.__mod__ = lambda self, other: mod(self, other)
DNDarray.__rmod__ = _rbin(mod)
DNDarray.__pow__ = lambda self, other: pow(self, other)
DNDarray.__rpow__ = _rbin(pow)
DNDarray.__divmod__ = lambda self, other: divmod(self, other)
DNDarray.__neg__ = lambda self: neg(self)
DNDarray.__pos__ = lambda self: pos(self)
DNDarray.__and__ = lambda self, other: bitwise_and(self, other)
DNDarray.__rand__ = _rbin(bitwise_and)
DNDarray.__or__ = lambda self, other: bitwise_or(self, other)
DNDarray.__ror__ = _rbin(bitwise_or)
DNDarray.__xor__ = lambda self, other: bitwise_xor(self, other)
DNDarray.__rxor__ = _rbin(bitwise_xor)
DNDarray.__invert__ = lambda self: invert(self)
DNDarray.__lshift__ = lambda self, other: left_shift(self, other)
DNDarray.__rshift__ = lambda self, other: right_shift(self, other)

DNDarray.__iadd__ = _iop(add)
DNDarray.__isub__ = _iop(sub)
DNDarray.__imul__ = _iop(mul)
DNDarray.__itruediv__ = _iop(div)
DNDarray.__ifloordiv__ = _iop(floordiv)
DNDarray.__imod__ = _iop(mod)
DNDarray.__ipow__ = _iop(pow)

DNDarray.add = add
DNDarray.sub = sub
DNDarray.mul = mul
DNDarray.div = div
DNDarray.pow = pow
DNDarray.sum = sum
DNDarray.prod = prod
DNDarray.cumsum = cumsum
DNDarray.cumprod = cumprod
DNDarray.nansum = nansum
DNDarray.fmod = fmod
DNDarray.mod = mod
