"""Statistics (reference: ``heat_tpu/core/statistics.py``).

Moments are reductions of the dispatch core (``_reduce_op``): each rank
reduces its chunk and the ranks' partial sums are Allreduced where the split
axis is reduced; ``var`` and ``std`` combine each rank's ``var_mean`` by
Chan's formula (one Allgather of the counts, means and M2s); the other
centred moments take the mean first (one reduction) and then the sum of
the deviations' powers (another).  An integer or bool mean
is float32 (float64 for a 64-bit operand), and half types accumulate in
float32.  ``argmax`` and ``argmin`` pair each rank's extremum with its
global index and keep the first global index of the extremum, a NaN
winning, as ``jnp.argmax`` does.  ``cov`` centres the observations, takes
one local Gram and Allreduces it.  The histograms count locally (bin
indices by ``searchsorted`` on the reference's float32 edges, counts by
``bincount``, never ``torch.histogram``, which has no CUDA kernel) and
Allreduce the counts: replicated results with numpy's edge rule.  The
percentiles select the order statistics they need: along a split axis by
the exact distributed radix selection of ``parallel.sample_sort`` (the
array is never gathered), elsewhere by a local sort; the positions are
``jnp.quantile``'s float32 arithmetic (float64 past 2^24 elements, where
float32 cannot hold a position).
"""

from __future__ import annotations

import builtins
import math
from typing import Optional

import numpy as np
import torch

from . import types
from ._operations import Reduction, _binary_op, _local_op, _reduce_op, _wrap, _write_out
from .arithmetics import _tensors
from .dndarray import DNDarray
from .indexing import _index_dtype
from .stride_tricks import sanitize_axis

__all__ = [
    "amax",
    "amin",
    "argmax",
    "argmin",
    "average",
    "bincount",
    "bucketize",
    "corrcoef",
    "cov",
    "digitize",
    "fmax",
    "fmin",
    "histc",
    "histogram",
    "histogram2d",
    "histogram_bin_edges",
    "histogramdd",
    "kurtosis",
    "max",
    "maximum",
    "mean",
    "median",
    "min",
    "minimum",
    "nanargmax",
    "nanargmin",
    "nanmax",
    "nanmean",
    "nanmedian",
    "nanmin",
    "nanpercentile",
    "nanquantile",
    "nanstd",
    "nanvar",
    "percentile",
    "ptp",
    "quantile",
    "skew",
    "std",
    "var",
]

_MAX = Reduction(lambda t, d, k: torch.amax(t, dim=d, keepdim=k), "max")
_MIN = Reduction(lambda t, d, k: torch.amin(t, dim=d, keepdim=k), "min")


def max(x, axis=None, out=None, keepdims=False) -> DNDarray:
    """Maximum along ``axis`` (all axes for None)."""
    return _reduce_op(_MAX, x, axis=axis, keepdims=keepdims, out=out)


def min(x, axis=None, out=None, keepdims=False) -> DNDarray:
    """Minimum along ``axis`` (all axes for None)."""
    return _reduce_op(_MIN, x, axis=axis, keepdims=keepdims, out=out)


def maximum(x1, x2, out=None) -> DNDarray:
    """Elementwise maximum of two arrays."""
    return _binary_op(lambda a, b: torch.maximum(*_tensors(a, b)), x1, x2, out=out)


def minimum(x1, x2, out=None) -> DNDarray:
    return _binary_op(lambda a, b: torch.minimum(*_tensors(a, b)), x1, x2, out=out)


amax = max
amin = min


def fmax(t1, t2, out=None) -> DNDarray:
    """Elementwise maximum ignoring NaNs (numpy ``fmax``)."""
    return _binary_op(lambda a, b: torch.fmax(*_tensors(a, b)), t1, t2, out=out)


def fmin(t1, t2, out=None) -> DNDarray:
    """Elementwise minimum ignoring NaNs (numpy ``fmin``)."""
    return _binary_op(lambda a, b: torch.fmin(*_tensors(a, b)), t1, t2, out=out)


# ---------------------------------------------------------------------- #
# moments
# ---------------------------------------------------------------------- #
def _acc(dt: torch.dtype) -> torch.dtype:
    """The dtype a moment accumulates in: float32 (float64, complex128 for a
    64-bit operand; complex64 for complex64)."""
    if dt in (torch.float64, torch.int64, torch.complex128):
        return torch.complex128 if dt.is_complex else torch.float64
    return torch.complex64 if dt.is_complex else torch.float32


def _out_dtype(dt: torch.dtype) -> torch.dtype:
    """A moment's result dtype: a float keeps its own, anything else is
    ``_acc``'s."""
    return dt if dt.is_floating_point or dt.is_complex else _acc(dt)


def _like(x: DNDarray, t: torch.Tensor) -> DNDarray:
    """``t`` (this rank's tensor of ``x``'s local shape) as a DNDarray laid out as ``x``."""
    return DNDarray(t, x.gshape, types.canonical_heat_type(t.dtype), x.split, x.device, x.comm, x.balanced)


def _dims(x: DNDarray, axis):
    axis = sanitize_axis(x.shape, axis)
    return tuple(range(x.ndim)) if axis is None else ((axis,) if isinstance(axis, int) else tuple(axis))


def _count(x: DNDarray, axis) -> int:
    return math.prod(x.gshape[d] for d in _dims(x, axis))


_SUM = Reduction(lambda t, d, k: torch.sum(t, dim=d, keepdim=k), "sum")


def _sum(x: DNDarray, t: torch.Tensor, axis, keepdims: bool) -> DNDarray:
    """The sum of ``t`` (laid out as ``x``) over ``axis``."""
    return _reduce_op(_SUM, _like(x, t), axis=axis, keepdims=keepdims)


def _finish(res: DNDarray, dt: torch.dtype, out=None) -> DNDarray:
    t = res.larray.to(dt)
    if out is not None:
        return _write_out(out, t, res.gshape, res.split, res.device)
    return _wrap(t, res.gshape, res.split, res, res.balanced)


def mean(x, axis=None, keepdims: bool = False) -> DNDarray:
    """Arithmetic mean along ``axis``: the ranks' partial sums Allreduced,
    divided by the count."""
    t = x.larray
    s = _sum(x, t.to(_acc(t.dtype)), axis, keepdims)
    return _finish(_local_op(lambda u: u / builtins.max(_count(x, axis), 0), s), _out_dtype(t.dtype))


def _centered(x: DNDarray, axis, mask=None):
    """(deviations from the mean along ``axis``, count): in the accumulation
    dtype, NaNs (``mask`` True) as 0 and left out of the count."""
    t = x.larray.to(_acc(x.larray.dtype))
    if mask is None:
        mu = _local_op(lambda u: u / _count(x, axis), _sum(x, t, axis, True))
        return t - mu.larray, _count(x, axis)
    t = torch.where(mask, torch.zeros((), dtype=t.dtype, device=t.device), t)
    n = _sum(x, (~mask).to(t.real.dtype if t.is_complex() else t.dtype), axis, True)
    mu = _sum(x, t, axis, True).larray / n.larray
    dev = torch.where(mask, torch.zeros((), dtype=t.dtype, device=t.device), t - mu)
    return dev, n


def _var_chan(x: DNDarray, axis, ddof, keepdims: bool) -> DNDarray:
    """The variance by each rank's ``torch.var_mean`` of its chunk and,
    over the split axis, Chan's combination of the ranks' (count, mean,
    M2) after one Allgather of them (the reference's distributed moments)."""
    t = x.larray.to(_acc(x.larray.dtype))
    dims = _dims(x, axis)
    n_loc = math.prod(t.shape[d] for d in dims)
    kshape = [1 if i in dims else s for i, s in enumerate(t.shape)]
    if n_loc:
        v, m = torch.var_mean(t, dim=dims, correction=0, keepdim=True)
    else:
        v = torch.zeros(kshape, dtype=_real(t.dtype), device=t.device)
        m = torch.zeros(kshape, dtype=t.dtype, device=t.device)
    n = _count(x, axis)
    if x.is_distributed() and x.split in dims:
        comm = x.comm
        counts = torch.tensor([float(n_loc)], dtype=v.dtype, device=t.device)
        ns = torch.cat(comm.Allgather(counts)).reshape([-1] + [1] * t.ndim)
        ms, vs = torch.stack(comm.Allgather(m.contiguous())), torch.stack(comm.Allgather(v.contiguous()))
        mean = (ns * ms).sum(0) / n
        dev = ms - mean
        dev2 = dev.real ** 2 + dev.imag ** 2 if dev.is_complex() else dev * dev
        v = ((ns * vs).sum(0) + (ns * dev2).sum(0)) / n
    v = v * (n / (n - ddof)) if ddof else v
    split = x.split
    new_split = None if split is None or split in dims else (split if keepdims else
                                                             split - sum(1 for d in dims if d < split))
    gshape = [1 if i in dims else s for i, s in enumerate(x.gshape)] if keepdims else \
        [s for i, s in enumerate(x.gshape) if i not in dims]
    if not keepdims:
        v = v.reshape([s for i, s in enumerate(v.shape) if i not in dims])
    return _wrap(v, tuple(gshape), new_split, x, x.balanced if new_split is not None else True)


def _var(x: DNDarray, axis, ddof, keepdims: bool, nan: bool = False) -> DNDarray:
    mask = torch.isnan(x.larray) if nan and (x.larray.is_floating_point() or x.larray.is_complex()) else None
    if mask is None:
        return _var_chan(x, axis, ddof, keepdims)
    dev, n = _centered(x, axis, mask)
    sq = dev.real ** 2 + dev.imag ** 2 if dev.is_complex() else dev * dev
    s = _sum(x, sq, axis, keepdims)
    cnt = n.larray if keepdims else n.larray.squeeze(_dims(x, axis)) if x.ndim else n.larray
    return _local_op(lambda u: u / (cnt - ddof), s)


def _real(dt: torch.dtype) -> torch.dtype:
    return torch.empty((), dtype=dt).real.dtype if dt.is_complex else dt


def var(x, axis=None, ddof: int = 0, keepdims: bool = False, **kwargs) -> DNDarray:
    """Variance with the ``ddof`` correction (the reference's default 0)."""
    return _finish(_var(x, axis, ddof, keepdims), _real(_out_dtype(x.larray.dtype)))


def std(x, axis=None, ddof: int = 0, keepdims: bool = False, **kwargs) -> DNDarray:
    return _finish(_local_op(torch.sqrt, _var(x, axis, ddof, keepdims)), _real(_out_dtype(x.larray.dtype)))


def nanmean(x, axis=None, keepdims: bool = False) -> DNDarray:
    """Mean ignoring NaNs (NaN where a slice holds nothing else)."""
    t = x.larray.to(_acc(x.larray.dtype))
    mask = torch.isnan(t)
    s = _sum(x, torch.where(mask, torch.zeros((), dtype=t.dtype, device=t.device), t), axis, keepdims)
    n = _sum(x, (~mask).to(_real(t.dtype)), axis, keepdims)
    return _finish(_local_op(lambda u: u / n.larray, s), _out_dtype(x.larray.dtype))


def nanvar(x, axis=None, ddof: int = 0, keepdims: bool = False) -> DNDarray:
    return _finish(_var(x, axis, ddof, keepdims, nan=True), _real(_out_dtype(x.larray.dtype)))


def nanstd(x, axis=None, ddof: int = 0, keepdims: bool = False) -> DNDarray:
    return _finish(_local_op(torch.sqrt, _var(x, axis, ddof, keepdims, nan=True)),
                   _real(_out_dtype(x.larray.dtype)))


def _nan_extremum(x, axis, keepdims, out, red: Reduction, fill: float) -> DNDarray:
    t = x.larray
    if not t.is_floating_point():
        return _reduce_op(red, x, axis=axis, keepdims=keepdims, out=out)
    mask = torch.isnan(t)
    m = _reduce_op(red, _like(x, torch.where(mask, torch.tensor(fill, dtype=t.dtype, device=t.device), t)),
                   axis=axis, keepdims=keepdims)
    n = _sum(x, (~mask).to(torch.int64), axis, keepdims)
    res = torch.where(n.larray == 0, torch.tensor(float("nan"), dtype=t.dtype, device=t.device), m.larray)
    return _finish(_wrap(res, m.gshape, m.split, m, m.balanced), t.dtype, out)


def nanmax(x, axis=None, out=None, keepdims=False) -> DNDarray:
    """Maximum ignoring NaNs (NaN for an all-NaN slice)."""
    return _nan_extremum(x, axis, keepdims, out, _MAX, float("-inf"))


def nanmin(x, axis=None, out=None, keepdims=False) -> DNDarray:
    return _nan_extremum(x, axis, keepdims, out, _MIN, float("inf"))


def ptp(x, axis=None, out=None, keepdims=False) -> DNDarray:
    """Peak-to-peak range ``max - min``."""
    hi, lo = max(x, axis=axis, keepdims=keepdims), min(x, axis=axis, keepdims=keepdims)
    res = _local_op(lambda a: a - lo.larray, hi)
    return _finish(res, res.larray.dtype, out)


def _moment_ratio(x, axis, k: int):
    """(m2, m_k) of ``x`` along ``axis``: the mean squared and the mean k-th
    power of the deviations."""
    dev, n = _centered(x, axis)
    m2 = _sum(x, dev * dev, axis, False)
    mk = _sum(x, dev ** k, axis, False)
    return m2.larray / n, mk.larray / n, n, m2


def skew(x, axis=None, unbiased: bool = True) -> DNDarray:
    """Skewness along ``axis`` (the adjusted Fisher-Pearson coefficient
    where ``unbiased``)."""
    m2, m3, n, proto = _moment_ratio(x, axis, 3)
    g1 = m3 / torch.where(m2 == 0, torch.ones_like(m2), m2 ** 1.5)
    if unbiased and n > 2:
        g1 = g1 * math.sqrt(n * (n - 1)) / (n - 2)
    return _wrap(g1.to(_out_dtype(x.larray.dtype)), proto.gshape, proto.split, proto, proto.balanced)


def kurtosis(x, axis=None, unbiased: bool = True, Fischer: bool = True) -> DNDarray:
    """Kurtosis along ``axis`` (Fisher's excess kurtosis where ``Fischer``)."""
    m2, m4, n, proto = _moment_ratio(x, axis, 4)
    g2 = m4 / torch.where(m2 == 0, torch.ones_like(m2), m2 ** 2)
    if unbiased and n > 3:
        g2 = (n - 1) / ((n - 2) * (n - 3)) * ((n + 1) * g2 - 3 * (n - 1)) + 3
    res = g2 - 3.0 if Fischer else g2
    return _wrap(res.to(_out_dtype(x.larray.dtype)), proto.gshape, proto.split, proto, proto.balanced)


def average(x, axis=None, weights=None, returned: bool = False):
    """Weighted average along ``axis``; ``weights`` of ``x``'s shape or, with
    an int ``axis``, 1-D along it.  With ``returned`` also the sum of the
    weights, broadcast to the result's shape."""
    from . import arithmetics, factories, manipulations
    from .manipulations import _to_split

    if weights is None:
        result = mean(x, axis=axis)
        if returned:
            return result, factories.full_like(result, float(_count(x, axis)))
        return result
    if not isinstance(weights, DNDarray):
        weights = factories.array(weights, device=x.device, comm=x.comm)
    if weights.shape != x.shape:
        if axis is None or not isinstance(axis, (int, np.integer)):
            raise TypeError("Axis must be specified when shapes of x and weights differ.")
        if weights.ndim != 1 or weights.shape[0] != x.shape[axis]:
            raise ValueError("Shape of weights not compatible with x.")
        ax = sanitize_axis(x.shape, axis)
        weights = manipulations.reshape(weights, tuple(x.shape[ax] if i == ax else 1 for i in range(x.ndim)))
        if x.split is not None and x.split != ax and weights.split is not None:
            weights = weights.resplit(None)
    dt = _acc(torch.promote_types(x.larray.dtype, weights.larray.dtype))
    xw = arithmetics.mul(x.astype(types.canonical_heat_type(dt)), weights.astype(types.canonical_heat_type(dt)))
    num = arithmetics.sum(xw, axis=axis)
    wb = manipulations.broadcast_to(weights.astype(types.canonical_heat_type(dt)), x.shape)
    den = arithmetics.sum(wb, axis=axis)
    res = _finish(arithmetics.div(num, den), _out_dtype(torch.promote_types(x.larray.dtype, weights.larray.dtype)))
    if returned:
        return res, _to_split(_finish(den, res.larray.dtype), res.split)
    return res


# ---------------------------------------------------------------------- #
# argmax / argmin
# ---------------------------------------------------------------------- #
def _arg(x: DNDarray, axis, keepdims: bool, out, largest: bool, nan: bool) -> DNDarray:
    """The first global index of the extremum along ``axis`` (flat for
    None); a NaN wins (``nan`` False) or is skipped (-1 for an all-NaN
    slice).  Each rank takes its own extremum and its global index; along
    the split axis one Allgather of the (value, index) pairs picks the
    best, the lowest global index among equals."""
    from ..parallel.sample_sort import order_key

    t, comm = x.larray, x.comm
    axis = sanitize_axis(x.shape, axis)
    if t.dtype == torch.bool:
        t = t.to(torch.uint8)
    is_float = t.is_floating_point()
    nanmask = torch.isnan(t) if nan and is_float else None
    if nanmask is not None:
        t = torch.where(nanmask, torch.tensor(float("-inf") if largest else float("inf"), dtype=t.dtype,
                                              device=t.device), t)
    fn = torch.argmax if largest else torch.argmin
    dist = x.is_distributed()
    off = x.counts_displs()[1][comm.rank] if dist else 0
    lv = li = None
    if axis is None:
        flat = t.reshape(-1)
        if flat.numel():
            pos = int(fn(flat))
            coords = list(np.unravel_index(pos, t.shape)) if t.ndim else []
            if dist:
                coords[x.split] += off
            lv = flat[pos]
            li = torch.tensor(int(np.ravel_multi_index(coords, x.gshape)) if x.ndim else 0, device=t.device)
        reduced, new_split = dist, None
        gshape = (1,) * x.ndim if keepdims else ()
    else:
        if t.shape[axis]:
            pos = fn(t, dim=axis, keepdim=True)
            lv = torch.gather(t, axis, pos).squeeze(axis)
            li = pos.squeeze(axis) + (off if x.split == axis else 0)
        reduced = dist and x.split == axis
        new_split = None if x.split is None or x.split == axis else (
            x.split if keepdims or x.split < axis else x.split - 1)
        gshape = tuple(1 if i == axis else s for i, s in enumerate(x.gshape)) if keepdims else \
            tuple(s for i, s in enumerate(x.gshape) if i != axis)
    if reduced:
        lshape = [s for i, s in enumerate(t.shape) if i != axis] if axis is not None else []
        have = torch.tensor([lv is not None], device=t.device)
        if lv is None:
            lv = torch.zeros(lshape, dtype=t.dtype, device=t.device)
            li = torch.zeros(lshape, dtype=torch.int64, device=t.device)
        rows = torch.cat(comm.Allgather(have)).cpu()
        vals = torch.stack(comm.Allgather(lv.contiguous()))[rows]
        idxs = torch.stack(comm.Allgather(li.to(torch.int64).contiguous()))[rows]
        key = order_key(vals) if is_float else vals.to(torch.int64)
        if is_float and not largest:  # a NaN beats every number in argmin too
            key = torch.where(torch.isnan(vals), torch.iinfo(torch.int64).min, key)
        best = (key.amax(0) if largest else key.amin(0)).unsqueeze(0)
        li = torch.where(key == best, idxs, torch.iinfo(torch.int64).max).amin(0)  # the lowest global index
    res = li.to(torch.int64)
    if nanmask is not None:
        n = _reduce_op(_SUM, _like(x, (~nanmask).to(torch.int64)), axis=axis, keepdims=False)
        res = torch.where(n.larray.reshape(res.shape) == 0, torch.full_like(res, -1), res)
    if keepdims:
        res = res.reshape(gshape) if axis is None else res.unsqueeze(axis)
    res = res.to(_index_dtype((x.gshape[axis] if axis is not None else x.size) - 1))
    if out is not None:
        return _write_out(out, res, gshape, new_split, x.device)
    return _wrap(res, gshape, new_split, x, x.balanced if new_split is not None else True)


def argmax(x, axis=None, out=None, keepdims=False) -> DNDarray:
    """Index of the maximum (global; a NaN wins; the first of equals)."""
    return _arg(x, axis, keepdims, out, True, False)


def argmin(x, axis=None, out=None, keepdims=False) -> DNDarray:
    return _arg(x, axis, keepdims, out, False, False)


def nanargmax(x, axis=None, out=None, keepdims=False) -> DNDarray:
    """Index of the maximum ignoring NaNs (-1 for an all-NaN slice)."""
    return _arg(x, axis, keepdims, out, True, True)


def nanargmin(x, axis=None, out=None, keepdims=False) -> DNDarray:
    return _arg(x, axis, keepdims, out, False, True)


# ---------------------------------------------------------------------- #
# covariance
# ---------------------------------------------------------------------- #
# observations a rank centres at once for cov's Gram (its float32 sums stay short: see linalg.basics._float_einsum)
_GRAM_BLOCK = 1 << 22


def cov(m, y=None, rowvar: bool = True, bias: bool = False, ddof: Optional[int] = None) -> DNDarray:
    """Covariance matrix of the variables (rows, or columns where not
    ``rowvar``), replicated.  Each rank centres its observations by the
    global mean, takes the local Gram and the Grams are Allreduced; an array
    split along its variables is resplit along its observations first."""
    from . import factories, manipulations

    if m.ndim > 2:
        raise ValueError("m has more than 2 dimensions")
    x = manipulations.atleast_2d(m)
    if not rowvar and x.shape[0] != 1:
        x = manipulations.swapaxes(x, 0, 1)
    if y is not None:
        if not isinstance(y, DNDarray):
            y = factories.array(y, device=m.device, comm=m.comm)
        yy = manipulations.atleast_2d(y)
        if not rowvar and yy.shape[0] != 1:
            yy = manipulations.swapaxes(yy, 0, 1)
        x = manipulations.concatenate([x, yy], axis=0)
    if ddof is None:
        ddof = 0 if bias else 1
    if x.is_distributed() and x.split == 0:
        x = x.resplit(1)
    dt = _acc(x.larray.dtype)
    n = x.shape[1]
    t = x.larray.to(dt)
    mu = _sum(x, t, 1, True).larray / n
    from ..linalg.basics import _float_einsum

    g = None
    for lo in range(0, t.shape[1], _GRAM_BLOCK):  # the centred observations a block at a time
        c = t[:, lo:lo + _GRAM_BLOCK] - mu
        part = _float_einsum("io,jo->ij", [c, c.conj()])
        g = part if g is None else g + part.to(g.dtype)
        if g.dtype == torch.float32:
            g = g.double()  # blocks summed in float64
        elif g.dtype == torch.complex64:
            g = g.to(torch.complex128)
    if g is None:
        g = torch.zeros((t.shape[0], t.shape[0]), dtype=dt, device=t.device)
    g = g.to(dt)
    if x.is_distributed():
        g = x.comm.Allreduce(g.contiguous())
    g = g / builtins.max(n - ddof, 0)
    g = g.to(_out_dtype(m.larray.dtype))
    return _wrap(g, tuple(g.shape), None, m)


def corrcoef(m, y=None, rowvar: bool = True) -> DNDarray:
    """Pearson correlation coefficients, normalised from :func:`cov` and
    clipped to [-1, 1]."""
    if isinstance(m, DNDarray) and m.ndim == 1 and y is None:
        dt = _out_dtype(m.larray.dtype)
        return _wrap(torch.ones((), dtype=dt, device=m.larray.device), (), None, m)
    c = cov(m, y=y, rowvar=rowvar).larray
    d = torch.sqrt(torch.diagonal(c))
    res = c / torch.outer(d, d)
    if res.is_complex():
        res = torch.complex(res.real.clamp(-1, 1), res.imag.clamp(-1, 1))
    else:
        res = res.clamp(-1.0, 1.0)
    return _wrap(res, tuple(res.shape), None, m)


# ---------------------------------------------------------------------- #
# counts and histograms: local counts, one Allreduce, replicated results
# ---------------------------------------------------------------------- #
def _whole(a, proto: DNDarray) -> torch.Tensor:
    """``a`` (a DNDarray, gathered where split, or an array-like) as a tensor on ``proto``'s device."""
    if isinstance(a, DNDarray):
        return (a.resplit(None) if a.is_distributed() else a).larray.to(proto.larray.device)
    return torch.as_tensor(np.asarray(a), device=proto.larray.device)


def _local_part(w, x: DNDarray) -> torch.Tensor:
    """This rank's part of ``w`` (``x``'s shape): its local tensor where it is
    laid out as ``x``, else the slice of ``x``'s chunk."""
    if isinstance(w, DNDarray):
        if w.split == x.split and w.lshape == x.lshape:
            return w.larray
        w = _whole(w, x)
    else:
        w = torch.as_tensor(np.asarray(w), device=x.larray.device)
    if x.is_distributed():
        counts, displs = x.counts_displs()
        w = w.narrow(x.split, displs[x.comm.rank], counts[x.comm.rank])
    return w


def _allreduce(x: DNDarray, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
    return x.comm.Allreduce(t.contiguous(), op) if x.is_distributed() else t


def _global_extreme(x: DNDarray, t: torch.Tensor, largest: bool):
    """The global max (min) of ``t`` (this rank's values of ``x``), as a
    0-d tensor; NaN propagates."""
    flat = t.reshape(-1)
    if flat.numel():
        v = flat.max() if largest else flat.min()
        if flat.is_floating_point() and torch.isnan(flat).any():
            v = torch.tensor(float("nan"), dtype=flat.dtype, device=flat.device)
    else:
        v = torch.tensor(float("-inf") if largest else float("inf"), device=flat.device).to(flat.dtype)
    if x.is_distributed():
        both = torch.stack(x.comm.Allgather(v.reshape(1))).reshape(-1)
        if both.is_floating_point() and torch.isnan(both).any():
            return torch.tensor(float("nan"), dtype=both.dtype, device=both.device)
        return both.max() if largest else both.min()
    return v


def bincount(x, weights=None, minlength: int = 0) -> DNDarray:
    """Occurrences of each value of a non-negative int array (weighted with
    ``weights``), replicated: the length from the global maximum, local
    ``bincount``s Allreduced."""
    t = x.larray.reshape(-1)
    length = int(_global_extreme(x, x.larray.to(torch.int64), True).item()) + 1 if x.size else 0
    length = builtins.max(length, minlength)
    w = None
    if weights is not None:
        w = _local_part(weights, x).reshape(-1)
        w = w.to(_acc(w.dtype)) if not w.is_floating_point() else w
    res = torch.bincount(t.to(torch.int64), weights=w, minlength=length)
    res = res.to(torch.int32) if w is None else res
    return _wrap(_allreduce(x, res), (length,), None, x)


def bucketize(x, boundaries, right: bool = False, out=None) -> DNDarray:
    """The bucket of each element: ``searchsorted(boundaries, x, side)``
    with side 'left' (``right`` False) or 'right', int32."""
    b = _whole(boundaries, x).contiguous()
    side = "right" if right else "left"
    return _local_op(lambda a: torch.searchsorted(b, a.contiguous(), side=side).to(torch.int32), x, out=out)


def digitize(x, bins, right: bool = False) -> DNDarray:
    """numpy's ``digitize``: the bin of each element, for increasing or
    decreasing ``bins``, int32."""
    b = _whole(bins, x).contiguous()
    side = "right" if not right else "left"

    def fn(a):
        a = a.contiguous()
        if b.numel() == 0 or bool(b[-1] >= b[0]):
            return torch.searchsorted(b, a, side=side).to(torch.int32)
        return (b.numel() - torch.searchsorted(b.flip(0), a, side=side)).to(torch.int32)

    return _local_op(fn, x)


def _float_dt(dt: torch.dtype) -> torch.dtype:
    return dt if dt.is_floating_point else (torch.float64 if dt == torch.int64 else torch.float32)


def _linspace(lo: torch.Tensor, hi: torch.Tensor, num: int) -> torch.Tensor:
    """``jnp.linspace(lo, hi, num)`` in ``lo``'s dtype: lo (1 - s) + hi s for
    s = i / (num - 1), the endpoint exact."""
    div = num - 1
    step = torch.arange(div, dtype=lo.dtype, device=lo.device) / div
    return torch.cat([lo * (1 - step) + hi * step, hi.reshape(1)])


def _edges(x: DNDarray, t: torch.Tensor, bins, range) -> torch.Tensor:
    """The reference's bin edges of ``x`` (this rank's values ``t``): the
    given edges, or ``bins + 1`` float edges over ``range`` (the global
    min and max where None; a range of one value widened by 0.5)."""
    dt = _float_dt(t.dtype)
    if np.ndim(bins) == 1 or isinstance(bins, (DNDarray, torch.Tensor)):
        return _whole(bins, x).to(dt)
    if range is None:
        lo, hi = _global_extreme(x, t, False).to(dt), _global_extreme(x, t, True).to(dt)
    else:
        lo = torch.tensor(float(range[0]), dtype=dt, device=t.device)
        hi = torch.tensor(float(range[1]), dtype=dt, device=t.device)
    if bool(hi - lo == 0):
        lo, hi = lo - 0.5, hi + 0.5
    return _linspace(lo, hi, int(bins) + 1)


def _bin_index(a: torch.Tensor, edges: torch.Tensor, last_down: bool) -> torch.Tensor:
    """numpy's bin of each value: ``searchsorted`` right, the last edge
    itself in the last bin; 0 below the first edge, len(edges) above the
    last (and for NaN)."""
    idx = torch.searchsorted(edges.contiguous(), a.contiguous(), side="right")
    top = a == edges[-1]
    return torch.where(top, idx - 1 if last_down else torch.full_like(idx, edges.numel() - 1), idx)


def histogram_bin_edges(x, bins=10, range=None, weights=None) -> DNDarray:
    """The reference's bin edges (float32 for a 32-bit or narrower ``x``), replicated."""
    e = _edges(x, x.larray, bins, range)
    return _wrap(e, tuple(e.shape), None, x)


def histogram(x, bins=10, range=None, weights=None, density=None):
    """(counts, edges) over the global array, replicated: the counts in
    ``x``'s dtype (or the weights'), numpy's edge rule."""
    t = x.larray.reshape(-1)
    edges = _edges(x, t, bins, range)
    nb = edges.numel() - 1
    w = _local_part(weights, x).reshape(-1) if weights is not None else None
    dt = _float_dt(t.dtype if w is None else torch.promote_types(t.dtype, w.dtype))
    idx = _bin_index(t.to(edges.dtype), edges, False)
    keep = (idx >= 1) & (idx <= nb)
    ww = w[keep].to(torch.float64) if w is not None else None
    counts = torch.bincount(idx[keep] - 1, weights=ww, minlength=nb)[:nb]
    counts = _allreduce(x, counts.to(torch.float64 if w is not None else torch.int64))
    if density:
        counts = counts.to(edges.dtype) / counts.sum().to(edges.dtype) / torch.diff(edges)
    else:
        counts = counts.to(dt)
    return _wrap(counts, (nb,), None, x), _wrap(edges, tuple(edges.shape), None, x)


def histc(x, bins: int = 100, min: float = 0.0, max: float = 0.0, out=None) -> DNDarray:
    """torch's ``histc`` with the reference's rule: ``bins`` equal bins over
    [min, max] (the data's range where both are 0), counts in ``x``'s dtype."""
    rng = None if float(min) == 0.0 and float(max) == 0.0 else (min, max)
    if rng is None:
        t = x.larray
        rng = (float(_global_extreme(x, t, False)), float(_global_extreme(x, t, True)))
    h, _ = histogram(x, bins=bins, range=rng)
    res = h.larray.to(x.larray.dtype)
    if out is not None:
        return _write_out(out, res, h.gshape, None, x.device)
    return _wrap(res, h.gshape, None, x)


def histogramdd(sample, bins=10, range=None, weights=None, density=None):
    """numpy's ``histogramdd`` of an (N, D) sample, replicated: (counts,
    list of D edge arrays)."""
    from . import factories

    if not isinstance(sample, DNDarray):
        sample = factories.array(np.asarray(sample))
    x = sample
    if x.is_distributed() and x.split != 0:
        x = x.resplit(0)
    t = x.larray
    n_dim = x.shape[1]
    try:
        per_dim = list(bins)
        if len(per_dim) != n_dim:
            raise ValueError("should be a bin for each dimension.")
    except TypeError:
        per_dim = [bins] * n_dim
    dt = _float_dt(t.dtype)
    w = _local_part(weights, x).reshape(-1) if weights is not None else None
    if w is not None:
        dt = _float_dt(torch.promote_types(dt, w.dtype))
    proto_col = lambda i: DNDarray(t[:, i].contiguous(), (x.shape[0],), x.dtype, x.split if x.split == 0 else None,
                                   x.device, x.comm, x.balanced)
    edges, flat = [], None
    nbins = []
    for i in builtins.range(n_dim):
        col = t[:, i].to(dt)
        e = _edges(proto_col(i), col, per_dim[i], None if range is None else range[i]).to(dt)
        idx = _bin_index(col, e, True)
        edges.append(e)
        nb = e.numel() + 1
        flat = idx if flat is None else flat * nb + idx
        nbins.append(nb)
    ww = w.to(torch.float64) if w is not None else None
    total = math.prod(nbins)
    h = torch.bincount(flat, weights=ww, minlength=total)[:total] if flat is not None else torch.zeros(
        total, device=t.device)
    h = _allreduce(x, h.to(torch.float64))
    h = h.reshape(nbins)[tuple(slice(1, -1) for _ in nbins)].to(dt if w is not None or density else torch.int32)
    if density:
        h = h.to(dt) / h.sum().to(dt)
        for i, e in enumerate(edges):
            shape = [1] * n_dim
            shape[i] = -1
            h = h / torch.diff(e).reshape(shape)
    res = _wrap(h.contiguous(), tuple(h.shape), None, x)
    return res, [_wrap(e, tuple(e.shape), None, x) for e in edges]


def histogram2d(x, y, bins=10, range=None, weights=None, density=None):
    """numpy's ``histogram2d``: (counts, x edges, y edges), replicated."""
    from . import manipulations

    try:
        n = len(bins)
    except TypeError:
        n = 1
    if n != 1 and n != 2:
        bins = [bins, bins]
    h, e = histogramdd(manipulations.stack([x, y], axis=1), bins, range, weights, density)
    return h, e[0], e[1]


# ---------------------------------------------------------------------- #
# percentiles
# ---------------------------------------------------------------------- #
_METHODS = ("linear", "lower", "higher", "midpoint", "nearest")


def _positions(q: torch.Tensor, n, float64: bool):
    """``jnp.quantile``'s positions of the fractions ``q`` in ``n`` sorted
    values: (low, high, high weight), in float32 (float64 where asked)."""
    dt = torch.float64 if float64 else torch.float32
    pos = q.to(dt) * (n - 1 if not isinstance(n, torch.Tensor) else (n.to(dt) - 1))
    low, high = torch.floor(pos), torch.ceil(pos)
    hw = pos - low
    top = (n - 1) if not isinstance(n, torch.Tensor) else (n.to(dt) - 1)
    low = torch.clamp(low, min=0)
    high = torch.clamp(high, min=0)
    if isinstance(top, torch.Tensor):
        low, high = torch.minimum(low, top).clamp(min=0), torch.minimum(high, top).clamp(min=0)
    else:
        low, high = low.clamp(max=top), high.clamp(max=top)
    return low.to(torch.int64), high.to(torch.int64), hw


def _combine(lv: torch.Tensor, hv: torch.Tensor, hw: torch.Tensor, method: str) -> torch.Tensor:
    if method == "linear":
        return lv * (1 - hw) + hv * hw
    if method == "lower":
        return lv
    if method == "higher":
        return hv
    if method == "nearest":
        return torch.where(hw <= 0.5, lv, hv)
    return (lv + hv) * 0.5


def _fractions(q, x: DNDarray, scale: float, via_percent: bool):
    """(float32 fractions tensor, q's shape): ``q / scale`` as the reference
    computes it; ``via_percent`` rounds a fraction through percent first
    (``quantile`` calls ``percentile(q * 100)``)."""
    if isinstance(q, DNDarray):
        qa = q.numpy().astype(np.float32)
    else:
        qa = np.asarray(q)
    shape = qa.shape
    if via_percent:
        qa = (qa.astype(np.float32) * 100.0) if qa.ndim else np.float32(float(qa) * 100.0)
        scale = 100.0
    qf = np.asarray(qa, dtype=np.float32)
    if qf.ndim > 1:
        raise ValueError(f"q must be have rank <= 1, got shape {qf.shape}")
    qt = torch.as_tensor(qf.reshape(-1), device=x.larray.device)
    if scale != 1.0:
        qt = qt / torch.tensor(scale, dtype=torch.float32, device=qt.device)
    return qt, shape


def _quantile(x: DNDarray, qt: torch.Tensor, qshape, axis, method: str, keepdims: bool, nan: bool) -> DNDarray:
    if method not in _METHODS:
        raise ValueError("method can only be 'linear', 'lower', 'higher', 'midpoint', or 'nearest'")
    axis = sanitize_axis(x.shape, axis)
    vdt = torch.float64 if x.larray.dtype in (torch.float64, torch.int64) else torch.float32
    nq = qt.numel()
    if axis is None or x.ndim == 1:
        res = _quantile_flat(x, qt, method, nan, vdt)  # (nq,)
        shape = (nq,) + ((1,) * x.ndim if keepdims else ())
        res = res.reshape(shape)
    else:
        if isinstance(axis, tuple):
            raise NotImplementedError("percentiles over several axes")
        y = x
        if y.is_distributed() and y.split == axis:
            other = next(i for i in range(y.ndim) if i != axis)
            y = y.resplit(other)
        t = y.larray.to(vdt)
        res = _quantile_local(t, qt, axis, method, nan)  # (nq, *reduced local)
        if keepdims:
            res = res.unsqueeze(axis + 1)
        if y.is_distributed():
            s = y.split + 1 if (keepdims or y.split < axis) else y.split
            res = y.comm.Allgatherv(res.contiguous(), s, counts=y.counts_displs()[0])
        shape = tuple(res.shape)
    if not qshape:
        res = res[0]
        shape = shape[1:]
    return _wrap(res.contiguous(), shape, None, x)


def _quantile_local(t: torch.Tensor, qt: torch.Tensor, axis: int, method: str, nan: bool) -> torch.Tensor:
    """Quantiles of ``t`` along ``axis`` (all of it on this rank): a sort,
    then the reference's positions; (nq, *other axes)."""
    s = torch.sort(t, dim=axis).values.movedim(axis, -1)  # NaN last
    n = s.shape[-1]
    isn = torch.isnan(s)
    if nan:
        cnt = (~isn).sum(-1)
        low, high, hw = _positions(qt.reshape(-1, *([1] * (s.ndim - 1))), cnt.unsqueeze(0), n - 1 >= 2**24)
    else:
        low, high, hw = _positions(qt, n, n - 1 >= 2**24)
        low = low.reshape(-1, *([1] * (s.ndim - 1))).expand(-1, *s.shape[:-1])
        high = high.reshape(-1, *([1] * (s.ndim - 1))).expand(-1, *s.shape[:-1])
        hw = hw.reshape(-1, *([1] * (s.ndim - 1)))
    se = s.unsqueeze(0).expand(qt.numel(), *s.shape)
    lv = torch.gather(se, -1, low.unsqueeze(-1)).squeeze(-1)
    hv = torch.gather(se, -1, high.unsqueeze(-1)).squeeze(-1)
    res = _combine(lv, hv, hw.to(lv.dtype), method)
    if not nan:
        res = torch.where(isn.any(-1).unsqueeze(0), torch.tensor(float("nan"), dtype=res.dtype, device=res.device),
                          res)
    return res


def _quantile_flat(x: DNDarray, qt: torch.Tensor, method: str, nan: bool, vdt) -> torch.Tensor:
    """Quantiles of all of ``x``: the order statistics at the reference's
    positions, selected exactly over the ranks (never gathered)."""
    from ..parallel.sample_sort import ALONE, order_statistics_1d

    t = x.larray.to(vdt).reshape(-1)
    comm = x.comm if x.is_distributed() else ALONE
    counts = torch.tensor([t.numel(), int(torch.isnan(t).sum())], dtype=torch.int64, device=t.device)
    counts = comm.Allreduce(counts) if comm.is_distributed() else counts
    n, n_nan = (int(v) for v in counts.tolist())
    valid = n - n_nan if nan else n
    nanv = torch.full((qt.numel(),), float("nan"), dtype=vdt, device=t.device)
    if (n_nan and not nan) or valid == 0:
        return nanv
    low, high, hw = _positions(qt, valid, valid - 1 >= 2**24)
    ranks = sorted(set(low.tolist()) | set(high.tolist()))
    vals = order_statistics_1d(comm, t, ranks)
    where = {r: i for i, r in enumerate(ranks)}
    lv = vals[torch.tensor([where[r] for r in low.tolist()], device=vals.device)]
    hv = vals[torch.tensor([where[r] for r in high.tolist()], device=vals.device)]
    return _combine(lv, hv, hw.to(vdt).to(vals.device), method)




def _result(res: DNDarray, out):
    if out is not None:
        return _write_out(out, res.larray, res.gshape, None, res.device)
    return res


def percentile(x, q, axis=None, out=None, interpolation: str = "linear", keepdims: bool = False) -> DNDarray:
    """q-th percentile(s) along ``axis`` (q in [0, 100]; every method of
    ``jnp.percentile``), replicated.  Over a split axis the order
    statistics are selected exactly across the ranks; along another axis
    each rank sorts its chunk."""
    qt, qshape = _fractions(q, x, 100.0, False)
    if bool(((qt < 0) | (qt > 1)).any()):
        raise ValueError("Percentiles must be in the range [0, 100]")
    return _result(_quantile(x, qt, qshape, axis, interpolation, keepdims, False), out)


def quantile(x, q, axis=None, out=None, interpolation: str = "linear", keepdims: bool = False) -> DNDarray:
    """q-th quantile(s) (q in [0, 1]): ``percentile(x, q * 100)``, as the reference."""
    qt, qshape = _fractions(q, x, 100.0, True)
    return _result(_quantile(x, qt, qshape, axis, interpolation, keepdims, False), out)


def median(x, axis=None, keepdims: bool = False) -> DNDarray:
    """Median: ``percentile(x, 50)``."""
    return percentile(x, 50.0, axis=axis, keepdims=keepdims)


def nanpercentile(x, q, axis=None, keepdims: bool = False, interpolation: str = "linear") -> DNDarray:
    qt, qshape = _fractions(q, x, 100.0, False)
    return _quantile(x, qt, qshape, axis, interpolation, keepdims, True)


def nanquantile(x, q, axis=None, keepdims: bool = False, interpolation: str = "linear") -> DNDarray:
    qt, qshape = _fractions(q, x, 1.0, False)
    return _quantile(x, qt, qshape, axis, interpolation, keepdims, True)


def nanmedian(x, axis=None, keepdims: bool = False) -> DNDarray:
    return nanquantile(x, 0.5, axis=axis, keepdims=keepdims)


DNDarray.argmax = argmax
DNDarray.argmin = argmin
DNDarray.max = max
DNDarray.min = min
DNDarray.mean = mean
DNDarray.var = var
DNDarray.std = std
DNDarray.average = average
DNDarray.median = median
DNDarray.percentile = percentile
DNDarray.kurtosis = kurtosis
DNDarray.skew = skew
