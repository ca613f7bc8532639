"""Distributed linear algebra basics (reference: ``heat_tpu/linalg/basics.py``).

``matmul`` keeps the JAX package's result-split table (``_matmul_result_split``)
and runs, for each case, the communication that GSPMD chose there; every
local product is one ``torch.matmul`` (cuBLAS on the card).  ``matmul_summa``
is the SUMMA ring: b's row blocks go round the ranks by ``Isend`` while each
rank multiplies the block it holds, the next block's transfer posted before
this block's product.  Float32 products stay in full float32: nothing here
turns on TF32.  Integer products on the card, where torch has no integer
GEMM, are exact float64 products of 16-bit halves (``_int_matmul``), and a
bool product is the or of ands, as in the JAX package.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..core import types
from ..core._operations import Reduction, _local_op, _narrow, _reduce_op, _wrap
from ..core.dndarray import DNDarray
from ..core.sanitation import sanitize_in

__all__ = [
    "dot",
    "matmul",
    "matmul_summa",
    "matrix_norm",
    "norm",
    "outer",
    "trace",
    "transpose",
    "tril",
    "triu",
    "vdot",
    "vector_norm",
]


def _matmul_result_split(sa: Optional[int], sb: Optional[int], nd_out: int) -> Optional[int]:
    """The JAX package's result-split table for 2-D matmul, as its code has
    it: (None, None) -> None; (0, None), (1, None), (0, 0), (0, 1) -> row;
    (None, 0), (None, 1), (1, 0), (1, 1) -> col."""
    row, col = nd_out - 2, nd_out - 1
    if sa is None and sb is None:
        return None
    if sa == 0 and sb is None:
        return row
    if sa == 1 and sb is None:
        return row
    if sa is None and sb == 0:
        return col if nd_out >= 2 else None
    if sa is None and sb == 1:
        return col
    if sa == 0:
        return row
    return col


# Measured SUMMA-vs-gather winners: {(platform, p): N_cross}, where the ring
# wins for 2-D split0 x split0 products whose smallest dimension is >= N_cross.
# An entry goes in only from a measurement on cards, named in PERF.md; the
# JAX package's ("cpu", 8) entry was measured on its CPU mesh and does not
# carry over.  ("gpu", 4): float32 on four H100s over NCCL
# (scripts/summa_multicard.py), the gather route ahead at 4096^2 and 8192^2,
# the ring 45.04 against 46.90 ms at 16384^2.
_SUMMA_DISPATCH: Dict[Tuple[str, int], int] = {("gpu", 4): 16384}


def _summa_wins(a: DNDarray, b: DNDarray) -> bool:
    """The measured-table test of ``matmul(method='auto')``."""
    if a.ndim != 2 or b.ndim != 2 or a.split != 0 or b.split != 0 or a.comm.size <= 1:
        return False
    cross = _SUMMA_DISPATCH.get((a.device.device_type, a.comm.size))
    return cross is not None and min(*a.shape, *b.shape) >= cross


def _common(x: torch.Tensor, y: torch.Tensor):
    """Both tensors in their promoted dtype (no copy where they agree)."""
    dt = torch.promote_types(x.dtype, y.dtype)
    return x.to(dt), y.to(dt)


@contextlib.contextmanager
def _full_float32():
    """Float32 products, convolutions and recurrent layers in full float32
    inside, whatever the caller set (``torch.set_float32_matmul_precision(
    "high")`` would give TF32 GEMMs, and cuDNN's float32 convolutions and
    RNNs take TF32 by default), through torch's ``fp32_precision`` flags of
    ``backends.cuda.matmul``, ``backends.cudnn.conv`` and
    ``backends.cudnn.rnn``; the caller's settings are restored on the way
    out."""
    flags = [f for f in (torch.backends.cuda.matmul, torch.backends.cudnn.conv,
                         getattr(torch.backends.cudnn, "rnn", None)) if f is not None]
    old = [f.fp32_precision for f in flags]
    for f in flags:
        f.fp32_precision = "ieee"
    try:
        yield
    finally:
        for f, o in zip(flags, old):
            f.fp32_precision = o


# K rows a chunk of ``_int_matmul``: 2K products of 16-bit halves stay below 2^53
_EXACT_K = 1 << 20


def _int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of two integer tensors of one dtype of at most 32 bits,
    wrapping as the JAX package's ``jnp.matmul`` does (modulo 2^32, then to
    the dtype's width), computed exactly from float64 products, since the
    card has no integer GEMM.  Each operand, read as unsigned 32-bit, splits
    into 16-bit halves hi and lo, and a.b = (hi_a.lo_b + lo_a.hi_b).2^16 +
    lo_a.lo_b (mod 2^32): two float64 GEMMs a chunk of ``_EXACT_K`` rows of
    K, each of whose sums of integer products stays below 2^53."""
    dt = a.dtype
    bits = torch.iinfo(dt).bits
    if bits > 32:
        raise TypeError(f"matmul of {dt} operands on the card is not supported: it has no integer GEMM, and the exact "
                        "float64 route covers integers of at most 32 bits")
    kb = 0 if b.ndim == 1 else b.ndim - 2
    acc = None
    for k0 in range(0, max(a.shape[-1], 1), _EXACT_K):
        ak = a.narrow(-1, k0, min(_EXACT_K, a.shape[-1] - k0)).to(torch.int64) & 0xFFFFFFFF
        bk = b.narrow(kb, k0, min(_EXACT_K, b.shape[kb] - k0)).to(torch.int64) & 0xFFFFFFFF
        a_lo, a_hi = (ak & 0xFFFF).double(), (ak >> 16).double()
        b_lo, b_hi = (bk & 0xFFFF).double(), (bk >> 16).double()
        low = torch.matmul(a_lo, b_lo).to(torch.int64)
        mid = torch.matmul(torch.cat([a_hi, a_lo], -1), torch.cat([b_lo, b_hi], kb)).to(torch.int64)
        part = (((mid & 0xFFFF) << 16) + low) & 0xFFFFFFFF
        acc = part if acc is None else (acc + part) & 0xFFFFFFFF
    acc = acc & ((1 << bits) - 1)
    if dt.is_signed:
        acc = torch.where(acc >= 1 << (bits - 1), acc - (1 << bits), acc)
    return acc.to(dt)


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.matmul`` of two tensors of one dtype; an integer product on
    the card, where torch has no integer GEMM, by :func:`_int_matmul`."""
    if a.is_cuda and not (a.is_floating_point() or a.is_complex()):
        return _int_matmul(a, b)
    return torch.matmul(a, b)


def _role(x: DNDarray, k_axis: int) -> Optional[str]:
    """How ``x`` is split as a matmul operand: along its contracted axis
    ``'k'``, its other matrix axis ``'mn'``, or not at all."""
    if not x.is_distributed():
        return None
    if x.split == k_axis:
        return "k"
    return "mn"


def matmul(a: DNDarray, b: DNDarray, allow_resplit: bool = False, method: str = "auto") -> DNDarray:
    """Matrix product of split arrays (numpy ``matmul`` semantics).

    The result's split is the JAX package's (``_matmul_result_split``; 1-D
    operands as its l.158-161).  Each split case runs its own collectives
    around one local ``torch.matmul`` (m: a's rows, k: the contracted axis,
    n: b's columns)::

        a \\ b   None             k (b rows)           n (b cols)
        None    local            partial, RS on col   local
        m       local            SUMMA or gather b    gather b (n)
        k       partial, RS row  partial, RS on col   gather a (k)

    A partial product runs over this rank's K slice (a replicated operand
    sliced to the split one's K range, two split ones on one K map), then
    ``ReduceScatter`` onto the result's split, or an ``Allreduce`` where the
    result is replicated.  An operand split along a batch axis is gathered
    first.  ``method``: ``'auto'`` takes the SUMMA ring for the m x k case
    where ``_SUMMA_DISPATCH`` says it wins on this (platform, p), else the
    gather route; ``'gspmd'`` forces the table's route and ``'summa'`` the
    ring.  ``allow_resplit`` is accepted and ignored, as in the JAX package.
    """
    sanitize_in(a)
    sanitize_in(b)
    if method not in ("auto", "gspmd", "summa"):
        raise ValueError(f"method must be 'auto', 'gspmd' or 'summa', got {method!r}")
    if a.dtype is types.bool and b.dtype is types.bool:  # the or of ands, as in the JAX package
        c = matmul(a.astype(types.int32), b.astype(types.int32), allow_resplit, method)
        return _local_op(lambda t: t != 0, c)
    if method == "summa" or (method == "auto" and _summa_wins(a, b)):
        return matmul_summa(a, b)
    ka, kb = a.ndim - 1, max(b.ndim - 2, 0)
    if a.shape[ka] != b.shape[kb]:
        raise ValueError(f"matmul: shapes {a.shape} and {b.shape} not aligned")
    nd = max(a.ndim, b.ndim) - (a.ndim == 1) - (b.ndim == 1)
    if a.ndim == 1 and b.ndim == 1:
        split = None
    elif a.ndim == 1:
        split = None if b.split is None else (nd - 1 if b.split == b.ndim - 1 else None)
    elif b.ndim == 1:
        split = None if a.split is None else (nd - 1 if a.split == a.ndim - 2 else None)
    else:
        sa = None if a.split is None else (0 if a.split == a.ndim - 2 else (1 if a.split == a.ndim - 1 else None))
        sb = None if b.split is None else (0 if b.split == b.ndim - 2 else (1 if b.split == b.ndim - 1 else None))
        split = _matmul_result_split(sa, sb, nd)
    # an operand split along a batch axis is gathered first
    if a.is_distributed() and a.ndim > 2 and a.split < a.ndim - 2:
        a = a.resplit(None)
    if b.is_distributed() and b.ndim > 2 and b.split < b.ndim - 2:
        b = b.resplit(None)
    ra, rb = _role(a, ka), _role(b, kb)
    comm = a.comm
    gshape = torch.broadcast_shapes(a.gshape[:-2], b.gshape[:-2]) if a.ndim > 1 and b.ndim > 1 else ()
    gshape = tuple(gshape) + ((a.shape[-2],) if a.ndim > 1 else ()) + ((b.shape[-1],) if b.ndim > 1 else ())
    al, bl = _common(a.larray, b.larray)

    if ra is None and rb is None:
        return _wrap(_mm(al, bl), gshape, split, a)
    if ra == "mn" and rb is None:
        return _wrap(_mm(al, bl), gshape, split, a, a.balanced)
    if ra is None and rb == "mn":
        return _wrap(_mm(al, bl), gshape, split, a, b.balanced)
    if ra == "mn" and rb == "mn":  # rows of a, columns of b: gather b's columns
        bl = comm.Allgatherv(bl, b.split, counts=b.counts_displs()[0])
        return _wrap(_mm(al, bl), gshape, split, a, a.balanced)
    if ra == "k" and rb == "mn":  # columns of a (K), columns of b: gather a's K
        al = comm.Allgatherv(al, a.split, counts=a.counts_displs()[0])
        return _wrap(_mm(al, bl), gshape, split, a, b.balanced)
    if ra == "mn" and rb == "k":  # rows of a, rows of b (K): gather b's K
        bl = comm.Allgatherv(bl, b.split, counts=b.counts_displs()[0])
        return _wrap(_mm(al, bl), gshape, split, a, a.balanced)

    # the K axis is split: a partial product over this rank's K slice
    rank = comm.rank
    if ra == "k" and rb == "k":
        ca, cb = a.counts_displs()[0], b.counts_displs()[0]
        if list(ca) != list(cb):
            bl = comm.redistribute(bl, b.split, cb, ca)
    elif ra == "k":
        counts, displs = a.counts_displs()
        bl = bl.narrow(kb, displs[rank], counts[rank])
    else:
        counts, displs = b.counts_displs()
        al = al.narrow(ka, displs[rank], counts[rank])
    partial = _mm(al, bl)
    if split is None:
        return _wrap(comm.Allreduce(partial), gshape, None, a)
    return _wrap(comm.ReduceScatter(partial, axis=split), gshape, split, a)


def matmul_summa(a: DNDarray, b: DNDarray) -> DNDarray:
    """The SUMMA ring for 2-D operands split along rows (others are resplit
    to 0 first): a's row block stays, b's row blocks rotate one rank down
    the ring (``Isend``, shift -1), and each rank adds the product of the
    block it holds with the matching columns of its a rows, taken at the
    block's source rank's displacement.  Blocks of uneven HeAT chunks travel
    zero-padded to the largest (zero K rows add nothing).  The next rotation
    is posted before this step's product, so the transfer overlaps the
    GEMM.  The result is split along rows, as a's."""
    sanitize_in(a)
    sanitize_in(b)
    if a.ndim != 2 or b.ndim != 2:
        raise ValueError("matmul_summa requires 2-D operands")
    (M, K), (K2, N) = a.shape, b.shape
    if K != K2:
        raise ValueError(f"shapes {a.shape} and {b.shape} not aligned")
    a0 = a if a.split == 0 else a.resplit(0)
    b0 = b if b.split == 0 else b.resplit(0)
    comm = a.comm
    al, bl = _common(a0.larray, b0.larray)
    if not comm.is_distributed():
        return _wrap(_mm(al, bl), (M, N), 0, a)
    counts, displs = b0.counts_displs()
    p, rank = comm.size, comm.rank
    width = max(counts)
    rot = bl if bl.shape[0] == width else torch.cat([bl, bl.new_zeros((width - bl.shape[0], N))])
    acc = None
    for step in range(p):
        src = (rank + step) % p
        nxt = comm.Isend(rot, shift=-1) if step + 1 < p else None
        a_cols = al.narrow(1, displs[src], counts[src])
        block = rot.narrow(0, 0, counts[src])
        if acc is None:
            acc = _mm(a_cols, block)
        elif acc.is_floating_point() or acc.is_complex():
            acc.addmm_(a_cols, block)
        else:
            acc.add_(_mm(a_cols, block))
        if nxt is not None:
            rot = nxt.wait()
    return _wrap(acc, (M, N), 0, a, a0.balanced)


def dot(a: DNDarray, b: DNDarray, out: Optional[DNDarray] = None) -> DNDarray:
    """Dot product: 1-D . 1-D gives a scalar (an Allreduce where split);
    else :func:`matmul`."""
    r = matmul(a, b, method="gspmd")
    if out is not None:
        out.larray.copy_(r.larray)
        return out
    return r


def vdot(x1: DNDarray, x2: DNDarray) -> DNDarray:
    """conj(x1) . x2 over the flattened arrays (a replicated scalar)."""
    from ..core import arithmetics

    if x1.shape != x2.shape:
        x1, x2 = x1.resplit(None), x2.resplit(None)
        t = torch.vdot(*_common(x1.larray.reshape(-1), x2.larray.reshape(-1)))
        return _wrap(_narrow(t, x1.larray, x2.larray), (), None, x1)
    conj = _local_op(torch.conj_physical, x1) if issubclass(x1.dtype, types.complexfloating) else x1
    return arithmetics.sum(arithmetics.mul(conj, x2))


def outer(a: DNDarray, b: DNDarray, out=None, split=None) -> DNDarray:
    """Outer product of the flattened vectors; split 0 (a's rows) where an
    input is split and ``split`` is not given.  Each rank builds its chunk
    from its slice of one vector and the other whole."""
    if split is None:
        split = 0 if (a.split is not None or b.split is not None) else None
    n, m = a.size, b.size

    def whole(x):
        return x.resplit(None).larray.reshape(-1) if x.is_distributed() else x.larray.reshape(-1)

    def chunk(x, length):
        if x.is_distributed() and x.ndim == 1 and x.balanced:
            return x.larray
        return whole(x)[a.comm.chunk((length,), 0)[2][0]]

    if split is None or not a.comm.is_distributed():
        u, v = whole(a), whole(b)
    elif split == 0:
        u, v = chunk(a, n), whole(b)
    else:
        u, v = whole(a), chunk(b, m)
    u, v = _common(u, v)
    r = _wrap(torch.outer(u, v), (n, m), split, a)
    if out is not None:
        out.larray.copy_(r.larray)
        return out
    return r


def trace(a: DNDarray, offset: int = 0, axis1: int = 0, axis2: int = 1, dtype=None, out=None) -> DNDarray:
    """Sum along a diagonal (a replicated result).  Split along one of the
    two axes, each rank sums the diagonal's part in its chunk and the parts
    are Allreduced."""
    axis1, axis2 = axis1 % a.ndim, axis2 % a.ndim
    if a.is_distributed() and a.split not in (axis1, axis2):
        a = a.resplit(None)
    t = a.larray
    shift = 0
    if a.is_distributed():
        off = a.counts_displs()[1][a.comm.rank]
        shift = off if a.split == axis1 else -off
    want = torch.int32 if not (t.is_floating_point() or t.is_complex()) else t.dtype
    res = torch.diagonal(t, offset=offset + shift, dim1=axis1, dim2=axis2).sum(-1).to(want)
    if a.is_distributed():
        res = a.comm.Allreduce(res.contiguous())
    if dtype is not None:
        res = res.to(types.canonical_heat_type(dtype).torch_type())
    r = _wrap(res, tuple(res.shape), None, a)
    if out is not None:
        out.larray.copy_(r.larray)
        return out
    return r


def transpose(a: DNDarray, axes=None) -> DNDarray:
    """Permute axes; the split axis moves with its dimension, and each rank
    permutes its own chunk (a copy, no communication)."""
    sanitize_in(a)
    if axes is None:
        axes = tuple(reversed(range(a.ndim)))
    axes = tuple(int(ax) % a.ndim for ax in axes)
    t = a.larray.permute(axes).clone(memory_format=torch.contiguous_format)
    split = axes.index(a.split) if a.split is not None else None
    return _wrap(t, tuple(a.gshape[ax] for ax in axes), split, a, a.balanced)


def _tri(fn, m: DNDarray, k: int) -> DNDarray:
    """``fn`` (tril or triu) of each rank's chunk, the diagonal shifted by
    the chunk's offset along a split matrix axis."""
    shift = 0
    if m.is_distributed() and m.split >= m.ndim - 2:
        off = m.counts_displs()[1][m.comm.rank]
        shift = off if m.split == m.ndim - 2 else -off
    return _wrap(fn(m.larray, diagonal=k + shift), m.gshape, m.split, m, m.balanced)


def tril(m: DNDarray, k: int = 0) -> DNDarray:
    return _tri(torch.tril, m, k)


def triu(m: DNDarray, k: int = 0) -> DNDarray:
    return _tri(torch.triu, m, k)


# ---------------------------------------------------------------------- #
# norms: reductions over the ranks' partials
# ---------------------------------------------------------------------- #
def _absf(t: torch.Tensor) -> torch.Tensor:
    """|t| as a float (float32 for integers and bools)."""
    t = t.abs()
    return t if t.is_floating_point() else t.to(torch.float32)


def _real_float(dt: torch.dtype) -> torch.dtype:
    return torch.empty((), dtype=dt).abs().dtype if dt.is_floating_point or dt.is_complex else torch.float32


def _vector_reduction(ord) -> Tuple[Reduction, Optional[float]]:
    """The reduction of a vector ``ord``-norm and the root taken after it."""
    if ord is None or ord == 2:
        return Reduction(lambda t, d, k: torch.sum(_absf(t) ** 2, dim=d, keepdim=k), "sum", _real_float), 2.0
    if ord == float("inf"):
        return Reduction(lambda t, d, k: torch.amax(_absf(t), dim=d, keepdim=k), "max", _real_float), None
    if ord == float("-inf"):
        return Reduction(lambda t, d, k: torch.amin(_absf(t), dim=d, keepdim=k), "min", _real_float), None
    if ord == 0:
        return Reduction(lambda t, d, k: torch.sum((t != 0).to(torch.float32), dim=d, keepdim=k), "sum",
                         _real_float), None
    if ord == 1:
        return Reduction(lambda t, d, k: torch.sum(_absf(t), dim=d, keepdim=k), "sum", _real_float), None
    p = float(ord)
    return Reduction(lambda t, d, k: torch.sum(_absf(t) ** p, dim=d, keepdim=k), "sum", _real_float), p


def vector_norm(x: DNDarray, axis=None, keepdims: bool = False, ord=2) -> DNDarray:
    """The vector ``ord``-norm over ``axis`` (all axes for None); over the
    split axis the ranks' partial sums (or extrema) are Allreduced."""
    red, root = _vector_reduction(ord)
    res = _reduce_op(red, x, axis=axis, keepdims=keepdims)
    if root is not None:
        res = _local_op(lambda t: t ** (1.0 / root), res)
    return res


def _matrix_norm(x: DNDarray, axis, keepdims: bool, ord) -> DNDarray:
    r0, r1 = (a % x.ndim for a in axis)
    if ord in ("fro", "f"):
        return vector_norm(x, axis=(r0, r1), keepdims=keepdims, ord=2)
    if ord in (1, -1, float("inf"), float("-inf")):
        inner, outer_ax = (r0, r1) if ord in (1, -1) else (r1, r0)
        sums = _reduce_op(Reduction(lambda t, d, k: torch.sum(_absf(t), dim=d, keepdim=k), "sum", _real_float), x,
                          axis=inner, keepdims=keepdims)
        ext = "max" if ord in (1, float("inf")) else "min"
        fn = torch.amax if ext == "max" else torch.amin
        return _reduce_op(Reduction(lambda t, d, k: fn(t, dim=d, keepdim=k), ext), sums,
                          axis=outer_ax if keepdims else outer_ax - (inner < outer_ax), keepdims=keepdims)
    # 2, -2, 'nuc': singular values of whole matrices
    if x.is_distributed() and x.split in (r0, r1):
        x = x.resplit(None)
    t = x.larray if x.larray.is_floating_point() or x.larray.is_complex() else x.larray.to(torch.float32)
    res = torch.linalg.matrix_norm(t, ord=ord, dim=(r0, r1), keepdim=keepdims)
    split = None if x.split in (r0, r1) else x.split
    if split is not None and not keepdims:
        split -= sum(1 for a in (r0, r1) if a < split)
    return _wrap(res, tuple(x.gshape[i] if i not in (r0, r1) else 1 for i in range(x.ndim) if keepdims or
                            i not in (r0, r1)), split, x, x.balanced)


def matrix_norm(x: DNDarray, axis=None, keepdims: bool = False, ord="fro") -> DNDarray:
    """The matrix ``ord``-norm over the two ``axis`` (the last two for None);
    replicated, as in the JAX package."""
    if axis is None:
        if x.ndim < 2:
            raise ValueError("matrix_norm requires at least 2 dimensions")
        axis = (x.ndim - 2, x.ndim - 1)
    res = _matrix_norm(x, axis, keepdims, ord)
    return res.resplit(None) if res.split is not None else res


def norm(x: DNDarray, axis=None, keepdims: bool = False, ord=None) -> DNDarray:
    """Vector or matrix norm (numpy semantics); the result keeps the (shifted)
    split where ``axis`` does not reduce it."""
    if axis is None:
        if ord is None or x.ndim == 1:
            return vector_norm(x, axis=None, keepdims=keepdims, ord=2 if ord is None else ord)
        if x.ndim == 2:
            return _matrix_norm(x, (0, 1), keepdims, ord)
        raise ValueError("Improper number of dimensions to norm.")
    if isinstance(axis, int) or len(axis) == 1:
        return vector_norm(x, axis=axis, keepdims=keepdims, ord=2 if ord is None else ord)
    return _matrix_norm(x, tuple(axis), keepdims, "fro" if ord is None else ord)


DNDarray.__matmul__ = lambda self, other: matmul(self, other)
DNDarray.transpose = transpose
DNDarray.tril = lambda self, k=0: tril(self, k)
DNDarray.triu = lambda self, k=0: triu(self, k)


# ---------------------------------------------------------------------- #
# the rest: determinants and inverses, contractions, products
# ---------------------------------------------------------------------- #
def _float_operand(t: torch.Tensor) -> torch.Tensor:
    """``t`` promoted to a float (float32 for integers, as the reference's
    ``promote_types(dtype, float32)``)."""
    return t if t.is_floating_point() or t.is_complex() else t.to(torch.float64 if t.dtype == torch.int64
                                                                 else torch.float32)


def _square_local(a: DNDarray) -> DNDarray:
    """``a`` with its two matrix axes on every rank: a batch split stays;
    a split along a matrix axis is gathered (the factorization is
    replicated, as the reference's docstrings say)."""
    if a.ndim < 2 or a.shape[-1] != a.shape[-2]:
        raise ValueError("last two dimensions of the array must be square")
    if a.is_distributed() and a.split >= a.ndim - 2:
        return a.resplit(None)
    return a


def det(a: DNDarray) -> DNDarray:
    """Determinant of a (batch of) square matrix: the factorization runs
    replicated; batch axes of a batched input stay split."""
    sanitize_in(a)
    m = _square_local(a)
    with _full_float32():
        res = torch.linalg.det(_float_operand(m.larray))
    split = m.split if m.is_distributed() else None
    gshape = a.gshape[:-2]
    out = _wrap(res, gshape, split, a, m.balanced if split is not None else True)
    if split is None and a.split is not None and a.split < len(gshape):
        from ..core.manipulations import _to_split

        return _to_split(out, a.split)
    return out


def inv(a: DNDarray) -> DNDarray:
    """Inverse of a (batch of) square matrix, split as ``a``: a matrix split
    is gathered, inverted on every rank and cut back to chunks."""
    sanitize_in(a)
    m = _square_local(a)
    with _full_float32():
        res = torch.linalg.inv(_float_operand(m.larray))
    if m.is_distributed() or a.split is None or not a.comm.is_distributed():
        return _wrap(res, a.gshape, a.split, a, m.balanced)
    return _wrap(res[a.comm.chunk(a.gshape, a.split)[2]].contiguous(), a.gshape, a.split, a)


def _parse_einsum(subscripts: str):
    """(input specs, output spec) of ``subscripts``; the implicit output is
    numpy's (the labels seen once, sorted; an ellipsis first)."""
    s = subscripts.replace(" ", "")
    if "->" in s:
        ins, out = s.split("->")
    else:
        ins = s
        flat = ins.replace(",", "").replace(".", "")
        out = "".join(sorted(c for c in set(flat) if flat.count(c) == 1))
        if "." in ins:
            out = "..." + out
    return ins.split(","), out


def _einsum_split(operands, in_list, out_spec) -> Optional[int]:
    """The reference's result split (l.305-330): where the first split
    operand whose split label survives lands in the output; None with an
    ellipsis in the output."""
    if "." in out_spec:
        return None
    for o, spec in zip(operands, in_list):
        if isinstance(o, DNDarray) and o.split is not None and "." not in spec:
            label = spec[o.split] if o.split < len(spec) else None
            if label and label in out_spec:
                return out_spec.index(label)
    return None


# contracted length past which the exact integer einsum on the card would lose bits
_EXACT_EINSUM_K = 1 << 20
# contracted length a float32 product sums in float32; longer ones sum blocks of it in float64
_EINSUM_BLOCK = 1 << 22


def _float_einsum(subscripts: str, ts) -> torch.Tensor:
    """``torch.einsum`` in full float32; where a float32 contraction runs
    over a label longer than ``_EINSUM_BLOCK`` (a Gram over 1e8 rows), the
    blocks of that label are contracted one by one and summed in float64,
    so the result keeps float32's accuracy (one float32 sum over 1e8 terms
    drifts past 1e-5 of the result)."""
    with _full_float32():
        if ts[0].dtype != torch.float32 or "." in subscripts:
            return torch.einsum(subscripts, *ts)
        ins, out = _parse_einsum(subscripts)
        sizes = {c: n for spec, t in zip(ins, ts) for c, n in zip(spec, t.shape)}
        label = max((c for c in sizes if c not in out and all(spec.count(c) <= 1 for spec in ins)),
                    key=lambda c: sizes[c], default=None)
        if label is None or sizes[label] <= _EINSUM_BLOCK:
            return torch.einsum(subscripts, *ts)
        acc = None
        for lo in range(0, sizes[label], _EINSUM_BLOCK):
            n = min(_EINSUM_BLOCK, sizes[label] - lo)
            parts = [t.narrow(spec.index(label), lo, n) if label in spec else t for t, spec in zip(ts, ins)]
            r = torch.einsum(subscripts, *parts).double()
            acc = r if acc is None else acc.add_(r)
        return acc.to(torch.float32)


def _einsum_local(subscripts: str, ts) -> torch.Tensor:
    """``torch.einsum`` of tensors promoted to one dtype (full float32).  On
    the card, which has no integer GEMM, integer operands of at most 32 bits
    contract exactly as float64 products of 16-bit halves (one or two
    operands, a contraction under 2^20), wrapping as the reference's."""
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    ts = [t.to(dt) for t in ts]
    if not (ts[0].is_cuda and not (dt.is_floating_point or dt.is_complex)):
        return _float_einsum(subscripts, ts)
    if dt == torch.bool:
        return _einsum_local(subscripts, [t.to(torch.int32) for t in ts]) != 0
    bits = torch.iinfo(dt).bits
    if bits > 32 or len(ts) > 2:
        raise TypeError(f"einsum of {len(ts)} {dt} operands on the card is not supported: it has no integer GEMM, "
                        "and the exact float64 route covers one or two integer operands of at most 32 bits")
    words = [t.to(torch.int64) & 0xFFFFFFFF for t in ts]
    halves = [((w & 0xFFFF).double(), (w >> 16).double()) for w in words]
    with _full_float32():
        if len(ts) == 1:
            lo, hi = halves[0]
            acc = torch.einsum(subscripts, lo).to(torch.int64) + (torch.einsum(subscripts, hi).to(torch.int64) << 16)
        else:
            (alo, ahi), (blo, bhi) = halves
            k = max(1, ts[0].numel() * ts[1].numel())
            low = torch.einsum(subscripts, alo, blo).to(torch.int64)
            out_n = max(low.numel(), 1)
            if k // out_n > _EXACT_EINSUM_K:
                raise TypeError("integer einsum on the card past a 2^20 contraction is not supported")
            mid = torch.einsum(subscripts, ahi, blo).to(torch.int64) + torch.einsum(subscripts, alo, bhi).to(
                torch.int64)
            acc = ((mid & 0xFFFF) << 16) + low
    acc = acc & ((1 << bits) - 1)
    if dt.is_signed:
        acc = torch.where(acc >= 1 << (bits - 1), acc - (1 << bits), acc)
    return acc.to(dt)


def _einsum(operands, in_list, out_spec: str, split: Optional[int], proto: DNDarray) -> DNDarray:
    """The contraction of ``operands`` (DNDarrays) by ``in_list -> out_spec``
    with the result split along ``split``.  The first distributed operand's
    split label L leads: every operand holding L is brought to the same
    chunks of L (resplit, a replicated one sliced), the others gathered;
    each rank contracts its chunks; where L survives the result is split
    along it, else the partial results are Allreduced (a contraction over
    the split axis never gathers an operand whole)."""
    from ..core.manipulations import _full, _scatter_chunk, _to_split

    sub = ",".join(in_list) + "->" + out_spec
    comm = proto.comm
    label, lead = None, None
    if "." not in sub:
        for o, spec in zip(operands, in_list):
            if o.is_distributed() and spec.count(spec[o.split]) == 1:
                label, lead = spec[o.split], o
                break
    if label is None or not comm.is_distributed():
        res = _einsum_local(sub, [_full(o) for o in operands])
        return _scatter_chunk(proto, res, tuple(res.shape), split)
    counts, displs = lead.counts_displs()
    rank = comm.rank
    local = []
    for o, spec in zip(operands, in_list):
        if spec.count(label) == 1:
            ax = spec.index(label)
            if o.is_distributed():
                o = o if o.split == ax else o.resplit(ax)
                t = o.larray
                if list(o.counts_displs()[0]) != list(counts):
                    t = comm.redistribute(t, ax, o.counts_displs()[0], counts)
            else:
                t = o.larray.narrow(ax, displs[rank], counts[rank])
            local.append(t)
        else:
            local.append(_full(o))
    res = _einsum_local(sub, local)
    sizes = {}
    for o, spec in zip(operands, in_list):
        for c, s in zip(spec, o.gshape):
            sizes[c] = s
    gshape = tuple(sizes[c] for c in out_spec)
    if label in out_spec:
        out = _wrap(res, gshape, out_spec.index(label), proto, lead.balanced)
        return _to_split(out, split)
    res = comm.Allreduce(res.contiguous())
    return _scatter_chunk(proto, res, gshape, split)


def _operands(operands):
    from ..core import factories

    proto = next((o for o in operands if isinstance(o, DNDarray)), None)
    if proto is None:
        raise TypeError("einsum needs at least one DNDarray operand")
    return [o if isinstance(o, DNDarray) else factories.array(np.asarray(o), device=proto.device, comm=proto.comm)
            for o in operands], proto


def einsum(subscripts: str, *operands, out=None) -> DNDarray:
    """Einstein summation of DNDarrays; the result split is the reference's
    (the first split operand's label where the output keeps it).  A label
    contracted over the split axis is a local contraction plus one
    Allreduce."""
    ops, proto = _operands(operands)
    in_list, out_spec = _parse_einsum(subscripts)
    split = _einsum_split(ops, in_list, out_spec)
    if "." in subscripts:
        from ..core.manipulations import _full, _scatter_chunk

        res = _einsum_local(subscripts, [_full(o) for o in ops])
        r = _scatter_chunk(proto, res, tuple(res.shape), split)
    else:
        r = _einsum(ops, in_list, out_spec, split, proto)
    if out is not None:
        out.larray.copy_(r.larray)
        return out
    return r


def einsum_path(subscripts: str, *operands, optimize="greedy"):
    """numpy's contraction plan on the global shapes (no data moves)."""
    hosts = [np.broadcast_to(np.empty((), np.float32), o.shape) if hasattr(o, "shape") else np.asarray(o)
             for o in operands]
    return np.einsum_path(subscripts, *hosts, optimize=optimize)


def _labels(n: int, start: int = 0) -> str:
    return "".join(chr(ord("a") + start + i) for i in range(n))


def tensordot(a: DNDarray, b: DNDarray, axes=2) -> DNDarray:
    """Contraction over ``axes`` (numpy's); split along a's split axis where
    it is free (a's free axes lead the output), else None.  Runs as
    :func:`einsum`."""
    (a, b), proto = _operands([a, b])
    if isinstance(axes, (list, tuple)):
        ax_a, ax_b = axes
        ax_a = [ax_a] if isinstance(ax_a, int) else list(ax_a)
        ax_b = [ax_b] if isinstance(ax_b, int) else list(ax_b)
    else:
        ax_a, ax_b = list(range(a.ndim - int(axes), a.ndim)), list(range(int(axes)))
    ax_a, ax_b = [x % a.ndim for x in ax_a], [x % b.ndim for x in ax_b]
    la = _labels(a.ndim)
    lb = list(_labels(b.ndim, a.ndim))
    for i, j in zip(ax_a, ax_b):
        lb[j] = la[i]
    lb = "".join(lb)
    out_spec = "".join(c for i, c in enumerate(la) if i not in ax_a) + "".join(
        c for j, c in enumerate(lb) if j not in ax_b)
    split = None
    if a.split is not None and a.split not in ax_a:
        split = sum(1 for x in range(a.split) if x not in ax_a)
    return _einsum([a, b], [la, lb], out_spec, split, proto)


def inner(a: DNDarray, b: DNDarray) -> DNDarray:
    """Inner product over the last axes (numpy's); a's split where it is not the last axis."""
    (a, b), proto = _operands([a, b])
    if a.ndim == 0 or b.ndim == 0:
        from ..core import arithmetics

        return arithmetics.mul(a, b)
    la, lb = _labels(a.ndim), _labels(b.ndim, a.ndim)
    lb = lb[:-1] + la[-1]
    split = a.split if a.split is not None and a.split < max(a.ndim - 1, 0) else None
    return _einsum([a, b], [la, lb], la[:-1] + lb[:-1], split, proto)


def kron(a, b) -> DNDarray:
    """Kronecker product; split along a's split axis (each of a's rows
    becomes a contiguous block, so each rank expands its own rows with all
    of b and nothing moves)."""
    from ..core.manipulations import _full

    a, b = _operands([a, b])[0]
    bt = _full(b)
    nd = max(a.ndim, b.ndim)
    split = a.split + (nd - a.ndim) if a.split is not None else None
    res = torch.kron(*_common(a.larray, bt))
    bshape = (1,) * (nd - b.ndim) + tuple(b.gshape)
    ashape = (1,) * (nd - a.ndim) + tuple(a.gshape)
    gshape = tuple(x * y for x, y in zip(ashape, bshape))
    if a.is_distributed():
        c = a.counts_displs()[0]
        counts = [n * bshape[split] for n in c]
        balanced = counts == list(a.comm.counts_displs_shape(gshape, split)[0])
        return _wrap(res, gshape, split, a, balanced)
    if split is not None and a.comm.is_distributed():
        from ..core.manipulations import _scatter_chunk

        return _scatter_chunk(a, res, gshape, split)
    return _wrap(res, gshape, split, a)


def vecdot(x1: DNDarray, x2: DNDarray, axis: int = -1, keepdims: bool = False) -> DNDarray:
    """sum(conj(x1) * x2) along ``axis``, replicated (the reference's)."""
    from ..core import arithmetics

    conj = _local_op(torch.conj_physical, x1) if issubclass(x1.dtype, types.complexfloating) else x1
    res = arithmetics.sum(arithmetics.mul(conj, x2), axis=axis, keepdims=keepdims)
    return res.resplit(None) if res.is_distributed() else _wrap(res.larray, res.gshape, None, res)


def cross(a: DNDarray, b: DNDarray, axisa: int = -1, axisb: int = -1, axisc: int = -1, axis: int = -1) -> DNDarray:
    """The cross product of 2- or 3-vectors along ``axis`` (which, as in the
    reference, overrides ``axisa``/``axisb``/``axisc``); a's split.  Each
    rank crosses its chunks; vectors split along their own axis are
    gathered."""
    from ..core.manipulations import _full, _scatter_chunk, _to_split

    (a, b), proto = _operands([a, b])
    ax_a, ax_b = axis % a.ndim, axis % b.ndim
    local = (a.is_distributed() and a.split != ax_a and b.gshape == a.gshape and
             (b.split == a.split or not b.is_distributed()))
    if local:
        bb = _to_split(b, a.split)
        ta, tb = a.larray, bb.larray
    else:
        ta, tb = _full(a), _full(b)
    ta, tb = _common(ta.movedim(ax_a, -1), tb.movedim(ax_b, -1))
    na, nb = ta.shape[-1], tb.shape[-1]
    if na not in (2, 3) or nb not in (2, 3):
        raise ValueError("incompatible dimensions for cross product (dimension must be 2 or 3)")
    a0, a1 = ta[..., 0], ta[..., 1]
    b0, b1 = tb[..., 0], tb[..., 1]
    if na == 2 and nb == 2:
        res = a0 * b1 - a1 * b0
    else:
        a2 = ta[..., 2] if na == 3 else torch.zeros_like(a0)
        b2 = tb[..., 2] if nb == 3 else torch.zeros_like(b0)
        res = torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], -1)
        res = res.movedim(-1, axis % res.ndim)
    res = res.contiguous()
    if local:
        gshape = list(res.shape)
        split = a.split if res.ndim == a.ndim else (a.split - (1 if a.split > ax_a else 0))
        gshape[split] = a.gshape[a.split]
        out = _wrap(res, tuple(gshape), split, a, a.balanced)
        return _to_split(out, a.split)
    return _scatter_chunk(proto, res, tuple(res.shape), a.split)


def projection(a: DNDarray, b: DNDarray) -> DNDarray:
    """Projection of the vector a onto the vector b."""
    from ..core import arithmetics

    return arithmetics.mul(b, arithmetics.div(dot(a, b), dot(b, b)))


__all__ += ["cross", "det", "einsum", "einsum_path", "inner", "inv", "kron", "projection", "tensordot", "vecdot"]
