"""Pairwise distances (reference: ``heat_tpu/spatial/distance.py``).

The result's split is the JAX package's: 0 where x is split along its rows,
else 1 where y is, else replicated.  A split-0 result holds this rank's rows
of x against all of y (y gathered by ``Allgatherv``), a split-1 result all
of x against this rank's rows of y; an operand split along its columns is
gathered first.  ``cdist_ring`` keeps x's rows where they are and sends y's
row blocks round the ranks (``Isend``), so that each rank holds one block
of y at a time.

The local distances take the JAX package's two forms: the quadratic
expansion ||x||^2 + ||y||^2 - 2 x.y^T (one GEMM, in full float32 whatever the
caller's matmul precision, clamped at 0), and the direct form, which
``torch.cdist`` computes without the GEMM and without the (n, m, d)
difference that the JAX code broadcasts.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..core import types
from ..core.dndarray import DNDarray
from ..core.sanitation import sanitize_in
from ..linalg.basics import _common, _full_float32

__all__ = ["cdist", "cdist_ring", "cdist_small", "manhattan", "rbf"]


def _sq_euclid(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Squared distances by the quadratic expansion, clamped at 0: the GEMM
    writes -2 x.y^T + ||y||^2 into the result, which then takes ||x||^2 in place."""
    yy = (y * y).sum(1).unsqueeze(0)
    with _full_float32():
        d2 = torch.addmm(yy, x, y.T, alpha=-2.0)
    return d2.add_((x * x).sum(1, keepdim=True)).clamp_min_(0.0)


def _euclid(quadratic_expansion: bool) -> Callable:
    if quadratic_expansion:
        return lambda x, y: _sq_euclid(x, y).sqrt_()
    return lambda x, y: torch.cdist(x, y, p=2.0, compute_mode="donot_use_mm_for_euclid_dist")


def _whole(a: DNDarray) -> torch.Tensor:
    return (a.resplit(None) if a.is_distributed() else a).larray


def _pairwise(x: DNDarray, y: Optional[DNDarray], fn: Callable, integral: bool = False) -> DNDarray:
    """``fn`` of the rows of x against the rows of y (x's own where y is
    None), laid out by the JAX package's result split.  ``fn`` takes two
    floating tensors of one dtype; integer inputs compute in float32, or in
    float64 and back to their integer type where the distance is
    ``integral``."""
    sanitize_in(x)
    y = x if y is None else y
    sanitize_in(y)
    if x.ndim != 2 or y.ndim != 2:
        raise ValueError(f"pairwise distances take 2-D arrays, got {x.ndim}-D and {y.ndim}-D")
    if x.shape[1] != y.shape[1]:
        raise ValueError(f"x and y have {x.shape[1]} and {y.shape[1]} features")
    split = 0 if x.split == 0 else (1 if y.split == 0 else None)
    if split == 0 and x.is_distributed():
        xl, yl, balanced = x.larray, _whole(y), x.balanced
    elif split == 1 and y.is_distributed():
        xl, yl, balanced = _whole(x), y.larray, y.balanced
    else:
        xl, yl, balanced = _whole(x), _whole(y), True
    xl, yl = _common(xl, yl)
    want = xl.dtype
    if not (want.is_floating_point or want.is_complex):
        work = torch.float64 if integral else torch.float32
        d = fn(xl.to(work), yl.to(work))
        d = d.round().to(torch.int32 if want in (torch.int64, torch.bool) else want) if integral else d
    else:
        d = fn(xl, yl)
    return DNDarray(d, (x.shape[0], y.shape[0]), types.canonical_heat_type(d.dtype), split, x.device, x.comm,
                    balanced)


def cdist(x: DNDarray, y: Optional[DNDarray] = None, quadratic_expansion: bool = False) -> DNDarray:
    """Euclidean distance matrix between the rows of ``x`` and ``y``:
    ``quadratic_expansion=True`` takes the GEMM form, else the direct form
    (more precise where two rows nearly coincide)."""
    return _pairwise(x, y, _euclid(quadratic_expansion))


def cdist_small(x: DNDarray, y: Optional[DNDarray] = None, quadratic_expansion: bool = False) -> DNDarray:
    return cdist(x, y, quadratic_expansion)


def manhattan(x: DNDarray, y: Optional[DNDarray] = None, expand: bool = False) -> DNDarray:
    """City-block distance matrix (integers stay integers, as in the JAX package)."""
    return _pairwise(x, y, lambda a, b: torch.cdist(a, b, p=1.0), integral=True)


def rbf(x: DNDarray, y: Optional[DNDarray] = None, sigma: float = 1.0, quadratic_expansion: bool = False) -> DNDarray:
    """Gaussian RBF kernel matrix exp(-d^2 / (2 sigma^2)), d^2 by either form."""
    scale = -1.0 / (2.0 * sigma * sigma)

    def fn(a, b):
        d2 = _sq_euclid(a, b) if quadratic_expansion else _euclid(False)(a, b).square_()
        return d2.mul_(scale).exp_()

    return _pairwise(x, y, fn)


def cdist_ring(x: DNDarray, y: Optional[DNDarray] = None) -> DNDarray:
    """Euclidean distances by the ring (the quadratic expansion): both
    operands split along rows, x's rows stay, and y's row blocks go round the
    ranks (``Isend``, one rank down a step, the next transfer posted before
    this block's GEMM), each block's distances written into its columns.
    Blocks of uneven HeAT chunks travel zero-padded to the largest.  The
    result is split along rows, as x's.  Other splits, and one rank, take
    ``cdist(x, y, quadratic_expansion=True)``, as in the JAX package."""
    sanitize_in(x)
    y = x if y is None else y
    sanitize_in(y)
    comm = x.comm
    if not comm.is_distributed() or x.split != 0 or y.split != 0:
        return cdist(x, y, quadratic_expansion=True)
    if x.ndim != 2 or y.ndim != 2 or x.shape[1] != y.shape[1]:
        raise ValueError(f"cdist_ring takes 2-D arrays of equal width, got {x.shape} and {y.shape}")
    xl, yl = _common(x.larray, y.larray)
    if not (xl.is_floating_point() or xl.is_complex()):
        xl, yl = xl.to(torch.float32), yl.to(torch.float32)
    counts, displs = y.counts_displs()
    p, rank = comm.size, comm.rank
    width = max(counts)
    rot = yl if yl.shape[0] == width else torch.cat([yl, yl.new_zeros((width - yl.shape[0], yl.shape[1]))])
    out = xl.new_empty((xl.shape[0], y.shape[0]))
    for step in range(p):
        src = (rank + step) % p
        nxt = comm.Isend(rot, shift=-1) if step + 1 < p else None
        out[:, displs[src] : displs[src] + counts[src]] = _sq_euclid(xl, rot[: counts[src]]).sqrt_()
        if nxt is not None:
            rot = nxt.wait()
    return DNDarray(out, (x.shape[0], y.shape[0]), types.canonical_heat_type(out.dtype), 0, x.device, comm,
                    x.balanced)
