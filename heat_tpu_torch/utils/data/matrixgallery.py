"""Test matrices (reference: ``heat/utils/data/matrixgallery.py``).

``parter`` is exact.  The random matrices draw their factors from
``random_state`` (the same on every rank and world size) and are held
by their properties, not bit for bit: ``hermitian`` is Hermitian (and
positive definite on request), ``random_known_singularvalues`` has the
given singular values, with orthonormal factors from the port's QR.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ...core import factories, types
from ...core.dndarray import DNDarray
from ...core.random import generator
from ...linalg.qr import qr

__all__ = ["hermitian", "parter", "random_known_rank", "random_known_singularvalues"]


def parter(n: int, split=None, device=None, comm=None, dtype=types.float32) -> DNDarray:
    """The Parter matrix, A[i, j] = 1 / (i - j + 0.5): a Cauchy matrix whose
    singular values cluster at pi.  Each rank builds its chunk, in float32
    as the reference computes it."""
    proto = factories.empty((n, n), dtype=types.float32, split=split, device=device, comm=comm)
    _, _, (rows, cols) = proto.comm.chunk((n, n), proto.split)
    tdev = proto.larray.device
    i = torch.arange(rows.start, rows.stop, device=tdev, dtype=torch.float32)
    j = torch.arange(cols.start, cols.stop, device=tdev, dtype=torch.float32)
    t = (1.0 / (i[:, None] - j[None, :] + 0.5)).to(types.canonical_heat_type(dtype).torch_type())
    return DNDarray(t, (n, n), dtype, proto.split, proto.device, proto.comm, True)


def hermitian(n: int, split=None, device=None, comm=None, dtype=types.complex64, positive_definite: bool = False,
              random_state: int = 0) -> DNDarray:
    """A random Hermitian (n, n) matrix (real symmetric for a real
    ``dtype``): (A + A^H) / 2, or A A^H + n I with ``positive_definite``.
    A is drawn in float64 on the array's device from ``random_state`` (the
    same on every rank), and each rank forms only its chunk there."""
    dt = types.canonical_heat_type(dtype)
    proto = factories.empty((n, n), dtype=types.float32, split=split, device=device, comm=comm)
    tdev = proto.larray.device
    _, _, (rows, cols) = proto.comm.chunk((n, n), proto.split)
    g = generator(random_state, 0, device=tdev)
    a = torch.randn(n, n, generator=g, dtype=torch.float64, device=tdev)
    if types.heat_type_is_complexfloating(dt):
        a = torch.complex(a, torch.randn(n, n, generator=g, dtype=torch.float64, device=tdev))
    if positive_definite:
        h = a[rows] @ a[cols].conj().T
        h.diagonal(rows.start - cols.start).add_(n)
    else:
        h = 0.5 * (a[rows, cols] + a[cols, rows].conj().T)
    t = h.to(dt.torch_type()).contiguous()
    return DNDarray(t, (n, n), dt, proto.split, proto.device, proto.comm, True)


def random_known_singularvalues(m: int, n: int, singular_values, split=None, device=None, comm=None,
                                dtype=types.float32, random_state: int = 1) -> Tuple[DNDarray, Tuple]:
    """A random (m, n) matrix with the given singular values, and its factors
    (U, s, V): U (m, k) and V (n, k) with orthonormal columns (``ht.linalg.qr``
    of Gaussian matrices), A = U diag(s) V^T, split as ``split`` asks."""
    sv = factories.array(singular_values, dtype=types.float32, device=device, comm=comm)
    k = sv.gshape[0]
    g = generator(random_state, 0)
    draws = [torch.randn(rows, k, generator=g) for rows in (m, n)]
    u, v = (qr(factories.array(d, split=0, device=device, comm=comm)).Q for d in draws)
    a = (u * sv) @ v.T
    a = a.resplit(split) if a.split != split else a
    return a.astype(dtype, copy=False), (u, sv, v)


def random_known_rank(m: int, n: int, r: int, split=None, device=None, comm=None,
                      dtype=types.float32) -> Tuple[DNDarray, Tuple]:
    """A random (m, n) matrix of rank ``r``: singular values evenly spaced
    from 1 down to 0.1 (:func:`random_known_singularvalues`)."""
    sv = torch.linspace(1.0, 0.1, r, dtype=torch.float32)
    return random_known_singularvalues(m, n, sv, split=split, device=device, comm=comm, dtype=dtype)

