"""Vectorizing map over DNDarrays (reference: ``heat/core/vmap.py``), over
``torch.func.vmap``.

``func`` is mapped over axis 0 of the DNDarray arguments, and receives
each one as a DNDarray of one example, split None.  A distributed argument
is mapped rank by rank: each rank maps its own rows (an argument split
along another axis is resplit to 0 first, a replicated one gives each rank
its rows), and the result, split along the mapped axis, takes the split of
the first DNDarray argument, as the reference's.

Under ``torch.func`` an operation that reads a value on the host
(``.item()``, ``float(x)``, a data-dependent shape, a printed value) or
runs a collective raises: ``func`` must be a function of its examples'
values alone.
"""

from __future__ import annotations

from typing import Callable

import torch

from . import types
from .dndarray import DNDarray

__all__ = ["vmap"]


def vmap(func: Callable, out_dims=0) -> Callable:
    """Vectorize ``func`` over axis 0 of its DNDarray arguments."""

    def wrapper(*args, **kwargs):
        dnds = [a for a in args if isinstance(a, DNDarray)]
        if not dnds:
            raise TypeError("vmap requires at least one DNDarray argument")
        proto = dnds[0]
        comm = proto.comm
        spread = any(a.is_distributed() for a in dnds)
        rows = None
        if spread:
            lead = next(a for a in dnds if a.is_distributed())
            lead = lead.resplit(0) if lead.split != 0 else lead
            rows = lead.counts_displs()

        def local(a: DNDarray) -> torch.Tensor:
            if not spread:
                return a.larray
            if a.is_distributed():
                b = a.resplit(0) if a.split != 0 else a
                if list(b.counts_displs()[0]) != list(rows[0]):
                    b = DNDarray(b.larray.clone(), b.shape, b.dtype, 0, b.device, comm, b.balanced)
                    tmap = comm.lshape_map(b.shape, 0)
                    tmap[:, 0] = rows[0]
                    b.redistribute_(target_map=tmap)
                return b.larray
            lo, c = rows[1][comm.rank], rows[0][comm.rank]
            return a.larray[lo:lo + c]

        targs = [local(a) if isinstance(a, DNDarray) else a for a in args]
        mapped = [i for i, a in enumerate(args) if isinstance(a, DNDarray)]

        def tfunc(*inner):
            rebuilt = list(args)
            for i, t in zip(mapped, inner):
                rebuilt[i] = DNDarray(t, tuple(t.shape), types.canonical_heat_type(t.dtype), None, proto.device,
                                      comm, True)
            res = func(*rebuilt, **kwargs)
            return res.larray if isinstance(res, DNDarray) else res

        in_dims = tuple(0 if isinstance(a, DNDarray) else None for a in args)
        res = torch.func.vmap(tfunc, in_dims=in_dims, out_dims=out_dims)(*targs)
        ax = out_dims % res.ndim
        want = proto.split if proto.split is not None and proto.split < res.ndim else None
        if not spread:
            return DNDarray(res, tuple(res.shape), types.canonical_heat_type(res.dtype), want, proto.device, comm,
                            True)
        gshape = list(res.shape)
        gshape[ax] = sum(rows[0])
        out = DNDarray(res, tuple(gshape), types.canonical_heat_type(res.dtype), ax, proto.device, comm,
                       list(rows[0]) == [comm.chunk((gshape[ax],), 0, q)[1][0] for q in range(comm.size)])
        return out if want == ax else out.resplit(want)

    return wrapper
