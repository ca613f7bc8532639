"""Printing of the global array (reference: ``heat/core/printing.py``).

``str(x)`` shows the GLOBAL array as numpy prints it (``np.array2string``
with ``", "``).  Past the print threshold only the edges reach the host: on
each axis longer than ``2 * edgeitems + 1`` the first ``edgeitems + 1`` and
last ``edgeitems`` entries; each rank selects the edges it holds, and the
ranks gather those edges only.  Printing is collective: every rank calls it.
After :func:`local_printing`, ``str(x)`` shows this rank's local tensor
instead, as HeAT's does, and needs no other rank.
"""

from __future__ import annotations

import numpy as np
import torch

from .communication import get_comm

__all__ = ["get_printoptions", "set_printoptions", "local_printing", "global_printing", "print0"]

__PRINT_OPTIONS = dict(precision=4, threshold=1000, edgeitems=3, linewidth=120, sci_mode=None)
_LOCAL_PRINTING = False


def set_printoptions(precision=None, threshold=None, edgeitems=None, linewidth=None, profile=None, sci_mode=None):
    """Set the print options (as torch's and numpy's ``set_printoptions``);
    ``profile`` is ``'default'``, ``'short'`` or ``'full'``."""
    if profile == "default":
        __PRINT_OPTIONS.update(precision=4, threshold=1000, edgeitems=3, linewidth=120)
    elif profile == "short":
        __PRINT_OPTIONS.update(precision=2, threshold=1000, edgeitems=2, linewidth=120)
    elif profile == "full":
        __PRINT_OPTIONS.update(precision=4, threshold=np.inf, edgeitems=3, linewidth=120)
    for k, v in dict(
        precision=precision, threshold=threshold, edgeitems=edgeitems, linewidth=linewidth, sci_mode=sci_mode
    ).items():
        if v is not None:
            __PRINT_OPTIONS[k] = v


def get_printoptions() -> dict:
    return dict(__PRINT_OPTIONS)


def local_printing() -> None:
    """Print each rank's local tensor from now on."""
    global _LOCAL_PRINTING
    _LOCAL_PRINTING = True


def global_printing() -> None:
    """Print the global array from now on (the default)."""
    global _LOCAL_PRINTING
    _LOCAL_PRINTING = False


def print0(*args, **kwargs) -> None:
    """``print`` on rank 0 only.  Collective: every rank calls it, since a
    DNDarray argument is made a string on every rank first (its ``str``
    gathers from every rank)."""
    from .dndarray import DNDarray

    args = [__str__(a) if isinstance(a, DNDarray) else a for a in args]
    if get_comm().rank == 0:
        print(*args, **kwargs)


def _host(t: torch.Tensor) -> np.ndarray:
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()


def _edges(x) -> np.ndarray:
    """The edges of ``x`` on the host (numpy then prints them summarized):
    each rank takes the edges it holds from its local tensor, and the ranks
    gather them along the split axis."""
    e = __PRINT_OPTIONS["edgeitems"]
    idxs = [np.r_[0 : e + 1, s - e : s] if s > 2 * e + 1 else np.arange(s) for s in x.shape]
    t, split = x.larray, x.split
    counts = None
    if x.is_distributed():
        sizes, displs = x.counts_displs()
        mine = [(idxs[split] >= d) & (idxs[split] < d + c) for c, d in zip(sizes, displs)]
        counts = [int(m.sum()) for m in mine]
        rank = x.comm.rank
        idxs[split] = idxs[split][mine[rank]] - displs[rank]
    key = tuple(
        torch.as_tensor(ix, device=t.device).reshape([-1 if d == a else 1 for d in range(t.ndim)])
        for a, ix in enumerate(idxs)
    )
    part = t[key] if key else t
    if counts is not None:
        wire = part.view(torch.uint8) if part.dtype == torch.bool else part
        part = x.comm.Allgatherv(wire, split, counts=counts).view(part.dtype)
    return _host(part)


def __str__(x) -> str:
    opt = get_printoptions()
    threshold = opt["threshold"]
    with np.printoptions(
        precision=opt["precision"],
        threshold=int(threshold) if np.isfinite(threshold) else 10**18,
        edgeitems=opt["edgeitems"],
        linewidth=opt["linewidth"],
    ):
        if _LOCAL_PRINTING:
            return np.array2string(_host(x.larray), separator=", ")
        if x.size <= threshold or not np.isfinite(threshold):
            return np.array2string(x.numpy(), separator=", ")
        data = _edges(x)
        with np.printoptions(threshold=0, edgeitems=opt["edgeitems"]):
            return np.array2string(data, separator=", ")


def __repr__(x) -> str:
    body = __str__(x)
    return f"DNDarray({body}, dtype=ht.{x.dtype.__name__}, device={x.device}, split={x.split})"
