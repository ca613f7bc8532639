"""Graph Laplacian (reference: ``heat_tpu/graph/laplacian.py``).

L is built in the similarity matrix's own buffer: the self-similarity
diagonal is zeroed in place (the reference multiplies by ``1 - eye(n)``, an
n² temporary), ``eNeighbour`` thresholds in place to a binary adjacency,
and ``norm_sym`` scales rows and columns by D^-1/2 in place.  At n = 32768
the similarity matrix alone is 4 GiB, so nothing of its size is made twice.
Row sums of a matrix split along its rows are local; the column scale of
such a matrix takes every rank's row sums (one Allgatherv of n values).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..core import types
from ..core.dndarray import DNDarray

__all__ = ["Laplacian"]


class Laplacian:
    """Similarity-graph Laplacian L = D − A (``'simple'``) or I − D^-1/2 A
    D^-1/2 (``'norm_sym'``), of the graph ``'fully_connected'`` by the
    similarity or of its ``'eNeighbour'`` epsilon ball (binary adjacency:
    similarity below ``threshold_value`` with ``threshold_key='upper'``,
    above it with ``'lower'``)."""

    def __init__(
        self,
        similarity: Callable,
        definition: str = "norm_sym",
        mode: str = "fully_connected",
        threshold_key: str = "upper",
        threshold_value: float = 1.0,
        neighbours: Optional[int] = None,
    ):
        self.similarity = similarity
        if definition not in ("simple", "norm_sym"):
            raise NotImplementedError(f"definition {definition!r} not supported")
        if mode not in ("fully_connected", "eNeighbour"):
            raise NotImplementedError(f"mode {mode!r} not supported")
        self.definition = definition
        self.mode = mode
        self.epsilon = (threshold_key, threshold_value)
        self.neighbours = neighbours

    @staticmethod
    def _diagonal(a: torch.Tensor, offset: int) -> torch.Tensor:
        """The view of the global diagonal in the local rows of ``a`` that
        start at global row ``offset``."""
        return a.narrow(1, offset, a.shape[0]).diagonal()

    def construct(self, x: DNDarray) -> DNDarray:
        """The Laplacian of the similarity graph of the rows of ``x``, laid
        out as the similarity matrix (split 0 or replicated)."""
        S = self.similarity(x)
        if not isinstance(S, DNDarray):
            raise TypeError(f"the similarity must return a DNDarray, got {type(S)}")
        split = S.split
        if S.is_distributed() and split != 0:
            S = S.resplit(0)
        A = S.larray
        if not A.is_floating_point():
            A = A.float()
        offset = S.counts_displs()[1][S.comm.rank] if S.is_distributed() else 0
        diag = self._diagonal(A, offset)
        diag.zero_()
        if self.mode == "eNeighbour":
            key, val = self.epsilon
            A.copy_(A < val if key == "upper" else A > val)
            diag.zero_()
        deg = A.sum(1)
        if self.definition == "norm_sym":
            dis = torch.where(deg > 0, 1.0 / deg.clamp_min(1e-30).sqrt(), torch.zeros_like(deg))
            cols = S.comm.Allgatherv(dis, 0, counts=S.counts_displs()[0]) if S.is_distributed() else dis
            A.mul_(dis[:, None]).mul_(cols[None, :]).neg_()
            diag.add_(1.0)
        else:
            A.neg_()
            diag.add_(deg)
        L = DNDarray(A, S.gshape, types.canonical_heat_type(A.dtype), S.split, S.device, S.comm, S.balanced)
        return L.resplit(split) if L.split != split else L
