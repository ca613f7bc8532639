"""KMedoids (reference: ``heat_tpu/cluster/kmedoids.py``).

The reference's variant: each cluster's coordinate-wise median
(``kmedians.cluster_medians``), then the member of the cluster nearest to
it (squared distance in float32, ties to the lowest global row, as
``jnp.argmin``), so the medoids are rows of X without an O(n²) search.
Across ranks each rank takes its segmented minimum of (d², global row) per
cluster, one small Allgather picks the winners, and their rows come from
their owners.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from ..core.dndarray import DNDarray
from ..ops.kmeans_kernels import BLOCK
from ..parallel.sample_sort import ALONE
from ._kcluster import _KCluster
from .kmedians import cluster_medians

__all__ = ["KMedoids"]

_NO_ROW = torch.iinfo(torch.int64).max


def nearest_members(x: DNDarray, labels: torch.Tensor, med: torch.Tensor, counts: torch.Tensor,
                    old: torch.Tensor) -> torch.Tensor:
    """(k, d) float32: for each non-empty cluster the row of ``x`` with that
    label nearest to its ``med`` (lowest global row among equals), else the
    ``old`` center."""
    xl = x.larray
    k = med.shape[0]
    n = xl.shape[0]
    dev = xl.device
    lab = labels.to(torch.int64)
    d2 = torch.empty(n, dtype=torch.float32, device=dev)
    for s in range(0, n, BLOCK):
        diff = xl[s:s + BLOCK].float() - med[lab[s:s + BLOCK]]
        d2[s:s + BLOCK] = (diff * diff).sum(1)
        del diff
    cmin = torch.full((k,), float("inf"), device=dev).scatter_reduce_(0, lab, d2, "amin")
    offset = x.counts_displs()[1][x.comm.rank] if x.is_distributed() else 0
    rows = torch.arange(offset, offset + n, dtype=torch.int64, device=dev)
    cand = torch.where(d2 == cmin[lab], rows, torch.full_like(rows, _NO_ROW))
    cidx = torch.full((k,), _NO_ROW, dtype=torch.int64, device=dev).scatter_reduce_(0, lab, cand, "amin")
    if x.is_distributed():
        dmins = torch.stack(x.comm.Allgather(cmin))  # (p, k)
        idxs = torch.stack(x.comm.Allgather(cidx))
        best = dmins.min(0).values
        cidx = torch.where(dmins == best[None, :], idxs, torch.full_like(idxs, _NO_ROW)).min(0).values
    live = torch.nonzero(counts.to(dev) > 0).reshape(-1)
    new = old.clone()
    if live.numel():
        new[live] = x._gather_rows(cidx[live]).float()
    return new


class KMedoids(_KCluster):
    """K-Medoids clustering with the reference's API (n_clusters, init
    ('random' | 'kmeans++' | array), max_iter, random_state)."""

    def __init__(
        self,
        n_clusters: int = 8,
        init: Union[str, object] = "random",
        max_iter: int = 300,
        random_state: Optional[int] = None,
    ):
        super().__init__(
            metric=lambda x, y: None, n_clusters=n_clusters, init=init,
            max_iter=max_iter, tol=0.0, random_state=random_state,
        )

    def _use_kernel(self, x: DNDarray) -> bool:
        return x.larray.is_cuda

    def _step(self, x: DNDarray, centers: torch.Tensor, use_kernel: bool) -> torch.Tensor:
        labels = self._local_assign(x.larray, centers, use_kernel)[0]
        med, counts = cluster_medians(x.comm if x.is_distributed() else ALONE, x.larray, labels, centers)
        return nearest_members(x, labels, med, counts, centers)

    def fit(self, x: DNDarray):
        # medoids move discretely: a repeated medoid set is the convergence
        self.tol = 1e-12
        return super().fit(x)
