"""Batch-parallel clustering (reference: ``heat_tpu/cluster/batchparallelclustering.py``).

HeAT's scheme: every rank clusters its own rows with a local Lloyd loop,
one Allgather collects the k·p candidate centers, and every rank merges
them with the same local Lloyd loop (seeded ``random_state + 1``), so all
ranks hold the same k centers.  ``n_iter_`` is the ranks' largest local
iteration count.  The means variant's sweep is the ``em_stats`` kernel on a
CUDA tensor, the median variant's the ``assign`` kernel and
``kmedians.cluster_medians`` on the rank's rows; ``predict`` is the
``assign`` kernel.  ``n_procs_to_merge`` is accepted and unused, as in the
reference.

The reference takes its per-shard path only where the rows divide evenly
over its devices and otherwise runs one global Lloyd loop; here every
rank's HeAT chunk, of any size, takes the per-rank path.  The inits draw
from a CPU ``torch.Generator`` seeded by (``random_state``, rank), not the
reference's ``jax.random`` bits.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core import random, types
from ..core.base import BaseEstimator, ClusteringMixin
from ..core.dndarray import DNDarray
from ..core.sanitation import sanitize_in
from ..ops.kmeans_kernels import fused_assign, fused_em_stats
from ..parallel.sample_sort import ALONE
from ._kcluster import _KCluster
from .kmeans import KMeans
from .kmedians import cluster_medians

__all__ = ["BatchParallelKMeans", "BatchParallelKMedians"]


def _plusplus_init(xl: torch.Tensor, k: int, g: torch.Generator) -> torch.Tensor:
    """Local D² sampling (k-means++ on one block of rows): one candidate a
    step, drawn with probability ∝ D² (uniformly where every D² is 0)."""
    n = xl.shape[0]
    first = int(torch.randint(0, n, (1,), generator=g))
    centers = torch.zeros((k, xl.shape[1]), dtype=torch.float32, device=xl.device)
    centers[0] = xl[first].float()
    d2 = _KCluster._sq_dists(xl, centers[:1])[:, 0]
    for i in range(1, k):
        total = d2.sum(dtype=torch.float64)
        u = float(torch.rand(1, generator=g, dtype=torch.float64))
        if float(total) > 0.0:
            cum = torch.cumsum(d2, 0, dtype=torch.float64)
            pick = int(torch.searchsorted(cum, torch.tensor([u], dtype=torch.float64, device=xl.device) * total,
                                          right=True).clamp_max_(n - 1))
        else:
            pick = min(int(u * n), n - 1)
        centers[i] = xl[pick].float()
        d2 = torch.minimum(d2, _KCluster._sq_dists(xl, centers[i:i + 1])[:, 0])
    return centers


def local_lloyd(xl: torch.Tensor, centers: torch.Tensor, max_iter: int, median: bool, tol: float = 0.0):
    """(centers, iterations) of Lloyd's loop on the local rows ``xl`` from
    float32 ``centers``: a step's labels by the argmin of the squared
    distances, the new centers the clusters' means (or coordinate-wise
    medians), an empty cluster keeping its center; it stops after
    ``max_iter`` steps or a shift of at most ``tol``.  A CUDA tensor takes
    the ``em_stats`` kernel (means) or the ``assign`` kernel (medians)."""
    cuda = xl.is_cuda
    it = 0
    while it < max_iter:
        if median:
            labels = fused_assign(xl, centers)[0] if cuda else _KCluster._assign(xl, centers)[0]
            new = cluster_medians(ALONE, xl, labels, centers)[0]
        else:
            sums, counts = fused_em_stats(xl, centers) if cuda else KMeans._blocked_stats(xl, centers)
            new = _KCluster._centers_from_stats(sums, counts, centers)
        shift = (new - centers).abs().max()
        centers = new
        it += 1
        if not bool(shift > tol):
            break
    return centers, it


class _BatchParallelKCluster(ClusteringMixin, BaseEstimator):
    """Per-rank k-clustering and one merge of the k·p candidate centers."""

    def __init__(self, n_clusters: int, init: str, max_iter: int, tol: float,
                 random_state: Optional[int], n_procs_to_merge: Optional[int], median: bool):
        self.n_clusters = n_clusters
        self.init = init
        self.max_iter = max_iter
        self.tol = tol
        self.random_state = random_state
        self.n_procs_to_merge = n_procs_to_merge
        self._median = median
        self._cluster_centers = None
        self._centers = None
        self._labels = None
        self._n_iter = None

    @property
    def cluster_centers_(self):
        return self._cluster_centers

    @property
    def labels_(self):
        return self._labels

    @property
    def n_iter_(self):
        return self._n_iter

    def _init(self, xl: torch.Tensor, seed: int, stream: int) -> torch.Tensor:
        k = self.n_clusters
        g = random.generator(seed, stream, device="cpu")
        if "++" in str(self.init):
            return _plusplus_init(xl, k, g)
        if k > xl.shape[0]:
            raise ValueError(f"n_clusters={k} exceeds the {xl.shape[0]} rows to cluster")
        idx = torch.randperm(xl.shape[0], generator=g)[:k].to(xl.device)
        return xl[idx].float()

    def fit(self, x: DNDarray):
        sanitize_in(x)
        if x.split != 0:
            raise ValueError("BatchParallel clustering requires split=0 data")
        seed = self.random_state if self.random_state is not None else 0
        comm = x.comm
        xl = x.larray
        k, d = self.n_clusters, x.shape[1]
        if xl.shape[0] < k:
            raise ValueError(f"rank {comm.rank} holds {xl.shape[0]} rows, fewer than n_clusters={k}")
        local, used = local_lloyd(xl, self._init(xl, seed, comm.rank), self.max_iter, self._median, self.tol)
        if x.is_distributed():
            candidates = torch.cat(comm.Allgather(local))
            used = int(comm.Allreduce(torch.tensor([used], dtype=torch.int64, device=xl.device), "max").item())
        else:
            candidates = local
        merged, _ = local_lloyd(candidates, self._init(candidates, seed + 1, 0), self.max_iter, self._median,
                                self.tol)
        self._set_centers(merged.to(xl.dtype), x)
        self._labels = self.predict(x)
        self._n_iter = used
        return self

    def _set_centers(self, c: torch.Tensor, proto: DNDarray) -> None:
        self._centers = c.float()
        self._cluster_centers = DNDarray(c, tuple(c.shape), types.canonical_heat_type(c.dtype), None, proto.device,
                                         proto.comm, True)

    def predict(self, x: DNDarray) -> DNDarray:
        """Nearest-center labels (int32) in x's row layout."""
        sanitize_in(x)
        if self._centers is None:
            raise RuntimeError("fit must be called before predict")
        x = _KCluster._rows(x)
        xl = x.larray
        c = self._centers.to(xl.device)
        labels = fused_assign(xl, c)[0] if xl.is_cuda else _KCluster._assign(xl, c)[0]
        return DNDarray(labels, (x.shape[0],), types.int32, x.split, x.device, x.comm, x.balanced)


class BatchParallelKMeans(_BatchParallelKCluster):
    """Per-rank KMeans and one merge of the candidates (reference API)."""

    def __init__(self, n_clusters: int = 8, init: str = "k-means++", max_iter: int = 300,
                 tol: float = 1e-4, random_state: Optional[int] = None,
                 n_procs_to_merge: Optional[int] = None):
        super().__init__(n_clusters, init, max_iter, tol, random_state, n_procs_to_merge, median=False)


class BatchParallelKMedians(_BatchParallelKCluster):
    """Per-rank KMedians and one merge of the candidates (reference API)."""

    def __init__(self, n_clusters: int = 8, init: str = "k-medians++", max_iter: int = 300,
                 tol: float = 1e-4, random_state: Optional[int] = None,
                 n_procs_to_merge: Optional[int] = None):
        super().__init__(n_clusters, init, max_iter, tol, random_state, n_procs_to_merge, median=True)
