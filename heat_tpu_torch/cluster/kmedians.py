"""KMedians (reference: ``heat_tpu/cluster/kmedians.py``).

The E-step is the assign pass (the ``assign`` kernel on a CUDA tensor);
the M-step is each cluster's coordinate-wise median, the mean of the two
middle values at an even count, and the old center for an empty cluster.

The medians are exact across ranks without one sort per cluster: for each
column, an int64 key ``(label << 32) | order_key(x)`` puts every cluster's
values in one contiguous, ordered run of the column's global order, so the
k medians of the column are 2k order statistics of one key array, at
offsets from the Allreduced cluster counts, which
``parallel.sample_sort.order_statistics_1d`` selects without moving the
array.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from ..core.dndarray import DNDarray
from ..parallel.sample_sort import ALONE, decode_key, order_key, order_statistics_1d
from ._kcluster import _KCluster

__all__ = ["KMedians"]

_LOW32 = (1 << 32) - 1


def cluster_medians(comm, xl: torch.Tensor, labels: torch.Tensor, old: torch.Tensor):
    """(float32 (k, d) coordinate-wise medians of each cluster, the old
    center where a cluster is empty; the (k,) int64 global counts) of the
    rows whose chunk this rank holds as ``xl`` with ``labels``, on every
    rank the same."""
    k, d = old.shape
    lab = labels.to(torch.int64)
    counts = torch.bincount(lab, minlength=k)
    if comm.is_distributed():
        comm.Allreduce(counts)
    cnt = counts.cpu()
    starts = torch.cumsum(cnt, 0) - cnt
    live = torch.nonzero(cnt > 0).reshape(-1)
    lo = (starts + (cnt - 1).clamp_min(0) // 2)[live]
    hi = (starts + cnt // 2)[live]
    targets = torch.cat([lo, hi]).tolist()
    new = old.clone()
    if not targets:
        return new, counts
    high = lab << 32
    m = live.numel()
    live_dev = live.to(old.device)
    for j in range(d):
        keys = high | (order_key(xl[:, j].float()) + (1 << 31))
        got = order_statistics_1d(comm, keys, targets)
        del keys
        vals = decode_key((got & _LOW32) - (1 << 31), torch.float32).double()
        new[live_dev, j] = ((vals[:m] + vals[m:]) * 0.5).float()
    return new, counts


class KMedians(_KCluster):
    """K-Medians clustering with the reference's API (n_clusters, init
    ('kmedians++' | 'random' | array), max_iter, tol, random_state)."""

    def __init__(
        self,
        n_clusters: int = 8,
        init: Union[str, object] = "kmedians++",
        max_iter: int = 300,
        tol: float = 1e-4,
        random_state: Optional[int] = None,
    ):
        if isinstance(init, str) and init == "kmedians++":
            init = "kmeans++"
        super().__init__(
            metric=lambda x, y: None, n_clusters=n_clusters, init=init,
            max_iter=max_iter, tol=tol, random_state=random_state,
        )

    def _use_kernel(self, x: DNDarray) -> bool:
        return x.larray.is_cuda

    def _step(self, x: DNDarray, centers: torch.Tensor, use_kernel: bool) -> torch.Tensor:
        labels = self._local_assign(x.larray, centers, use_kernel)[0]
        return cluster_medians(x.comm if x.is_distributed() else ALONE, x.larray, labels, centers)[0]
