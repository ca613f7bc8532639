"""KMeans (reference: ``heat/cluster/kmeans.py``; BASELINE workload).

Each Lloyd step is one E+M sweep over this rank's rows, then the two
Allreduces of the statistics the reference issues: X never crosses ranks.
``assign_kernel`` picks the sweep:

- ``'pallas'``: the hand-written kernels of ``ops.kmeans_kernels`` (on the
  card; their plain versions on the CPU).  The name is the JAX package's.
- ``'jnp'``: the torch port of the JAX package's non-kernel path, over row
  blocks with ``torch.matmul`` (distances, then a one-hot GEMM).
- ``'auto'``: the kernels for CUDA tensors, which raise on what they do not
  take (dtype, d, k·d past their shared-memory layout); ``'jnp'`` for CPU
  tensors.  (The JAX package resolves ``'auto'`` to ``'jnp'``, from a TPU
  measurement.)
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from ..core.dndarray import DNDarray
from ..ops.kmeans_kernels import fused_em_stats, sq_dist_blocks
from ._kcluster import _KCluster

__all__ = ["KMeans"]


class KMeans(_KCluster):
    """K-Means clustering with the reference's API.

    Parameters mirror ``heat.cluster.KMeans``: n_clusters, init
    ('kmeans++' | 'random' | array), max_iter, tol, random_state.
    """

    def __init__(
        self,
        n_clusters: int = 8,
        init: Union[str, object] = "kmeans++",
        max_iter: int = 300,
        tol: float = 1e-4,
        random_state: Optional[int] = None,
        assign_kernel: str = "auto",
    ):
        super().__init__(
            metric=lambda x, y: None, n_clusters=n_clusters, init=init,
            max_iter=max_iter, tol=tol, random_state=random_state,
        )
        if assign_kernel not in ("auto", "pallas", "jnp"):
            raise ValueError(
                f"assign_kernel must be 'auto', 'pallas' or 'jnp', got {assign_kernel!r}"
            )
        self.assign_kernel = assign_kernel

    def _use_kernel(self, x: DNDarray) -> bool:
        if self.assign_kernel != "auto":
            return self.assign_kernel == "pallas"
        return x.larray.is_cuda

    @staticmethod
    def _blocked_stats(xl: torch.Tensor, centers: torch.Tensor):
        """(k, d) float32 cluster sums and (k,) counts over row blocks: the
        reference's ``_blocked_stats`` without the kernel (argmin of the
        unclamped d², then each block's one-hot GEMM added to a float32 carry).
        Per-row float32 adds into the running sums (``index_add_``) would
        round at the sum's magnitude, biased on a big cluster's similar rows."""
        k, d = centers.shape
        ids = torch.arange(k, device=xl.device)
        sums = torch.zeros((k, d), dtype=torch.float32, device=xl.device)
        counts = torch.zeros(k, dtype=torch.int64, device=xl.device)
        for _, xb, _, lb in sq_dist_blocks(xl, centers, clamp_first=False):
            sums += (lb[None, :] == ids[:, None]).float() @ xb
            counts += torch.bincount(lb, minlength=k)
        return sums, counts.float()

    def _em_stats(self, xl: torch.Tensor, centers: torch.Tensor, use_kernel: bool):
        if use_kernel:
            return fused_em_stats(xl, centers)
        return self._blocked_stats(xl, centers)
