"""Shared k-clustering skeleton (reference: ``heat/cluster/_kcluster.py``).

Init strategies, the Lloyd loop and ``predict``.  The loop runs in Python
over device tensors: each step is one E+M sweep over this rank's rows, the
two Allreduces of the statistics (sums (k, d), counts (k,)) when the rows
are split over ranks, and one host sync for the ``tol`` test.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch

from ..core import random, types
from ..core.base import BaseEstimator, ClusteringMixin
from ..core.dndarray import DNDarray
from ..core.sanitation import sanitize_in
from ..ops.kmeans_kernels import fused_assign, sq_dist_blocks


class _KCluster(ClusteringMixin, BaseEstimator):
    """Base class of the k-clustering estimators."""

    def __init__(self, metric: Callable, n_clusters: int, init, max_iter: int, tol: float, random_state: Optional[int]):
        self.n_clusters = n_clusters
        self.init = init
        self.max_iter = max_iter
        self.tol = tol
        self.random_state = random_state
        self._metric = metric

        self._cluster_centers = None
        self._centers = None  # float32 working copy of the centers, on the data's device
        self._labels = None
        self._inertia = None
        self._n_iter = None

    @property
    def cluster_centers_(self) -> DNDarray:
        return self._cluster_centers

    @property
    def labels_(self) -> DNDarray:
        return self._labels

    @property
    def inertia_(self) -> float:
        return self._inertia

    @property
    def n_iter_(self) -> int:
        return self._n_iter

    @property
    def functional_value_(self) -> float:
        return self._inertia

    # ------------------------------------------------------------------ #
    # init
    # ------------------------------------------------------------------ #
    def _initialize_cluster_centers(self, x: DNDarray):
        """(float32 (k, d) centers on x's device, the centers' storage dtype).

        'random' draws k distinct rows; 'kmeans++' is greedy D² sampling;
        an explicit (k, d) array is taken as it is.  Random draws come from
        a CPU generator seeded by ``random_state`` alone, so every rank draws
        the same indices without communication."""
        k = self.n_clusters
        n, d = x.shape
        tdev = x.larray.device
        seed = self.random_state if self.random_state is not None else 0

        if isinstance(self.init, (DNDarray, np.ndarray, torch.Tensor)):
            if isinstance(self.init, DNDarray):
                init = self.init.larray if not self.init.is_distributed() else torch.from_numpy(self.init.numpy())
            else:
                init = torch.as_tensor(np.array(self.init) if isinstance(self.init, np.ndarray) else self.init)
            if tuple(init.shape) != (k, d):
                raise ValueError(f"initial centers must have shape {(k, d)}, got {tuple(init.shape)}")
            return init.to(device=tdev, dtype=torch.float32).contiguous(), init.dtype

        if self.init == "random":
            if k > n:
                raise ValueError(f"n_clusters={k} exceeds the {n} samples")
            g = random.generator(seed, 0, device="cpu")
            chosen, seen = [], set()
            while len(chosen) < k:  # redraw duplicates: no permutation of all n rows
                for i in torch.randint(0, n, (k - len(chosen),), generator=g).tolist():
                    if i not in seen:
                        seen.add(i)
                        chosen.append(i)
            idx = torch.tensor(chosen, dtype=torch.int64, device=tdev)
            centers = x._gather_rows(idx).float()
        elif self.init in ("kmeans++", "probability_based"):
            centers = self._kmeans_plusplus(x, k, random.generator(seed, 1, device="cpu"))
        else:
            raise ValueError(f"Unknown init strategy {self.init!r}")
        return centers.contiguous(), x.larray.dtype

    @staticmethod
    def _sq_dists(xl: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        """Clamped squared distances (rows, m) of local rows to m centers."""
        out = torch.empty((xl.shape[0], c.shape[0]), dtype=torch.float32, device=xl.device)
        for s, _, db, _ in sq_dist_blocks(xl, c):
            out[s : s + db.shape[0]] = db
        return out

    def _kmeans_plusplus(self, x: DNDarray, k: int, g: torch.Generator) -> torch.Tensor:
        """Greedy D² sampling (the reference's kmeans++): each step draws
        ``2 + ceil(log2 k)`` candidates with probability ∝ D² and keeps the one
        that most lowers the potential.  A draw is a uniform number in
        [0, total D²) located in the ranks' cumulative D² sums; the candidate
        rows are gathered with one Allreduce and the potentials with another."""
        n = x.shape[0]
        comm = x.comm
        xl = x.larray
        tdev = xl.device
        n_trials = 2 + int(math.ceil(math.log2(max(k, 2))))
        first = int(torch.randint(0, n, (1,), generator=g))
        centers = torch.zeros((k, xl.shape[1]), dtype=torch.float32, device=tdev)
        centers[0] = x._gather_rows(torch.tensor([first], device=tdev))[0].float()
        d2 = self._sq_dists(xl, centers[:1])[:, 0]
        distributed = x.is_distributed()
        for i in range(1, k):
            local = d2.sum(dtype=torch.float64).reshape(1)
            totals = torch.cat(comm.Allgather(local)) if distributed else local
            grand = float(totals.sum())
            u = torch.rand(n_trials, generator=g, dtype=torch.float64)
            if grand > 0.0:
                rank = comm.rank if distributed else 0
                below = float(totals[:rank].sum())
                v = (u * grand).to(tdev) - below
                mine = (v >= 0) & (v < totals[rank])
                cum = torch.cumsum(d2, 0, dtype=torch.float64)
                pos = torch.searchsorted(cum, v[mine], right=True).clamp_max_(max(xl.shape[0] - 1, 0))
                cand = torch.zeros((n_trials, xl.shape[1]), dtype=torch.float32, device=tdev)
                cand[mine] = xl[pos].float()
                if distributed:
                    comm.Allreduce(cand)
            else:  # every row sits on a center: any rows will do
                idx = (u * n).long().clamp_max_(n - 1).to(tdev)
                cand = x._gather_rows(idx).float()
            cd2 = self._sq_dists(xl, cand)
            pots = torch.minimum(d2[:, None], cd2).sum(0, dtype=torch.float64)
            if distributed:
                comm.Allreduce(pots)
            best = int(pots.argmin())
            centers[i] = cand[best]
            d2 = torch.minimum(d2, cd2[:, best])
        return centers

    # ------------------------------------------------------------------ #
    # E-step of the torch path
    # ------------------------------------------------------------------ #
    @staticmethod
    def _assign(xl: torch.Tensor, centers: torch.Tensor):
        """(labels int32, clamped min d²), with the argmin taken BEFORE the
        clamp, as the reference's ``_assign`` does."""
        n = xl.shape[0]
        labels = torch.empty(n, dtype=torch.int32, device=xl.device)
        d2min = torch.empty(n, dtype=torch.float32, device=xl.device)
        for s, _, db, lb in sq_dist_blocks(xl, centers, clamp_first=False):
            labels[s : s + lb.shape[0]] = lb.int()
            d2min[s : s + lb.shape[0]] = db.gather(1, lb[:, None])[:, 0]
        return labels, d2min

    def _em_stats(self, xl: torch.Tensor, centers: torch.Tensor, use_kernel: bool):
        raise NotImplementedError()

    @staticmethod
    def _centers_from_stats(sums: torch.Tensor, counts: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
        new = sums / counts.clamp_min(1.0)[:, None]
        # empty clusters keep their previous center (reference behavior)
        return torch.where(counts[:, None] > 0, new, centers)

    def _use_kernel(self, x: DNDarray) -> bool:
        return False

    # ------------------------------------------------------------------ #
    # fit / predict
    # ------------------------------------------------------------------ #
    def fit(self, x: DNDarray):
        """Lloyd iteration until ``max_iter`` steps or a center shift ≤ ``tol``."""
        sanitize_in(x)
        if x.ndim != 2:
            raise ValueError(f"input must be 2-D (n_samples, n_features), got {x.ndim}-D")
        if x.is_distributed() and x.split != 0:
            raise NotImplementedError("fitting an array split along the feature axis is not ported yet")
        use_kernel = self._use_kernel(x)
        centers, cdtype = self._initialize_cluster_centers(x)
        xl, comm = x.larray, x.comm
        n_iter = 0
        for _ in range(self.max_iter):
            sums, counts = self._em_stats(xl, centers, use_kernel)
            if x.is_distributed():
                comm.Allreduce(sums)
                comm.Allreduce(counts)
            new = self._centers_from_stats(sums, counts, centers)
            new = new.to(cdtype).float()  # centers are stored in their own dtype
            shift = (new - centers).abs().max()
            centers = new
            n_iter += 1
            if not bool(shift > self.tol):  # the loop's one host sync
                break
        labels, d2 = self._local_assign(xl, centers, use_kernel)
        inertia = d2.sum(dtype=torch.float64).reshape(1)
        if x.is_distributed():
            comm.Allreduce(inertia)
        self._set_fitted(centers, cdtype, x, labels, float(inertia), n_iter)
        return self

    def _local_assign(self, xl: torch.Tensor, centers: torch.Tensor, use_kernel: bool):
        if use_kernel:
            return fused_assign(xl, centers)
        return self._assign(xl, centers)

    def _set_fitted(self, centers, cdtype, x: DNDarray, labels: torch.Tensor, inertia: float, n_iter: int) -> None:
        self._centers = centers
        c = centers.to(cdtype)
        self._cluster_centers = DNDarray(c, tuple(c.shape), types.canonical_heat_type(c.dtype), None,
                                         x.device, x.comm, True)
        self._labels = DNDarray(labels, (x.shape[0],), types.int32, x.split, x.device, x.comm, x.balanced)
        self._inertia = inertia
        self._n_iter = n_iter

    def predict(self, x: DNDarray) -> DNDarray:
        """Nearest-center assignment for new data."""
        sanitize_in(x)
        if self._centers is None:
            raise RuntimeError("the estimator is not fitted")
        if x.is_distributed() and x.split != 0:
            raise NotImplementedError("predicting on an array split along the feature axis is not ported yet")
        centers = self._centers.to(x.larray.device)
        labels, _ = self._local_assign(x.larray, centers, self._use_kernel(x))
        return DNDarray(labels, (x.shape[0],), types.int32, x.split, x.device, x.comm, x.balanced)
