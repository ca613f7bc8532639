"""Spectral clustering (reference: ``heat_tpu/cluster/spectral.py``).

The RBF affinity (``spatial.rbf`` by the quadratic expansion), its
normalized graph Laplacian (``graph.Laplacian``, built in the affinity's
buffer), Lanczos (``linalg.lanczos``), the eigendecomposition of the small
tridiagonal T on the data's device, the embedding V·evecs of the k
smallest eigenvalues, and KMeans (``init='kmeans++'``, ``random_state=0``)
on that (n, k) embedding: on a CUDA tensor its sweeps are the ``em_stats``
kernel and its labels the ``assign`` kernel, at d = k.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .. import spatial
from ..core import types
from ..core.base import BaseEstimator, ClusteringMixin
from ..core.dndarray import DNDarray
from ..graph.laplacian import Laplacian
from ..linalg.basics import _full_float32
from ..linalg.solver import lanczos
from .kmeans import KMeans

__all__ = ["Spectral"]


class Spectral(ClusteringMixin, BaseEstimator):
    """Spectral clustering on the normalized graph Laplacian (reference API:
    n_clusters (None: the largest eigengap), gamma, metric ('rbf' |
    'euclidean'), laplacian ('fully_connected' | 'eNeighbour'), threshold,
    boundary, n_lanczos, assign_labels)."""

    def __init__(
        self,
        n_clusters: Optional[int] = None,
        gamma: float = 1.0,
        metric: str = "rbf",
        laplacian: str = "fully_connected",
        threshold: float = 1.0,
        boundary: str = "upper",
        n_lanczos: int = 300,
        assign_labels: str = "kmeans",
        **params,
    ):
        self.n_clusters = n_clusters
        self.gamma = gamma
        self.metric = metric
        self.n_lanczos = n_lanczos
        self.assign_labels = assign_labels

        sigma = math.sqrt(1.0 / (2.0 * gamma)) if gamma > 0 else 1.0
        if metric == "rbf":
            sim = lambda x: spatial.rbf(x, sigma=sigma, quadratic_expansion=True)  # noqa: E731
        elif metric == "euclidean":
            sim = lambda x: spatial.cdist(x, quadratic_expansion=True)  # noqa: E731
        else:
            raise NotImplementedError(f"metric {metric!r} not supported")
        self._laplacian = Laplacian(sim, definition="norm_sym", mode=laplacian, threshold_key=boundary,
                                    threshold_value=threshold)
        self._cluster = KMeans(n_clusters=n_clusters or 8, init="kmeans++", random_state=0)
        self._labels = None

    @property
    def labels_(self):
        return self._labels

    def _spectral_embedding(self, x: DNDarray, k: Optional[int] = None):
        """(the eigenvalues of T, ascending; the basis V (n, m) in L's row
        layout; T's eigenvectors)."""
        L = self._laplacian.construct(x)
        m = min(self.n_lanczos, L.shape[0])
        V, T = lanczos(L, m)
        del L
        evals, evecs = torch.linalg.eigh(T.larray)
        return evals, V, evecs

    def fit(self, x: DNDarray):
        evals, V, evecs = self._spectral_embedding(x)
        k = self.n_clusters
        if k is None:  # the largest eigengap (reference behavior)
            k = max(int(torch.argmax(torch.diff(evals)).item()) + 1, 2)
            self._cluster.n_clusters = k
        with _full_float32():
            emb = (V.larray @ evecs[:, :k]).contiguous()
        embedding = DNDarray(emb, (V.shape[0], k), types.canonical_heat_type(emb.dtype), V.split, V.device, V.comm,
                             V.balanced)
        self._cluster.fit(embedding)
        self._labels = self._cluster.labels_
        self._embedding = embedding
        self._eigenvalues = evals
        self._fit_shape = tuple(x.shape)
        return self

    def predict(self, x: DNDarray) -> DNDarray:
        """Labels of the FITTED data: a spectral embedding does not extend to
        other points (the reference has the same restriction)."""
        if self._labels is None:
            raise RuntimeError("fit must be called before predict")
        if tuple(x.shape) != self._fit_shape:
            raise NotImplementedError(
                "Spectral clustering cannot label out-of-sample points; re-fit on the combined data instead"
            )
        return self._labels
