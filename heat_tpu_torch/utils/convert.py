"""Carry state over from the JAX package, through numpy only.

``kmeans_from_reference`` turns a fitted ``heat_tpu`` KMeans's attributes,
given as numpy values, into a fitted estimator of this package whose
``predict`` gives the reference's labels.  Nothing here imports JAX.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..cluster.kmeans import KMeans
from ..core import factories
from ..core.communication import Communication
from ..core.dndarray import DNDarray

__all__ = ["array_from_numpy", "kmeans_from_reference"]


def array_from_numpy(global_np: np.ndarray, split: Optional[int], comm: Optional[Communication] = None,
                     device=None) -> DNDarray:
    """A DNDarray of the GLOBAL numpy array, this rank keeping its chunk of ``split``."""
    return factories.array(np.asarray(global_np), split=split, comm=comm, device=device)


def kmeans_from_reference(state: Dict[str, np.ndarray], device=None) -> KMeans:
    """A fitted KMeans from ``cluster_centers_``, ``labels_``, ``inertia_`` and
    ``n_iter_`` of a fitted reference estimator (numpy arrays and scalars);
    ``labels_`` is split along axis 0 over the default communicator."""
    centers = np.asarray(state["cluster_centers_"])
    labels = array_from_numpy(np.asarray(state["labels_"]).astype(np.int32), 0, device=device)
    km = KMeans(n_clusters=centers.shape[0], init=centers)
    c = torch.tensor(centers, device=labels.larray.device)
    km._set_fitted(c.float(), c.dtype, labels, labels.larray, float(state["inertia_"]), int(state["n_iter_"]))
    return km
