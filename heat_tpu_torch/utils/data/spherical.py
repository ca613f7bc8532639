"""Synthetic clustered data (reference: ``heat/utils/data/spherical.py``).

The data is drawn on the target device, one rank's rows at a time, from
``torch.Generator``s seeded by ``(random_state, cluster, rank)``: a 1e8-row
set never passes through host memory.  The numbers differ from the JAX
package's and depend on the world size.
"""

from __future__ import annotations

import torch

from ...core import types
from ...core.communication import get_comm
from ...core.devices import sanitize_device
from ...core.dndarray import DNDarray
from ...core.random import generator

__all__ = ["create_spherical_dataset", "create_clusters"]


def create_spherical_dataset(
    num_samples_cluster: int,
    radius: float = 1.0,
    offset: float = 4.0,
    dtype=types.float32,
    random_state: int = 1,
    device=None,
) -> DNDarray:
    """Four Gaussian blobs in 3-D on a diagonal (the reference's KMeans test set), split=0."""
    means = [[(i - 1.5) * offset] * 3 for i in range(4)]
    return create_clusters(
        4 * num_samples_cluster, 3, 4, means, cluster_std=radius, device=device,
        random_state=random_state, dtype=dtype,
    )


def create_clusters(
    n_samples: int,
    n_features: int,
    n_clusters: int,
    cluster_mean,
    cluster_std=1.0,
    cluster_weight=None,
    device=None,
    random_state: int = 42,
    dtype=types.float32,
) -> DNDarray:
    """Gaussian blobs, split=0: cluster i holds a contiguous run of rows with
    mean ``cluster_mean[i]`` (a row of width ``n_features`` or a scalar) and
    standard deviation ``cluster_std`` (a scalar or one per cluster)."""
    device = sanitize_device(device)
    tdev = device.torch_device
    comm = get_comm()
    dtype = types.canonical_heat_type(dtype)
    means = torch.as_tensor(cluster_mean, dtype=torch.float32).to(tdev)
    if means.shape[0] != n_clusters:
        raise ValueError("cluster_mean must have n_clusters rows")
    means = means.reshape(n_clusters, -1).expand(n_clusters, n_features)
    stds = torch.as_tensor(cluster_std, dtype=torch.float32).reshape(-1).expand(n_clusters).tolist()
    if cluster_weight is None:
        counts = [n_samples // n_clusters] * n_clusters
    else:
        counts = [int(w * n_samples) for w in cluster_weight]
    counts[-1] += n_samples - sum(counts)

    gshape = (n_samples, n_features)
    off, lshape, _ = comm.chunk(gshape, 0)
    out = torch.empty(lshape, dtype=dtype.torch_type(), device=tdev)
    start = 0
    for i, cnt in enumerate(counts):
        lo, hi = max(start, off), min(start + cnt, off + lshape[0])
        if lo < hi:
            g = generator(random_state, i, comm.rank, device=tdev)
            blob = torch.randn((hi - lo, n_features), generator=g, device=tdev)
            out[lo - off : hi - off] = blob.mul_(stds[i]).add_(means[i])
        start += cnt
    return DNDarray(out, gshape, dtype, 0, device, comm, True)
