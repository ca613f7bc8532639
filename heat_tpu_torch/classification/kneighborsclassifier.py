"""k-nearest-neighbours classifier (reference:
``heat_tpu/classification/kneighborsclassifier.py``).

Brute force, blocked: the queries (gathered where split: every rank scores
all of them) go in blocks against this rank's training rows, each block's
squared distances by the quadratic expansion (one full-float32 GEMM, at most
2^28 distances at once, where the reference forms the whole (n_query,
n_train) matrix), and a local top-k keeps each query's k nearest with their
global rows and labels.  Over ranks one Allgather of the p·k candidates a
query and a merge by (distance, global row) give the global k nearest.
Votes go to ``unique(y)``'s classes; a tie of votes goes to the smallest
class.  Equal distances go to the lower global row.
"""

from __future__ import annotations

import torch

from ..core import types
from ..core.base import BaseEstimator, ClassificationMixin
from ..core.dndarray import DNDarray
from ..core.sanitation import on_rows, rows_of, whole
from ..linalg.basics import _full_float32

__all__ = ["KNeighborsClassifier"]

_DISTANCES = 1 << 28  # distances of one query block


class KNeighborsClassifier(ClassificationMixin, BaseEstimator):
    """Brute-force k-nearest-neighbours classification (reference API:
    ``n_neighbors``)."""

    def __init__(self, n_neighbors: int = 5):
        self.n_neighbors = n_neighbors
        self.x_train = None
        self.y_train = None

    def fit(self, x: DNDarray, y: DNDarray) -> "KNeighborsClassifier":
        self.x_train = on_rows(x)
        self.y_train = y
        return self

    def predict(self, x: DNDarray) -> DNDarray:
        if self.x_train is None:
            raise RuntimeError("fit must be called before predict")
        from ..core.manipulations import unique

        train = self.x_train
        k = self.n_neighbors
        tl = train.larray.float()
        ylab = rows_of(self.y_train, train)
        offset = train.counts_displs()[1][train.comm.rank] if train.is_distributed() else 0
        q = whole(x).float()
        nq = q.shape[0]
        kk = min(k, tl.shape[0])
        tt = (tl * tl).sum(1)[None, :]
        block = max(1, _DISTANCES // max(tl.shape[0], 1))
        best_d = torch.empty((nq, kk), dtype=torch.float32, device=q.device)
        best_i = torch.empty((nq, kk), dtype=torch.int64, device=q.device)
        with _full_float32():
            for s in range(0, nq, block):
                qb = q[s:s + block]
                d2 = torch.addmm(tt, qb, tl.T, alpha=-2.0).add_((qb * qb).sum(1, keepdim=True))
                dv, di = torch.topk(d2, kk, 1, largest=False, sorted=True)
                best_d[s:s + block], best_i[s:s + block] = dv, di
                del d2
        best_l = ylab[best_i]
        best_r = best_i + offset
        if train.is_distributed():
            comm = train.comm
            best_d = torch.cat(comm.Allgather(best_d), 1)
            best_r = torch.cat(comm.Allgather(best_r), 1)
            best_l = torch.cat(comm.Allgather(best_l.contiguous()), 1)
        # the global k nearest by (distance, global row)
        by_row = torch.sort(best_r, dim=1, stable=True).indices
        best_d, best_r, best_l = best_d.gather(1, by_row), best_r.gather(1, by_row), best_l.gather(1, by_row)
        order = torch.sort(best_d, dim=1, stable=True).indices[:, :k]
        votes = best_l.gather(1, order)
        classes = whole(unique(self.y_train.flatten() if self.y_train.ndim > 1 else self.y_train))
        idx = torch.searchsorted(classes, votes.to(classes.dtype).contiguous())
        counts = torch.zeros((nq, classes.shape[0]), dtype=torch.int32, device=q.device)
        counts.scatter_add_(1, idx, torch.ones_like(idx, dtype=torch.int32))
        pred = classes[counts.argmax(1)]
        # split 0 for queries split along either axis (the reference's labels
        # are split 0 for split-1 queries too)
        split, balanced = (0, x.balanced if x.split == 0 else True) if x.split is not None else (None, True)
        if x.is_distributed() and split == 0:
            counts, displs = x.counts_displs() if x.split == 0 else x.comm.counts_displs_shape((nq,), 0)
            pred = pred[displs[x.comm.rank]: displs[x.comm.rank] + counts[x.comm.rank]].contiguous()
        return DNDarray(pred, (nq,), types.canonical_heat_type(pred.dtype), split, x.device, x.comm, balanced)
