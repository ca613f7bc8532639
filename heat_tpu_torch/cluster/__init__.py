"""Clustering estimators (reference: ``heat/cluster/``)."""

from .batchparallelclustering import BatchParallelKMeans, BatchParallelKMedians
from .kmeans import KMeans
from .kmedians import KMedians
from .kmedoids import KMedoids
from .spectral import Spectral
