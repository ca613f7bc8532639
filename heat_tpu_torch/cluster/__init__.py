"""Clustering estimators (reference: ``heat/cluster/``)."""

from .kmeans import KMeans
