"""Decompositions (reference: ``heat_tpu/decomposition/``)."""

from .dmd import DMD
from .pca import PCA, IncrementalPCA
