"""Data utilities (reference: ``heat/utils/data/``)."""

from . import spherical
from .spherical import create_spherical_dataset, create_clusters
