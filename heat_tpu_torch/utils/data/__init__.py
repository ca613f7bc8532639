"""Data utilities (reference: ``heat/utils/data/``)."""

from . import matrixgallery
from . import spherical
from .spherical import create_spherical_dataset, create_clusters
from .datatools import Dataset, DataLoader, dataset_shuffle, dataset_ishuffle
from . import partial_dataset
from .partial_dataset import PartialH5Dataset
