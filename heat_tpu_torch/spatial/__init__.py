"""Distance computations (reference: ``heat_tpu/spatial/``)."""

from .distance import *
from . import distance
