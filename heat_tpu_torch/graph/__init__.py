"""Graph tools (reference: ``heat_tpu/graph/``)."""

from .laplacian import Laplacian
