"""Distributed sparse matrices (reference: ``heat/sparse/``), over ``torch.sparse_csr``."""

from .dcsr_matrix import DCSR_matrix
from .factories import sparse_csr_matrix, sparse_csc_matrix
from ._arithmetics import add, mul, sub, negative
from .manipulations import todense, to_dense, to_sparse, transpose
from .linalg import matmul
from . import factories
from . import linalg
from . import manipulations
