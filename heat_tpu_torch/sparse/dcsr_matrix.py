"""The distributed CSR matrix (reference: ``heat/sparse/dcsr_matrix.py``).

A :class:`DCSR_matrix` holds this rank's rows as a ``torch.sparse_csr``
tensor (all rows where ``split`` is None) with the global shape and
number of nonzeros, split 0 or None, as HeAT's.  ``ldata``, ``lindices``
and ``lindptr`` are the local CSR arrays; ``data``, ``indices`` and
``indptr`` the global ones, gathered (collective where split).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core import types
from ..core.communication import Communication

__all__ = ["DCSR_matrix"]


class DCSR_matrix:
    """Distributed CSR: global shape, split along its rows (split 0) or not."""

    def __init__(self, array: torch.Tensor, gnnz: int, gshape: Tuple[int, int], dtype, split: Optional[int], device,
                 comm: Communication, balanced: bool = True):
        self.__array = array
        self.__gnnz = int(gnnz)
        self.__gshape = tuple(int(s) for s in gshape)
        self.__dtype = types.canonical_heat_type(dtype)
        self.__split = split
        self.__device = device
        self.__comm = comm
        self.__balanced = balanced

    @property
    def larray(self) -> torch.Tensor:
        """This rank's rows, a ``torch.sparse_csr`` tensor."""
        return self.__array

    @property
    def shape(self) -> Tuple[int, int]:
        return self.__gshape

    @property
    def gshape(self) -> Tuple[int, int]:
        return self.__gshape

    @property
    def lshape(self) -> Tuple[int, int]:
        return tuple(self.__array.shape)

    @property
    def nnz(self) -> int:
        return self.__gnnz

    @property
    def gnnz(self) -> int:
        return self.__gnnz

    @property
    def lnnz(self) -> int:
        return int(self.__array.values().numel())

    @property
    def dtype(self):
        return self.__dtype

    @property
    def split(self) -> Optional[int]:
        return self.__split

    @property
    def device(self):
        return self.__device

    @property
    def comm(self) -> Communication:
        return self.__comm

    @property
    def balanced(self) -> bool:
        return self.__balanced

    @property
    def ndim(self) -> int:
        return 2

    def is_distributed(self) -> bool:
        return self.__split is not None and self.__comm.is_distributed()

    @property
    def ldata(self) -> torch.Tensor:
        """This rank's nonzero values."""
        return self.__array.values()

    @property
    def lindices(self) -> torch.Tensor:
        """This rank's column indices."""
        return self.__array.col_indices()

    @property
    def lindptr(self) -> torch.Tensor:
        """This rank's row pointers."""
        return self.__array.crow_indices()

    def _global(self) -> torch.Tensor:
        if not self.is_distributed():
            return self.__array
        from .manipulations import _gather_csr

        return _gather_csr(self)

    @property
    def data(self) -> torch.Tensor:
        """The nonzero values of the whole matrix."""
        return self._global().values()

    @property
    def indices(self) -> torch.Tensor:
        """The column indices of the whole matrix's nonzeros."""
        return self._global().col_indices()

    @property
    def indptr(self) -> torch.Tensor:
        """The row pointers of the whole matrix."""
        return self._global().crow_indices()

    def todense(self):
        from .manipulations import todense

        return todense(self)

    def astype(self, dtype) -> "DCSR_matrix":
        dtype = types.canonical_heat_type(dtype)
        return DCSR_matrix(self.__array.to(dtype.torch_type()), self.__gnnz, self.__gshape, dtype, self.__split,
                           self.__device, self.__comm, self.__balanced)

    def copy(self) -> "DCSR_matrix":
        return DCSR_matrix(self.__array.clone(), self.__gnnz, self.__gshape, self.__dtype, self.__split,
                           self.__device, self.__comm, self.__balanced)

    def __matmul__(self, other):
        from .linalg import matmul

        return matmul(self, other)

    def __repr__(self) -> str:
        return (f"DCSR_matrix(shape={self.__gshape}, nnz={self.__gnnz}, dtype=ht.{self.__dtype.__name__}, "
                f"split={self.__split})")
