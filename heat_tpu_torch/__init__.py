"""heat_tpu_torch — the PyTorch/CUDA port of heat_tpu, for NVIDIA Hopper.

HeAT's design: a ``DNDarray`` is this process's local ``torch.Tensor`` plus
its global shape and split axis, and a communicator over
``torch.distributed`` (gloo on the CPU, NCCL on the card) issues the
collectives.  ``import heat_tpu_torch as ht`` reads like ``heat_tpu``.
``x @ y`` (``ht.matmul``) multiplies split arrays, ``ht.qr`` and ``ht.svd``
factor tall-skinny ones (TSQR), ``ht.spatial.cdist`` takes pairwise
distances, and
``ht.parallel.ring_attention`` runs attention over a sequence split across
the ranks, and ``ht.nn.DataParallel`` and ``ht.optim.DASO`` train a model
data-parallel over the ranks.  The sklearn-style estimators of
``cluster``, ``decomposition``, ``regression``, ``naive_bayes``,
``classification`` and ``preprocessing`` fit split arrays.
Arrays live on the card (``'gpu'``) unless the caller asks for the CPU.
"""

from .core import *
from . import core
from .core import axisspec
from .core import random
from .core.redistribution import set_redistribution_budget, get_redistribution_budget
from .core.collectives import set_grad_bucket_budget, get_grad_bucket_budget
from . import linalg
from .linalg import matmul, dot, transpose, norm
from .linalg.basics import (cross, einsum, einsum_path, inner, kron, matmul_summa, matrix_norm, outer, projection,
                            tensordot, trace, tril, triu, vdot, vecdot, vector_norm)
from .linalg.qr import qr
from .linalg.svdtools import svd
from . import spatial
from . import cluster
from . import decomposition
from . import regression
from . import naive_bayes
from . import classification
from . import preprocessing
from . import graph
from . import nn
from . import optim
from . import ops
from . import parallel
from . import utils
from . import fft
from . import sparse

__version__ = core.version.__version__
