"""heat_tpu_torch — the PyTorch/CUDA port of heat_tpu, for NVIDIA Hopper.

HeAT's design: a ``DNDarray`` is this process's local ``torch.Tensor`` plus
its global shape and split axis, and a communicator over
``torch.distributed`` (gloo on the CPU, NCCL on the card) issues the
collectives.  ``import heat_tpu_torch as ht`` reads like ``heat_tpu``.
Arrays live on the card (``'gpu'``) unless the caller asks for the CPU.
"""

from .core import *
from . import core
from .core import random
from . import cluster
from . import nn
from . import optim
from . import ops
from . import utils

__version__ = "0.1.0"
