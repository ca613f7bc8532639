"""NN layer (reference: ``heat_tpu/nn/``): modules, losses, models and data-parallel training."""

from .modules import *
from . import modules
from .attention import MultiheadAttention, apply_rope
from .losses import CrossEntropyLoss, L1Loss, MSELoss, NLLLoss
from . import losses
from . import functional
from . import models
from .data_parallel import DataParallel, DataParallelMultiGPU
from . import data_parallel
