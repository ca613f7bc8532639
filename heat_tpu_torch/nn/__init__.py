"""NN layer (reference: ``heat_tpu/nn/``): the transformer path's modules."""

from .modules import *
from . import modules
from .attention import MultiheadAttention, apply_rope
from . import functional
from . import models
