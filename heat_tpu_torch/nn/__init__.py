"""NN layer (reference: ``heat_tpu/nn/``): modules, activations, losses, the spatial, padding and recurrent
layers, mixture of experts, pipelines, models and data-parallel training."""

from .modules import *
from . import modules
from .activations import *
from .losses import *
from .spatial import *
from .padshuffle import *
from .extended import *
from . import activations, extended, losses, padshuffle, spatial
from .attention import MultiheadAttention, apply_rope
from .moe import MoE
from .pipelined import Pipelined
from .recurrent import GRU, GRUCell, LSTM, LSTMCell, RNN, RNNCell
from . import functional
from . import models
from .data_parallel import DataParallel, DataParallelMultiGPU
from . import data_parallel
