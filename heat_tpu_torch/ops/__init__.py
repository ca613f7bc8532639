"""Hand-written CUDA kernels and their plain PyTorch versions."""

from . import flash_attention  # the module: its entry point is flash_attention.flash_attention
from . import kmeans_kernels
from .kmeans_kernels import fused_assign, fused_em_stats, launch_counts
