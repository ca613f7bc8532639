"""Optimizers (reference: ``heat_tpu/optim/``)."""

from .dp_optimizer import DataParallelOptimizer
