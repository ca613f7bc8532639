"""Optimizers (reference: ``heat_tpu/optim/``): the data-parallel optimizer, DASO and the learning-rate schedules."""

from .dp_optimizer import DASO, SGD, Adam, AdamW, DataParallelOptimizer
from . import lr_scheduler
