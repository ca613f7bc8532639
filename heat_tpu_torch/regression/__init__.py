"""Regression (reference: ``heat_tpu/regression/``)."""

from .lasso import Lasso
