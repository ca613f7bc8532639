"""Naive Bayes (reference: ``heat_tpu/naive_bayes/``)."""

from .gaussianNB import GaussianNB
