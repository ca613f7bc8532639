"""Distributed linear algebra (reference: ``heat_tpu/linalg/``)."""

from .basics import *
from . import basics
