"""Utilities (reference: ``heat/utils/``)."""

from . import data
from . import convert
from . import faults
