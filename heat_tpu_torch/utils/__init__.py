"""Utilities (reference: ``heat/utils/``)."""

from . import data
from . import convert
from . import faults
from . import flightrec
from . import health
from . import memledger
from . import monitor
from . import profiler
from . import telemetry
