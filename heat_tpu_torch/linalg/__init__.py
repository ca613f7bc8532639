"""Distributed linear algebra (reference: ``heat_tpu/linalg/``)."""

from .basics import *
from . import basics
from .qr import *
from . import qr as _qr_module
from .svdtools import *
from . import svdtools
from .solver import *
from . import solver
