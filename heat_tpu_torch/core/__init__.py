"""Core: types, devices, the communicator, DNDarray and its indexing,
factories, the op dispatch core, the element-wise and reduction surface,
statistics, manipulations, printing, random streams and tile views, the
convolutions, ``vmap`` and parallel I/O."""

from .version import __version__
from . import version
from . import axisspec
from .constants import *
from . import constants
from .types import *
from . import types
from .devices import *
from .communication import *
from .stride_tricks import *
from .dndarray import *
from . import dndarray
from .memory import *
from . import memory
from .sanitation import *
from . import sanitation
from .factories import *
from . import factories
from ._operations import *
from . import _operations
from .arithmetics import *
from . import arithmetics
from .relational import *
from . import relational
from .logical import *
from . import logical
from .rounding import *
from . import rounding
from .exponential import *
from . import exponential
from .trigonometrics import *
from . import trigonometrics
from .complex_math import *
from . import complex_math
from .statistics import *
from . import statistics
from .indexing import *
from . import indexing
from .printing import *
from . import printing
from .manipulations import *
from . import manipulations
from .base import *
from .bootstrap import *
from .tiling import *
from . import tiling
from . import random
from . import collectives
from . import redistribution
from .redistribution import set_redistribution_budget, get_redistribution_budget
from .vmap import *
from . import vmap
from .signal import *
from . import signal
from .io import *
from . import io
from . import bootstrap
