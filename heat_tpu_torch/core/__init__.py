"""Core: types, devices, the communicator, DNDarray, factories, the op
dispatch core, the element-wise and reduction surface, and tile views."""

from .constants import *
from . import constants
from .types import *
from .devices import *
from .communication import *
from .stride_tricks import *
from .dndarray import *
from .memory import *
from . import memory
from .sanitation import *
from .factories import *
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
from .statistics import *
from . import statistics
from .base import *
from .bootstrap import *
from .tiling import *
from . import tiling
from . import random
from . import collectives
