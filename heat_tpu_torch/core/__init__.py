"""Core: types, devices, the communicator, DNDarray and factories."""

from .types import *
from .devices import *
from .communication import *
from .dndarray import *
from .factories import *
from .stride_tricks import *
from .sanitation import *
from .base import *
from .bootstrap import *
from . import random
