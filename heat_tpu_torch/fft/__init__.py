"""FFT operations (reference: ``heat/fft/``), over ``torch.fft`` (cuFFT on the card)."""

from .fft import *
from . import fft
