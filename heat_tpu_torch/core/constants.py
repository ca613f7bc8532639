"""Mathematical constants (reference: ``heat_tpu/core/constants.py``).

Reference parity: ``heat.pi``, ``heat.e``, ``heat.inf``, ``heat.nan``.
"""

import math

__all__ = ["e", "euler_gamma", "inf", "nan", "pi", "E", "Inf", "Infty", "Infinity", "NaN"]

e = math.e
euler_gamma = 0.57721566490153286060651209008240243
inf = math.inf
nan = math.nan
pi = math.pi

# numpy-style aliases
E = e
Inf = inf
Infty = inf
Infinity = inf
NaN = nan
