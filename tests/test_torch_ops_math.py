"""heat_tpu_torch's rounding, exponential, trigonometric and constants
surface (and the extrema of ``statistics``) against heat_tpu.

Every function of ``core/rounding.py``, ``core/exponential.py``,
``core/trigonometrics.py`` and ``core/constants.py`` once, at world size 1
on the CPU, on the same numpy inputs as the reference on its 8-device CPU
mesh: global value, dtype, shape and split.  Tolerances: integer and bool
results exactly; float32 rtol 1e-5, atol 1e-6.  Integer inputs are checked
too where the reference's result dtype differs from torch's own.
"""

import numpy as np
import pytest

import heat_tpu
import heat_tpu_torch as htt
from test_torch_ops import both, same

RNG = np.random.default_rng(4)
X = (RNG.standard_normal((13, 7)) * 3).astype(np.float32)
POS = np.abs(X) + 0.25
UNIT = np.tanh(X).astype(np.float32)  # in (-1, 1)
BIG = 1.0 + POS  # > 1
I = RNG.integers(-9, 10, (13, 7)).astype(np.int32)
B = X > 0


@pytest.fixture(autouse=True)
def on_cpu():
    prev = htt.get_device()
    htt.use_device("cpu")
    yield
    htt.use_device(prev)


UNARY = {
    # rounding
    "abs": (X, I, B), "absolute": (X,), "ceil": (X, I, B), "fabs": (X, I), "floor": (X, I), "rint": (X, I),
    "round": (X, I), "around": (X,), "sgn": (X, I), "sign": (X, I), "trunc": (X, I), "fix": (X, I),
    "nan_to_num": (np.where(B, np.inf, np.nan).astype(np.float32), I),
    # exponential
    "exp": (X, I), "expm1": (X, I), "exp2": (X, I), "log": (POS, np.abs(I) + 1), "log2": (POS,), "log10": (POS,),
    "log1p": (POS, np.abs(I)), "sqrt": (POS, np.abs(I)), "square": (X, I, B), "cbrt": (X, I), "rsqrt": (POS,),
    # trigonometric
    "arccos": (UNIT,), "acos": (UNIT,), "arccosh": (BIG,), "acosh": (BIG,), "arcsin": (UNIT,), "asin": (UNIT,),
    "arcsinh": (X,), "asinh": (X,), "arctan": (X, I), "atan": (X,), "arctanh": (UNIT,), "atanh": (UNIT,),
    "cos": (X, I), "cosh": (X,), "deg2rad": (X, I), "degrees": (X,), "rad2deg": (X,), "radians": (X,),
    "sin": (X,), "sinc": (X, I), "sinh": (X,), "tan": (UNIT,), "tanh": (X,),
}


@pytest.mark.parametrize("name", list(UNARY))
def test_unary_op_matches_reference(name):
    for data in UNARY[name]:
        same(*both(lambda ht, x: getattr(ht, name)(x), data, split=1))


@pytest.mark.parametrize("name", ["logaddexp", "logaddexp2", "arctan2", "atan2", "maximum", "minimum"])
def test_binary_op_matches_reference(name):
    same(*both(lambda ht, x, y: getattr(ht, name)(x, y), X, UNIT))
    same(*both(lambda ht, x, y: getattr(ht, name)(x, y), I, X))


def test_clip_frexp_modf_round_decimals_match_reference():
    same(*both(lambda ht, x: ht.clip(x, -1.5, 2.0), X))
    same(*both(lambda ht, x: ht.clip(x, 0, 1), B))
    # array bounds on replicated arrays: the reference's clip takes no array
    # bound beside a ragged split array (its padded shards do not broadcast)
    same(*both(lambda ht, x, lo: ht.clip(x, lo, None), X, UNIT, split=None))
    same(*both(lambda ht, x: ht.frexp(x), X))
    same(*both(lambda ht, x: ht.modf(x), X))
    same(*both(lambda ht, x: ht.round(x, decimals=2), X))
    same(*both(lambda ht, x: ht.abs(x, dtype=ht.float32), I))
    same(*both(lambda ht, x: ht.real_if_close(x), X))


@pytest.mark.parametrize("name", ["max", "min", "amax", "amin"])
def test_extrema_match_reference(name):
    for axis in (None, 0, 1):
        same(*both(lambda ht, x: getattr(ht, name)(x, axis=axis), X))
    same(*both(lambda ht, x: getattr(ht, name)(x, axis=1, keepdims=True), I, split=1))


def test_methods_match_reference():
    for method in ("abs", "ceil", "floor", "round", "trunc", "sign", "exp", "log", "sqrt", "square", "exp2", "log1p",
                   "log2", "log10", "expm1", "sin", "cos", "tan", "sinh", "cosh", "tanh", "max", "min"):
        same(*both(lambda ht, x: getattr(x, method)(), POS))
    same(*both(lambda ht, x: x.arcsin() + x.arccos() + x.arctan() + x.clip(0.1, 0.5), UNIT))
    same(*both(lambda ht, x: x.modf(), X))


@pytest.mark.parametrize("name", heat_tpu.core.constants.__all__)
def test_constants_match_reference(name):
    a, b = getattr(htt, name), getattr(heat_tpu, name)
    assert a == b or (np.isnan(a) and np.isnan(b))


def test_out_buffer_is_written_in_place():
    out, ref = htt.zeros((13, 7), split=1), heat_tpu.zeros((13, 7), split=1)
    storage = out.larray.data_ptr()
    got = htt.exp(htt.array(X, split=1), out=out)
    assert got is out and out.larray.data_ptr() == storage
    same(got, heat_tpu.exp(heat_tpu.array(X, split=1), out=ref))
    # a buffer of another split is resplit first, with the reference's warning
    other, rother = htt.zeros((13, 7), split=0), heat_tpu.zeros((13, 7), split=0)
    with pytest.warns(UserWarning, match="resplitting out"):
        got = htt.exp(htt.array(X, split=1), out=other)
    with pytest.warns(UserWarning, match="resplitting out"):
        same(got, heat_tpu.exp(heat_tpu.array(X, split=1), out=rother))
    with pytest.raises(ValueError):
        htt.exp(htt.array(X, split=1), out=htt.zeros((13, 6), split=1))
