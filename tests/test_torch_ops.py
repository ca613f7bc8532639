"""heat_tpu_torch's arithmetic, relational and logical surface against heat_tpu.

Every function of ``core/arithmetics.py``, ``core/relational.py`` and
``core/logical.py`` once, at world size 1 on the CPU, on the same numpy
inputs (13 x 7, from ``np.random.default_rng``) as the reference on its
8-device CPU mesh: global value, dtype, shape and split.  Tolerances:
integer and bool results exactly; float32 rtol 1e-5, atol 1e-6.  The result
dtypes of a table of type pairs (operand dtypes and weakly typed Python
scalars) are held against the reference's, where torch's own rules differ.
"""

import warnings

import numpy as np
import pytest
import torch

import heat_tpu
import heat_tpu_torch as htt

RNG = np.random.default_rng(3)
X = RNG.standard_normal((13, 7)).astype(np.float32)
Y = RNG.standard_normal((13, 7)).astype(np.float32)
POS = np.abs(X) + 0.25
I = RNG.integers(-9, 10, (13, 7)).astype(np.int32)
J = RNG.integers(1, 6, (13, 7)).astype(np.int32)
B = X > 0
C = Y > 0


@pytest.fixture(autouse=True)
def on_cpu():
    prev = htt.get_device()
    htt.use_device("cpu")
    yield
    htt.use_device(prev)


def same(got, want, rtol=1e-5, atol=1e-6):
    """Global value, dtype, shape and split of a port result against the reference's."""
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            same(g, w, rtol, atol)
        return
    if not hasattr(want, "split"):
        assert type(got) is type(want) or isinstance(got, (bool, float, int)), (got, want)
        assert got == pytest.approx(want, rel=rtol, abs=atol)
        return
    assert got.dtype.__name__ == want.dtype.__name__, (got.dtype, want.dtype)
    assert tuple(got.shape) == tuple(want.shape) and got.split == want.split, (got.shape, got.split, want.split)
    g, w = got.numpy(), np.asarray(want.numpy())
    if w.dtype.kind in "biu":
        np.testing.assert_array_equal(g, w)
    else:
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, equal_nan=True)


def both(fn, *arrays, split=0):
    """``fn`` of each package's arrays of ``arrays`` (numpy in, split as given)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return (fn(htt, *[htt.array(a, split=split) if isinstance(a, np.ndarray) else a for a in arrays]),
                fn(heat_tpu, *[heat_tpu.array(a, split=split) if isinstance(a, np.ndarray) else a for a in arrays]))


BINARY = {
    "add": (X, Y), "sub": (X, Y), "subtract": (I, J), "mul": (X, Y), "multiply": (I, 3), "div": (X, POS),
    "divide": (I, J), "true_divide": (X, 2.5), "floordiv": (X, POS), "floor_divide": (I, J), "mod": (I, -J),
    "remainder": (X, -POS), "fmod": (I, -J), "pow": (POS, Y), "power": (I, 3), "copysign": (X, Y),
    "hypot": (X, Y), "gcd": (I, J), "lcm": (I, J), "float_power": (POS, 1.5), "ldexp": (X, J),
    "heaviside": (X, 0.5), "bitwise_and": (I, J), "bitwise_or": (B, C), "bitwise_xor": (I, J),
    "left_shift": (J, J), "right_shift": (I, J), "bitwise_left_shift": (J, 2), "bitwise_right_shift": (I, 1),
    "nextafter": (X, Y),
    "eq": (I, J), "equal": (X, X), "ge": (X, Y), "greater_equal": (I, 0), "gt": (X, Y), "greater": (X, 0.0),
    "le": (X, Y), "less_equal": (I, J), "lt": (X, Y), "less": (I, 2), "ne": (I, J), "not_equal": (B, C),
    "isclose": (X, X + 1e-7), "allclose": (X, X + 1e-7), "logical_and": (B, C), "logical_or": (X, C),
    "logical_xor": (B, C),
}


@pytest.mark.parametrize("name", list(BINARY))
def test_binary_op_matches_reference(name):
    a, b = BINARY[name]
    same(*both(lambda ht, x, y: getattr(ht, name)(x, y), a, b))


def test_divmod_matches_reference():
    same(*both(lambda ht, x, y: ht.divmod(x, y), I, -J))


UNARY = {
    "neg": X, "negative": I, "pos": X, "positive": I, "invert": I, "bitwise_not": B, "bitwise_invert": I,
    "reciprocal": POS, "spacing": X, "i0": X, "bitwise_count": I, "isfinite": X, "isinf": X, "isnan": X,
    "isneginf": X, "isposinf": X, "logical_not": X, "signbit": X,
}


@pytest.mark.parametrize("name", list(UNARY))
def test_unary_op_matches_reference(name):
    same(*both(lambda ht, x: getattr(ht, name)(x), UNARY[name], split=1))


REDUCTIONS = {"sum": X, "prod": POS, "nansum": np.where(B, np.nan, X), "nanprod": np.where(B, np.nan, POS),
              "all": B, "any": B, "count_nonzero": I}


@pytest.mark.parametrize("name", list(REDUCTIONS))
def test_reduction_matches_reference(name):
    for axis in (None, 0, 1):
        same(*both(lambda ht, x: getattr(ht, name)(x, axis=axis), REDUCTIONS[name]))


@pytest.mark.parametrize("name", ["cumsum", "cumprod", "nancumsum", "nancumprod"])
def test_scan_matches_reference(name):
    data = np.where(B, np.nan, POS) if name.startswith("nan") else POS
    for axis in (0, 1):
        same(*both(lambda ht, x: getattr(ht, name)(x, axis), data))


def test_diff_and_ediff1d_match_reference():
    same(*both(lambda ht, x: ht.diff(x, n=2, axis=1), X))
    same(*both(lambda ht, x: ht.diff(x, axis=0, prepend=0.0), X, split=1))
    same(*both(lambda ht, x: ht.ediff1d(x, to_begin=[7.0], to_end=[8.0, 9.0]), X))


def test_trapezoid_and_gradient_match_reference():
    same(*both(lambda ht, x: ht.trapezoid(x, axis=1), X))
    same(*both(lambda ht, x: ht.trapz(x, dx=0.5, axis=0), X, split=1))
    same(*both(lambda ht, x: ht.gradient(x), X))
    same(*both(lambda ht, x: ht.gradient(x, 2.0, axis=1), X))


def test_interp_matches_reference():
    xp = np.linspace(-3, 3, 9).astype(np.float32)
    fp = np.sin(xp).astype(np.float32)
    same(*both(lambda ht, x: ht.interp(x, xp, fp), X))
    same(*both(lambda ht, x: ht.interp(x, xp, fp, left=-5.0, right=5.0), X))
    same(*both(lambda ht, x: ht.interp(x, xp, fp, period=4.0), X))


def test_membership_and_array_predicates_match_reference():
    same(*both(lambda ht, x: ht.isin(x, [1, 2, 3]), I))
    same(*both(lambda ht, x: ht.isin(x, [1, 2, 3], invert=True), I, split=1))
    same(*both(lambda ht, x: ht.in1d(x, np.array([0, 4])), I))
    for fn in ("array_equal", "array_equiv"):
        same(*both(lambda ht, x, y: getattr(ht, fn)(x, y), X, X))
        same(*both(lambda ht, x, y: getattr(ht, fn)(x, y), X, Y))
    same(*both(lambda ht, x: ht.array_equiv(x, x[0]), X))
    for fn in ("iscomplexobj", "isrealobj", "isscalar"):
        same(*both(lambda ht, x: getattr(ht, fn)(x), X))
        assert getattr(htt, fn)(1.5) == getattr(heat_tpu, fn)(1.5)


def test_operators_match_reference():
    ops = [lambda x, y: x + y, lambda x, y: 2 - x, lambda x, y: x * y, lambda x, y: x / 2, lambda x, y: 3 / y,
           lambda x, y: x // y, lambda x, y: 7 // y, lambda x, y: x % y, lambda x, y: x ** 2, lambda x, y: 2 ** y,
           lambda x, y: -x, lambda x, y: +x, lambda x, y: abs(x), lambda x, y: x == y, lambda x, y: x != y,
           lambda x, y: x < y, lambda x, y: x <= y, lambda x, y: x > y, lambda x, y: x >= y]
    for op in ops:
        same(*both(lambda ht, x, y: op(x, y), I, J))
    for op in (lambda x, y: x & y, lambda x, y: x | y, lambda x, y: x ^ y, lambda x, y: ~x, lambda x, y: x << 1,
               lambda x, y: x >> 1):
        same(*both(lambda ht, x, y: op(x, y), J, J))
    same(*both(lambda ht, x, y: x.sum(1, keepdims=True) + x.prod(0).sum() + x.cumsum(0) + x.mod(3) + x.fmod(2), J, J))


@pytest.mark.parametrize("op", ["__iadd__", "__isub__", "__imul__", "__itruediv__", "__ifloordiv__", "__imod__",
                                "__ipow__"])
def test_in_place_operator_changes_the_local_tensor_in_place(op):
    x = htt.array(POS, split=0)
    storage = x.larray.data_ptr()
    ref = heat_tpu.array(POS, split=0)
    got = getattr(x, op)(htt.array(J, split=1)) if op != "__ipow__" else getattr(x, op)(2)
    want = getattr(ref, op)(heat_tpu.array(J, split=1)) if op != "__ipow__" else getattr(ref, op)(2)
    assert got is x and x.larray.data_ptr() == storage
    same(got, want)
    with pytest.raises(ValueError):
        x += htt.ones((2, 13, 7))


# result dtypes of type pairs: (left, right) numpy dtypes or Python scalars
TYPE_PAIRS = [("int32", "int32"), ("int8", "int8"), ("uint8", "int32"), ("bool", "bool"), ("bool", "int32"),
              ("int32", "float32"), ("int16", "float16"), ("uint8", -1), ("int32", 2.5), ("bool", 2),
              ("bool", True), ("float16", 2), ("int8", 300)]
TYPE_OPS = ["add", "sub", "mul", "div", "floordiv", "mod", "pow"]


def _typed(kind):
    if not isinstance(kind, str):
        return kind
    if kind == "bool":
        return B
    return (np.abs(I) % 4 + 1).astype(kind)


@pytest.mark.parametrize("op", TYPE_OPS)
@pytest.mark.parametrize("pair", TYPE_PAIRS, ids=str)
def test_result_dtype_table_matches_reference(op, pair):
    """int32 / int32 is float32; bools compute in int32 under sub, floordiv,
    mod and pow and a bool with a Python int gives int32; uint8 with a
    negative Python int wraps; int ** negative int gives the reference's
    values; mod takes the divisor's sign; no result is 64-bit."""
    a, b = (_typed(k) for k in pair)
    try:
        want = both(lambda ht, x, y: getattr(ht, op)(x, y), a, b)[1]
    except (TypeError, OverflowError, ValueError) as err:  # the reference refuses the pair: so does the port
        with pytest.raises(Exception):
            both(lambda ht, x, y: getattr(ht, op)(x, y), a, b)
        return err
    got = both(lambda ht, x, y: getattr(ht, op)(x, y), a, b)[0]
    same(got, want)
    reverse = both(lambda ht, x, y: getattr(ht, op)(y, x), a, b)
    same(*reverse)


def test_relational_binds_unhashable_and_equal_to_a_non_array():
    x = htt.array(X)
    with pytest.raises(TypeError):
        hash(x)
    assert htt.equal(x, htt.array(X)) is True and htt.equal(x, htt.zeros((2, 2))) is False
