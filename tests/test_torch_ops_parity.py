"""Parity repairs of heat_tpu_torch's array core against heat_tpu: boolean
masks in ``DNDarray.__getitem__``, and the element-wise results that
differed from the reference's or raised where it computes.

At world size 1 on the CPU, on the same numpy inputs as the reference on
its 8-device CPU mesh, each case at split None, 0 and 1: value, dtype,
shape and split.  The inputs are 13 x 7 float32 with nan, +-inf and -0.0,
int32, uint8 (with 254 and 255) and bool, alone, with each other and with
Python scalars.  Masks select exactly; everything else rtol 1e-5, atol
1e-6, nan equal.  Where the reference raises, the port raises too.
"""

import warnings

import numpy as np
import pytest
import torch

import heat_tpu
import heat_tpu_torch as htt
from test_torch_ops import same

RNG = np.random.default_rng(61)
F = (RNG.standard_normal((13, 7)) * 3).astype(np.float32)
F.flat[[0, 9, 17, 30, 44]] = [np.nan, np.inf, -np.inf, -0.0, 0.0]
I = RNG.integers(-9, 10, (13, 7)).astype(np.int32)
U = RNG.integers(0, 256, (13, 7)).astype(np.uint8)
U.flat[[1, 2, 3]] = [254, 255, 0]
B = F > 0
C = I > 0
SPLITS = [None, 0, 1]


@pytest.fixture(autouse=True)
def on_cpu():
    prev = htt.get_device()
    htt.use_device("cpu")
    yield
    htt.use_device(prev)


def run(fn, split):
    """``fn(ht, f, i, u, b, c)`` in both packages, the arrays at ``split``."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return tuple(fn(pkg, *[pkg.array(a, split=split) for a in (F, I, U, B, C)]) for pkg in (htt, heat_tpu))


# --------------------------------------------------------------------- #
# boolean masks
# --------------------------------------------------------------------- #
ROWS = np.arange(10, dtype=np.float32)
MASKS = {
    "numpy_alternate": lambda ht, x: x[np.array([True, False] * 5)],
    "dndarray_x_gt_4": lambda ht, x: x[x > 4],
    "list_all_true": lambda ht, x: x[[True] * 10],
    "torch_mask": lambda ht, x: x[torch.from_numpy(ROWS % 3 == 0)] if ht is htt else x[ROWS % 3 == 0],
    "mask_of_other_split": lambda ht, x: x[ht.array(ROWS > 6, split=None if x.split == 0 else 0)],
    "none_selected": lambda ht, x: x[np.zeros(10, dtype=bool)],
}


@pytest.mark.parametrize("split", [None, 0])
@pytest.mark.parametrize("case", list(MASKS))
def test_bool_mask_selects_rows_as_the_reference(case, split):
    got, want = (MASKS[case](pkg, pkg.array(ROWS, split=split)) for pkg in (htt, heat_tpu))
    same(got, want)


@pytest.mark.parametrize("split", SPLITS)
def test_bool_mask_of_a_matrix_matches_reference(split):
    rows = np.array([True, False, True] * 4 + [False])
    same(*run(lambda ht, f, i, u, b, c: [i[rows], i[i > 0], f[rows, 2:] if split != 1 else f[rows]], split))


def test_bool_mask_of_the_wrong_length_raises():
    for pkg in (htt, heat_tpu):
        for split in (None, 0):
            with pytest.raises(IndexError):
                pkg.array(ROWS, split=split)[np.array([True, False] * 4)]
    with pytest.raises(IndexError):
        htt.array(ROWS, split=0)[htt.array(np.ones(9, dtype=bool))]


# --------------------------------------------------------------------- #
# element-wise results
# --------------------------------------------------------------------- #
CASES = {
    "sign": lambda ht, f, i, u, b, c: [ht.sign(f), ht.sign(i), ht.sign(u)],
    "sgn": lambda ht, f, i, u, b, c: [ht.sgn(f), ht.sgn(i)],
    "heaviside": lambda ht, f, i, u, b, c: [ht.heaviside(f, 0.5), ht.heaviside(f, f), ht.heaviside(i, i),
                                            ht.heaviside(i, 1), ht.heaviside(u, 0.25), ht.heaviside(b, c)],
    "isin": lambda ht, f, i, u, b, c: [ht.isin(u, [-2, 10]), ht.isin(u, -2), ht.isin(u, np.array([-2, 254])),
                                       ht.isin(b, [True]), ht.isin(i, [2.5, 7.0]), ht.isin(c, [1, 5]),
                                       ht.isin(f, [np.float32(F[1, 1]).item(), 0.0]), ht.isin(u, [-2], invert=True)],
    "in1d": lambda ht, f, i, u, b, c: [ht.in1d(u, [-2, 10]), ht.in1d(b, [False]), ht.in1d(i, [-3, 3])],
    "trapz": lambda ht, f, i, u, b, c: [ht.trapz(u, axis=0), ht.trapz(u, axis=1), ht.trapz(b, axis=0),
                                        ht.trapz(i, dx=0.5, axis=0), ht.trapezoid(u, dx=2.0, axis=1)],
    "logical_and": lambda ht, f, i, u, b, c: [ht.logical_and(f, 3), ht.logical_and(-2, i), ht.logical_and(b, True),
                                              ht.logical_and(u, 0)],
    "logical_or": lambda ht, f, i, u, b, c: [ht.logical_or(i, 0), ht.logical_or(b, 2.5), ht.logical_or(0, u)],
    "logical_xor": lambda ht, f, i, u, b, c: [ht.logical_xor(b, True), ht.logical_xor(f, 0.0), ht.logical_xor(i, -2)],
    "shifts": lambda ht, f, i, u, b, c: [ht.left_shift(b, c), ht.right_shift(b, c), ht.left_shift(b, True),
                                         ht.bitwise_left_shift(b, 2), ht.right_shift(i, c), ht.left_shift(u, c)],
    "pos": lambda ht, f, i, u, b, c: [ht.pos(b), ht.positive(b), ht.pos(u), +b],
    "ldexp": lambda ht, f, i, u, b, c: [ht.ldexp(b, c), ht.ldexp(f, c), ht.ldexp(i, c), ht.ldexp(u, 2)],
}


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("case", list(CASES))
def test_elementwise_matches_reference(case, split):
    same(*run(CASES[case], split))


def test_trapz_of_uint8_sums_in_uint8_as_numpy():
    """The reference adds neighbours in uint8 (250 + 10 wraps to 4), as
    numpy's ``trapezoid`` does."""
    y = np.array([250, 10, 200, 255], dtype=np.uint8)
    for split in (None, 0):
        got = htt.trapz(htt.array(y, split=split))
        same(got, heat_tpu.trapz(heat_tpu.array(y, split=split)))
        assert got.item() == 206.5 == np.trapezoid(y)


@pytest.mark.parametrize("split", SPLITS)
def test_bool_matmul_is_the_or_of_ands(split):
    a = RNG.random((13, 7)) > 0.6
    b = RNG.random((7, 5)) > 0.6
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = htt.matmul(htt.array(a, split=split), htt.array(b, split=split))
        want = heat_tpu.matmul(heat_tpu.array(a, split=split), heat_tpu.array(b, split=split))
    same(got, want)
    np.testing.assert_array_equal(got.numpy(), (a.astype(int) @ b.astype(int)) > 0)


def test_integer_power_of_a_negative_exponent_is_the_references_at_every_split():
    """A recorded divergence: the reference computes ``int ** negative int``
    by its binary exponentiation on a replicated array and raises on a split
    one (``integer_pow``); the port gives the replicated array's values at
    every split."""
    fn = lambda ht, f, i, u, b, c: [i ** -1, ht.pow(i, -2), ht.pow(i, i)]  # noqa: E731
    got, want = run(fn, None)
    same(got, want)
    for split in (0, 1):
        for g, w in zip(fn(htt, *[htt.array(a, split=split) for a in (F, I, U, B, C)]), want):
            assert g.split == split
            np.testing.assert_array_equal(g.numpy(), np.asarray(w.numpy()))
        with pytest.raises(TypeError):
            heat_tpu.array(I, split=split) ** -1


RAISES = {
    "rsqrt_of_int": lambda ht, f, i, u, b, c: ht.rsqrt(i),
    "round_int_negative_decimals": lambda ht, f, i, u, b, c: ht.round(i, decimals=-1),
    "round_uint8_negative_decimals": lambda ht, f, i, u, b, c: ht.round(u, decimals=-2),
    "ldexp_float_exponent": lambda ht, f, i, u, b, c: ht.ldexp(f, 1.5),
    "ldexp_float_array_exponent": lambda ht, f, i, u, b, c: ht.ldexp(f, f),
    "sign_of_bool": lambda ht, f, i, u, b, c: ht.sign(b),
}


@pytest.mark.parametrize("case", list(RAISES))
def test_raises_where_the_reference_raises(case):
    for pkg in (htt, heat_tpu):
        arrays = [pkg.array(a, split=0) for a in (F, I, U, B, C)]
        with pytest.raises((TypeError, ValueError, NotImplementedError)):
            RAISES[case](pkg, *arrays)
