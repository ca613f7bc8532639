"""heat_tpu_torch's ``spatial`` (``cdist``, ``cdist_small``, ``cdist_ring``,
``manhattan``, ``rbf``) against heat_tpu.

At world size 1 on the CPU, on the same numpy inputs (``np.random.
default_rng``) as the reference on its 8-device CPU mesh, every function at
every (x.split, y.split) pair of None, 0 and 1, and with y omitted: value,
dtype, shape and split.  Tolerances (float32): rtol 1e-5, atol 1e-6 for the
direct form and the kernel; the quadratic expansion rtol 1e-5, atol 1e-5
times the largest distance (its GEMM sums in another order than the
reference's), on x != y, where no distance cancels to 0.  Integer inputs
exactly (manhattan stays integer, as in the reference).
"""

import warnings

import numpy as np
import pytest
import torch

import heat_tpu
import heat_tpu_torch as htt

RNG = np.random.default_rng(41)
X = RNG.standard_normal((13, 5)).astype(np.float32)
Y = (RNG.standard_normal((11, 5)) + 0.5).astype(np.float32)
IX = RNG.integers(-6, 7, (9, 3)).astype(np.int32)
IY = RNG.integers(-6, 7, (7, 3)).astype(np.int32)
SPLITS = [None, 0, 1]

FUNCS = {
    "cdist": lambda ht, x, y: ht.spatial.cdist(x, y),
    "cdist_small": lambda ht, x, y: ht.spatial.cdist_small(x, y),
    "cdist_expansion": lambda ht, x, y: ht.spatial.cdist(x, y, quadratic_expansion=True),
    "cdist_ring": lambda ht, x, y: ht.spatial.cdist_ring(x, y),
    "manhattan": lambda ht, x, y: ht.spatial.manhattan(x, y),
    "rbf": lambda ht, x, y: ht.spatial.rbf(x, y, sigma=1.5),
    "rbf_expansion": lambda ht, x, y: ht.spatial.rbf(x, y, sigma=0.8, quadratic_expansion=True),
}
EXPANSION = ("cdist_expansion", "cdist_ring", "rbf_expansion")


@pytest.fixture(autouse=True)
def on_cpu():
    prev = htt.get_device()
    htt.use_device("cpu")
    yield
    htt.use_device(prev)


def run(name, x, y, sx, sy):
    fn = FUNCS[name]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = fn(htt, htt.array(x, split=sx), None if y is None else htt.array(y, split=sy))
        want = fn(heat_tpu, heat_tpu.array(x, split=sx), None if y is None else heat_tpu.array(y, split=sy))
    assert got.dtype.__name__ == want.dtype.__name__, (got.dtype, want.dtype)
    assert tuple(got.shape) == tuple(want.shape) and got.split == want.split, (got.split, want.split)
    return got.numpy(), np.asarray(want.numpy())


@pytest.mark.parametrize("sy", SPLITS)
@pytest.mark.parametrize("sx", SPLITS)
@pytest.mark.parametrize("name", list(FUNCS))
def test_pairwise_matches_reference(name, sx, sy):
    g, w = run(name, X, Y, sx, sy)
    atol = 1e-5 * float(np.abs(w).max()) if name in EXPANSION else 1e-6
    np.testing.assert_allclose(g, w, rtol=1e-5, atol=atol)


@pytest.mark.parametrize("sx", SPLITS)
@pytest.mark.parametrize("name", ["cdist", "manhattan", "rbf"])
def test_pairwise_of_x_with_itself_matches_reference(name, sx):
    g, w = run(name, X, None, sx, None)
    np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
    assert np.all(np.diag(g) == (1.0 if name == "rbf" else 0.0))


@pytest.mark.parametrize("name", ["cdist", "manhattan"])
def test_pairwise_of_integers_matches_reference(name):
    g, w = run(name, IX, IY, 0, None)
    np.testing.assert_allclose(g, w, rtol=1e-6, atol=0)


def test_direct_form_builds_no_difference_tensor():
    """The direct form is ``torch.cdist`` without the GEMM: its result is
    the float64 distance to float32 rounding, also where two rows nearly
    coincide (where the expansion cancels)."""
    x = torch.from_numpy(X)
    y = x + 1e-4
    got = htt.spatial.cdist(htt.array(x.numpy()), htt.array(y.numpy())).numpy()
    want = np.sqrt(((X[:, None, :].astype(np.float64) - y.numpy()[None].astype(np.float64)) ** 2).sum(-1))
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_expansion_runs_in_full_float32_and_restores_the_callers_precision():
    flags = torch.backends.cuda.matmul
    old = flags.fp32_precision
    flags.fp32_precision = "tf32"
    try:
        g = htt.spatial.cdist(htt.array(X, split=0), htt.array(Y), quadratic_expansion=True).numpy()
        assert flags.fp32_precision == "tf32"
    finally:
        flags.fp32_precision = old
    want = np.sqrt(((X[:, None, :].astype(np.float64) - Y[None].astype(np.float64)) ** 2).sum(-1))
    np.testing.assert_allclose(g, want, rtol=1e-5, atol=1e-5 * want.max())


def test_pairwise_validates_its_operands():
    with pytest.raises(ValueError):
        htt.spatial.cdist(htt.array(X), htt.array(Y[:, :4]))
    with pytest.raises(ValueError):
        htt.spatial.cdist(htt.array(X[0]))
    with pytest.raises(TypeError):
        htt.spatial.cdist(X)
