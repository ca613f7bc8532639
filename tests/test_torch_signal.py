"""heat_tpu_torch's ``convolve``, ``convolve2d`` and ``correlate`` against
heat_tpu, and the halo exchange at world size 1.

At world size 1 on the CPU, on the same numpy inputs as the reference on
its 8-device CPU mesh (where its split signals take its halo route).
Float32 values within 1e-5 of the largest entry (another order of the same
float32 sums); integer results exactly (the port's exact float64 route;
the reference's float32 one is exact at these sizes); dtype, shape and
split exactly.  The result's split follows the signal, also where the
operands swap.  An integer convolution that could pass 2^53 raises.
"""

import warnings

import numpy as np
import pytest
import torch

import heat_tpu
import heat_tpu_torch as htt

TOL = 1e-5
RNG = np.random.default_rng(23)
A = RNG.standard_normal(40).astype(np.float32)
V = RNG.standard_normal(7).astype(np.float32)
V4 = RNG.standard_normal(4).astype(np.float32)
AI = RNG.integers(-50, 50, 40).astype(np.int32)
VI = RNG.integers(-5, 5, 6).astype(np.int32)
M = RNG.standard_normal((13, 11)).astype(np.float32)
K = RNG.standard_normal((3, 4)).astype(np.float32)
MI = RNG.integers(-9, 9, (13, 11)).astype(np.int32)
KI = RNG.integers(-3, 3, (3, 2)).astype(np.int32)
AC = (RNG.standard_normal(20) + 1j * RNG.standard_normal(20)).astype(np.complex64)
VC = (RNG.standard_normal(5) + 1j * RNG.standard_normal(5)).astype(np.complex64)


@pytest.fixture(autouse=True)
def on_cpu():
    prev = htt.get_device()
    htt.use_device("cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        yield
    htt.use_device(prev)


def hold(got, want, exact=False):
    w, g = want.numpy(), got.numpy()
    assert got.shape == want.shape
    assert got.dtype.__name__ == want.dtype.__name__, (got.dtype, want.dtype)
    assert got.split == want.split
    if exact:
        np.testing.assert_array_equal(g, w)
    else:
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL * scale)


@pytest.mark.parametrize("mode", ["full", "same", "valid"])
@pytest.mark.parametrize("sa", [None, 0])
@pytest.mark.parametrize("sv", [None, 0])
@pytest.mark.parametrize("a,v", [(A, V), (A, V4), (AI, VI), (A, VI), (AC, VC)], ids=["f", "f_even", "i", "fi", "c"])
def test_convolve(a, v, mode, sa, sv):
    got = htt.convolve(htt.array(a, split=sa), htt.array(v, split=sv), mode=mode)
    want = heat_tpu.convolve(heat_tpu.array(a, split=sa), heat_tpu.array(v, split=sv), mode=mode)
    hold(got, want, exact=a.dtype == np.int32 and v.dtype == np.int32)
    np.testing.assert_allclose(got.numpy(), np.convolve(a, v, mode=mode), rtol=1e-4, atol=1e-4 * np.abs(a).max())


@pytest.mark.parametrize("mode", ["full", "same", "valid"])
@pytest.mark.parametrize("sa", [None, 0])
def test_operands_swap_and_the_result_follows_the_signal(mode, sa):
    got = htt.convolve(htt.array(V, split=sa), htt.array(A), mode=mode)
    want = heat_tpu.convolve(heat_tpu.array(V, split=sa), heat_tpu.array(A), mode=mode)
    hold(got, want)


@pytest.mark.parametrize("mode", ["full", "same", "valid"])
@pytest.mark.parametrize("sa", [None, 0])
@pytest.mark.parametrize("a,v", [(A, V), (AI, VI), (AC, VC)], ids=["f", "i", "c"])
def test_correlate(a, v, mode, sa):
    got = htt.correlate(htt.array(a, split=sa), htt.array(v), mode=mode)
    want = heat_tpu.correlate(heat_tpu.array(a, split=sa), heat_tpu.array(v), mode=mode)
    hold(got, want, exact=a.dtype == np.int32)
    np.testing.assert_allclose(got.numpy(), np.correlate(a, v, mode=mode), rtol=1e-4, atol=1e-4 * np.abs(a).max())


@pytest.mark.parametrize("mode", ["full", "same", "valid"])
@pytest.mark.parametrize("sa", [None, 0, 1])
@pytest.mark.parametrize("a,v", [(M, K), (MI, KI), (M, K[:2, :3])], ids=["f", "i", "f_even"])
def test_convolve2d(a, v, mode, sa):
    got = htt.convolve2d(htt.array(a, split=sa), htt.array(v), mode=mode)
    want = heat_tpu.convolve2d(heat_tpu.array(a, split=sa), heat_tpu.array(v), mode=mode)
    hold(got, want)


def test_integer_convolution_past_its_exact_range_raises():
    big = htt.array(np.full(8, 2**30, dtype=np.int64), dtype=htt.int64)
    with pytest.raises(ValueError, match="2\\^53"):
        htt.convolve(big, htt.array(np.full(3, 2**22, dtype=np.int64), dtype=htt.int64))


def test_bad_arguments_raise():
    with pytest.raises(ValueError):
        htt.convolve(htt.array(M), htt.array(V))
    with pytest.raises(ValueError):
        htt.convolve(htt.array(A), htt.array(V), mode="bad")
    with pytest.raises(NotImplementedError):
        htt.convolve(htt.array(A), htt.array(V), stride=2)


def test_halo_exchange_at_world_size_one_gives_zeros():
    x = htt.array(A, split=0)
    prev, nxt = htt.parallel.halo_exchange(x.larray, 3, x.comm)
    assert torch.equal(prev, torch.zeros(3)) and torch.equal(nxt, torch.zeros(3))
    ext = htt.parallel.with_halos(x, 2)
    np.testing.assert_array_equal(ext.numpy(), np.concatenate([[0, 0], A, [0, 0]]).astype(np.float32))
