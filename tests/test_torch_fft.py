"""heat_tpu_torch.fft against heat_tpu.fft.

All 22 public functions, at world size 1 on the CPU, on the same numpy
inputs as the reference, for splits None, 0, 1 and 2, with
``n``/``s``/``axes``/``norm``.  Values within 1e-5 of the largest entry
(pocketfft and XLA's FFT sum in other orders), dtype and shape exactly
against the reference's transform of the replicated input (XLA aborts the
process on some of its sharded Hermitian transforms, e.g. ``hfft2`` of an
array split along a transformed axis it cannot move), and the split by the
reference's rule: the input's (``_wrap(res, x.split)``), None past the
result's dimensions.  Dtypes are the reference's: complex64 from float32 and
int32, float32 from the inverse real transforms.
"""

import warnings

import numpy as np
import pytest

import heat_tpu
import heat_tpu_torch as htt

TOL = 1e-5
RNG = np.random.default_rng(41)
R = RNG.standard_normal((6, 8, 5)).astype(np.float32)
C = (RNG.standard_normal((6, 8, 5)) + 1j * RNG.standard_normal((6, 8, 5))).astype(np.complex64)
I = RNG.integers(-9, 10, (6, 8)).astype(np.int32)


@pytest.fixture(autouse=True)
def on_cpu():
    prev = htt.get_device()
    htt.use_device("cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        yield
    htt.use_device(prev)


def hold(got, want, split):
    w = want.numpy()
    g = got.numpy()
    assert got.shape == want.shape
    assert got.dtype.__name__ == want.dtype.__name__, (got.dtype, want.dtype)
    assert got.split == (split if split is not None and split < len(want.shape) else None)
    scale = max(float(np.abs(w).max()), 1e-30)
    np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL * scale)


ONE_D = ["fft", "ifft", "rfft", "irfft", "hfft", "ihfft"]
N_D = ["fft2", "ifft2", "rfft2", "irfft2", "hfft2", "ihfft2", "fftn", "ifftn", "rfftn", "irfftn", "hfftn", "ihfftn"]
REAL_IN = {"rfft", "ihfft", "rfft2", "ihfft2", "rfftn", "ihfftn"}


def _input(name):
    return R if name in REAL_IN else C


@pytest.mark.parametrize("split", [None, 0, 1, 2])
@pytest.mark.parametrize("name", ONE_D)
@pytest.mark.parametrize("kw", [{}, {"axis": 0}, {"n": 6, "norm": "ortho"}, {"axis": 1, "n": 11, "norm": "forward"}])
def test_one_dimensional_transforms(name, split, kw):
    a = _input(name)
    got = getattr(htt.fft, name)(htt.array(a, split=split), **kw)
    want = getattr(heat_tpu.fft, name)(heat_tpu.array(a), **kw)
    hold(got, want, split)


@pytest.mark.parametrize("split", [None, 0, 1, 2])
@pytest.mark.parametrize("name", N_D)
@pytest.mark.parametrize("kw", [{}, {"axes": (0, 2)}, {"s": (4, 6), "norm": "ortho"}])
def test_n_dimensional_transforms(name, split, kw):
    a = _input(name)
    if name.endswith("2") and "axes" in kw:
        kw = {"axes": (0, 2)}
    got = getattr(htt.fft, name)(htt.array(a, split=split), **kw)
    want = getattr(heat_tpu.fft, name)(heat_tpu.array(a), **kw)
    hold(got, want, split)


@pytest.mark.parametrize("split", [None, 0, 1])
@pytest.mark.parametrize("name", ["fft", "rfft", "fft2", "rfftn"])
def test_integer_input_takes_complex64(name, split):
    got = getattr(htt.fft, name)(htt.array(I, split=split))
    want = getattr(heat_tpu.fft, name)(heat_tpu.array(I))
    hold(got, want, split)


@pytest.mark.parametrize("split", [None, 0])
@pytest.mark.parametrize("name", ["fftfreq", "rfftfreq"])
@pytest.mark.parametrize("n,d", [(8, 1.0), (11, 0.25)])
def test_frequencies(name, split, n, d):
    got = getattr(htt.fft, name)(n, d=d, split=split)
    want = getattr(heat_tpu.fft, name)(n, d=d, split=split)
    hold(got, want, split)


@pytest.mark.parametrize("split", [None, 0, 1, 2])
@pytest.mark.parametrize("name", ["fftshift", "ifftshift"])
@pytest.mark.parametrize("axes", [None, 0, (1, 2)])
def test_shifts(name, split, axes):
    got = getattr(htt.fft, name)(htt.array(R, split=split), axes=axes)
    want = getattr(heat_tpu.fft, name)(heat_tpu.array(R, split=split), axes=axes)
    hold(got, want, split)


def test_round_trip_and_duplicate_axes():
    x = htt.array(R, split=0)
    back = htt.fft.irfftn(htt.fft.rfftn(x), s=R.shape)
    np.testing.assert_allclose(back.numpy(), R, atol=1e-5)
    with pytest.raises(ValueError, match="unique"):
        htt.fft.hfft2(htt.array(C[0, 0]))
