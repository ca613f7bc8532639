"""The port's KMeans E-step kernels against heat_tpu's Pallas kernels.

On the CPU the port's wrappers run their plain PyTorch versions; the
reference runs its Pallas kernels in interpret mode on the CPU mesh, as its
own tests do (rows <= 16384).  The same numpy inputs go to both.

Tolerances:
- labels are compared exactly: the rows are Gaussian blobs around the
  centers with no near-ties (checked: every row's top-2 gap in d² exceeds
  1e-5 of the expansion's magnitude, 100x its float32 rounding);
- counts are compared exactly: they are integer sums of equal labels;
- sums use rtol 1e-5, atol 1e-4: both sides add the same float32 rows in a
  different order (one-hot GEMM on each side, float64 carry in the port),
  which differs by a few float32 ulps of sums of at most ~2000 rows;
- min d² uses atol 1e-6 of the expansion's magnitude (|x|² + |c|²): the
  same float32 expansion, with the dot product summed in another order,
  cancels to within a few float32 ulps of that magnitude.
The kernels themselves run only on the card: ``test_torch_cuda_kernels.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from heat_tpu.ops import kmeans_kernels as ref
from heat_tpu_torch.ops import kmeans_kernels as kk

CASES = [  # (rows, d, k, n, dtype)
    (2000, 16, 8, 1987, np.float32),
    (1537, 8, 5, 1537, np.float32),
    (1000, 16, 8, 640, "bfloat16"),
    (2000, 3, 7, 2000, np.float32),
    # the CUDA kernels' edges: one cluster, more clusters than a slab's 64
    # rows hold runs of, d off the 32-column register rows, n past and below the rows
    (1000, 16, 1, 1000, np.float32),
    (1500, 8, 61, 1499, np.float32),
    (1200, 33, 8, 1100, np.float32),
    (900, 100, 8, 900, "bfloat16"),
    (1000, 16, 8, 1500, np.float32),
    (1000, 16, 8, 0, np.float32),
]


def _inputs(rows, d, k, dtype, seed=0):
    rng = np.random.default_rng(seed)
    c = (4.0 * rng.standard_normal((k, d))).astype(np.float32)
    x = (c[rng.integers(0, k, rows)] + 0.7 * rng.standard_normal((rows, d))).astype(np.float32)
    if dtype == "bfloat16":
        xr = jnp.asarray(x, dtype=jnp.bfloat16)
        xt = torch.from_numpy(x).to(torch.bfloat16)
        x = np.asarray(xr.astype(jnp.float32))  # the values both sides see
    else:
        xr, xt = jnp.asarray(x), torch.from_numpy(x)
    return x, c, xr, xt


def _scale(x, c):
    """Magnitude of the terms of the expansion (|x|² + |c|²) - 2x·c: float32
    rounds d² to a few 6e-8 of it."""
    return float((x * x).sum(1).max() + (c * c).sum(1).max())


def _gap_ok(x, c):
    if c.shape[0] < 2:  # one center: no tie to break
        return True
    d2 = ((x[:, None, :] - c[None, :, :]) ** 2).sum(-1)
    two = np.sort(d2, axis=1)[:, :2]
    return (two[:, 1] - two[:, 0]).min() > 1e-5 * _scale(x, c)


@pytest.mark.parametrize("rows,d,k,n,dtype", CASES)
def test_assign_matches_reference_kernel(rows, d, k, n, dtype):
    x, c, xr, xt = _inputs(rows, d, k, dtype)
    assert _gap_ok(x, c)
    lab_r, d2_r = ref.fused_assign(xr, jnp.asarray(c))
    before = dict(kk.launch_counts)
    lab, d2 = kk.fused_assign(xt, torch.from_numpy(c))
    assert kk.launch_counts == before  # a CPU tensor never launches a kernel
    assert lab.dtype == torch.int32 and d2.dtype == torch.float32 and lab.shape == (rows,)
    np.testing.assert_array_equal(lab.numpy(), np.asarray(lab_r))
    np.testing.assert_allclose(d2.numpy(), np.asarray(d2_r), rtol=0, atol=1e-6 * _scale(x, c))


@pytest.mark.parametrize("rows,d,k,n,dtype", CASES)
def test_em_stats_matches_reference_kernel(rows, d, k, n, dtype):
    x, c, xr, xt = _inputs(rows, d, k, dtype, seed=1)
    assert _gap_ok(x, c)
    s_r, cnt_r = ref.fused_em_stats(xr, jnp.asarray(c), n)
    s, cnt = kk.fused_em_stats(xt, torch.from_numpy(c), n)
    assert s.shape == (k, d) and cnt.shape == (k,)
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(cnt_r))
    assert cnt.sum() == min(n, rows)  # rows at index >= n (pad) contribute nothing
    np.testing.assert_allclose(s.numpy(), np.asarray(s_r), rtol=1e-5, atol=1e-4)


def test_em_stats_defaults_and_bounds():
    x, c, _, xt = _inputs(300, 4, 3, np.float32, seed=2)
    ct = torch.from_numpy(c)
    s_all, cnt_all = kk.fused_em_stats(xt, ct)
    assert float(cnt_all.sum()) == 300
    _, cnt0 = kk.fused_em_stats(xt, ct, 0)
    assert float(cnt0.sum()) == 0
    _, cnt_big = kk.fused_em_stats(xt, ct, 10_000)  # n past the rows: all rows
    np.testing.assert_array_equal(cnt_big.numpy(), cnt_all.numpy())
    lab, _ = kk.fused_assign(xt, ct)
    np.testing.assert_array_equal(cnt_all.numpy(), np.bincount(lab.numpy(), minlength=3))


def test_clamp_comes_before_argmin():
    # two identical centers and a row on them: d² rounds below 0 for both,
    # the clamp makes them equal, and the lowest index wins
    c = torch.tensor([[1e3, 1e3], [1e3, 1e3], [0.0, 0.0]])
    x = torch.tensor([[1e3, 1e3 + 1e-3]])
    lab, d2 = kk.fused_assign(x, c)
    assert int(lab[0]) == 0 and float(d2[0]) >= 0.0


@pytest.mark.parametrize(
    "x,c,exc",
    [
        (torch.zeros(4, 3, dtype=torch.float64), torch.zeros(2, 3), TypeError),
        (torch.zeros(4, 3), torch.zeros(2, 3, dtype=torch.float64), TypeError),
        (torch.zeros(4, 3), torch.zeros(2, 4), ValueError),
        (torch.zeros(4), torch.zeros(2, 4), ValueError),
        (torch.zeros(4, 3), torch.zeros(0, 3), ValueError),
        (torch.zeros(3, 4).T, torch.zeros(2, 3), ValueError),
        (np.zeros((4, 3), np.float32), torch.zeros(2, 3), TypeError),
    ],
)
def test_wrapper_argument_checks(x, c, exc):
    with pytest.raises(exc):
        kk.fused_assign(x, c)
    with pytest.raises(exc):
        kk.fused_em_stats(x, c)


@pytest.mark.parametrize("clamp_first", [True, False])
def test_sq_dist_blocks_cover_the_rows_in_blocks(clamp_first, monkeypatch):
    x, c, _, xt = _inputs(1000, 8, 5, np.float32, seed=4)
    ct = torch.from_numpy(c)
    whole = list(kk.sq_dist_blocks(xt, ct, clamp_first, stop=900))
    monkeypatch.setattr(kk, "BLOCK", 128)
    parts = list(kk.sq_dist_blocks(xt, ct, clamp_first, stop=900))
    assert len(whole) == 1 and [p[0] for p in parts] == list(range(0, 900, 128))
    assert torch.equal(torch.cat([p[1] for p in parts]), xt[:900])
    lab, d2 = torch.cat([p[3] for p in parts]), torch.cat([p[2] for p in parts])
    assert bool((d2 >= 0).all())
    assert torch.equal(lab, whole[0][3])
    torch.testing.assert_close(d2, whole[0][2], rtol=0, atol=1e-6 * _scale(x, c))
    direct = ((x[:900, None, :] - c[None, :, :]) ** 2).sum(-1)  # no near ties: checked by _gap_ok
    assert _gap_ok(x[:900], c)
    np.testing.assert_array_equal(lab.numpy(), direct.argmin(1))
