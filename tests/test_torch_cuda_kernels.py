"""heat_tpu_torch's CUDA kernels against their plain PyTorch versions, on a card.

Every test here needs an NVIDIA GPU (``cuda`` marker) and skips without one.
The file imports neither JAX nor heat_tpu, so a card's machine without them
runs it as it stands, without the repository's conftest (which sets JAX up):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_kernels.py

Tolerances:
- KMeans: labels exactly and counts exactly (no near ties in these blobs);
  min d² to 1e-6 of the expansion's magnitude (|x|² + |c|²) and sums to
  rtol 1e-5, atol 1e-4: the same float32 terms summed in another order.
- flash attention, by ``row_err`` (each row's largest error over that row's
  largest value):
  - float32: 2e-5 on out, 2e-4 on dq, dk, dv; lse atol 2e-5.  The kernel
    and the plain version take P at the same running maximum over 64-key
    tiles and differ by float32 sum order only: a few ulps of each term
    over up to 1000 keys.  Row 0 of a causal dq cancels to 0 and keeps the
    float32 rounding of dp - dd, ~1e-6 at d = 64, ~1e-4 of the row floor.
  - bfloat16: 2^-6.  The result rounds to bfloat16, whose step is at most
    2^-7 of a value; where the two sides' float32 scores differ in the last
    bits, one P or dS may round one step apart too.  And at most 1% of the
    elements may differ at all: P and dS round at the same points on both
    sides, so only float32 sum order moves a result across a rounding
    boundary (~1e-4 of them); rounding P at another maximum moves 5-24%.
"""

import numpy as np
import pytest
import torch

import heat_tpu_torch as htt
from heat_tpu_torch.ops import flash_attention as fa
from heat_tpu_torch.ops import kmeans_kernels as kk

ROW_FLOOR = 2.0**-7
FLASH_TOL = {torch.float32: {"out": 2e-5, "grad": 2e-4}, torch.bfloat16: {"out": 2.0**-6, "grad": 2.0**-6}}

pytestmark = pytest.mark.cuda


def row_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max over rows of max |got - want| / max |want| along the last axis.

    A row's scale is floored at ROW_FLOOR of the tensor's largest |want|, or
    of 1 if that is larger (the inputs here are of unit scale): a row that
    cancels to ~0 (row 0 of a causal dq: one key, dS = p(dp - dd) with
    dd = dp; every row at S = 1) keeps the float32 rounding of its terms,
    which are of the tensor's or the inputs' scale, not of the row's."""
    got, want = got.float().flatten(0, -2), want.float().flatten(0, -2)
    if not want.numel():
        return 0.0
    scale = want.abs().amax(-1).clamp_min(ROW_FLOOR * max(float(want.abs().max()), 1.0))
    return float(((got - want).abs().amax(-1) / scale).max())


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")


def _blobs(rows, d, k, seed):
    rng = np.random.default_rng(seed)
    c = (4.0 * rng.standard_normal((k, d))).astype(np.float32)
    x = (c[rng.integers(0, k, rows)] + 0.7 * rng.standard_normal((rows, d))).astype(np.float32)
    return x, c


def test_cuda_kmeans_kernels_match_plain_versions():
    x, c = _blobs(5003, 32, 64, seed=3)
    scale = float((x * x).sum(1).max() + (c * c).sum(1).max())
    xt, ct = torch.from_numpy(x).cuda(), torch.from_numpy(c).cuda()
    before = dict(kk.launch_counts)
    lab, d2 = kk.fused_assign(xt, ct)
    s, cnt = kk.fused_em_stats(xt, ct, 4999)
    assert kk.launch_counts["assign"] == before["assign"] + 1
    assert kk.launch_counts["em_stats"] == before["em_stats"] + 1
    lab_p, d2_p = kk._torch_assign(xt, ct)
    s_p, cnt_p = kk._torch_em_stats(xt, ct, 4999)
    torch.testing.assert_close(lab, lab_p)
    torch.testing.assert_close(d2, d2_p, rtol=0, atol=1e-6 * scale)
    torch.testing.assert_close(cnt, cnt_p, rtol=0, atol=0)
    torch.testing.assert_close(s, s_p, rtol=1e-5, atol=1e-4)
    with pytest.raises(TypeError):
        kk.fused_assign(xt.double(), ct)
    with pytest.raises(ValueError):
        kk.fused_assign(xt, ct.cpu())
    with pytest.raises(ValueError):
        kk.fused_assign(torch.zeros(8, 200, device="cuda"), torch.zeros(2, 200, device="cuda"))


def test_auto_on_cuda_raises_past_the_kernels_limits():
    X = np.random.default_rng(0).standard_normal((4096, 32)).astype(np.float32)
    x = htt.array(X, split=0, device="gpu")
    km = htt.cluster.KMeans(n_clusters=2048, init=X[:2048], max_iter=1)
    assert km._use_kernel(x)  # 'auto' on a CUDA tensor: the kernels, never the torch path
    with pytest.raises(RuntimeError, match="shared-memory"):
        km.fit(x)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,d,causal", [(1000, 64, True), (129, 128, False), (64, 8, True)])
def test_cuda_flash_kernels_match_plain_versions(S, d, causal, dtype):
    g = torch.Generator(device="cuda").manual_seed(S + d)
    q, k, v, do = (torch.randn((6, S, d), generator=g, device="cuda").to(dtype) for _ in range(4))
    before = dict(fa.launch_counts)
    out, lse = fa.flash_fwd(q, k, v, causal, d**-0.5)
    dd = (do.float() * out.float()).sum(-1)
    dq = fa.flash_bwd_dq(q, k, v, do, lse, dd, causal, d**-0.5)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, dd, causal, d**-0.5)
    torch.cuda.synchronize()
    assert {key: fa.launch_counts[key] - before[key] for key in before} == {
        "flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}
    out_p, lse_p = fa._torch_flash_fwd(q, k, v, causal, d**-0.5)
    dq_p = fa._torch_flash_bwd_dq(q, k, v, do, lse, dd, causal, d**-0.5)
    dk_p, dv_p = fa._torch_flash_bwd_dkv(q, k, v, do, lse, dd, causal, d**-0.5)
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(lse, lse_p, atol=2e-5, rtol=2e-5)
    for got, want, kind in ((out, out_p, "out"), (dq, dq_p, "grad"), (dk, dk_p, "grad"), (dv, dv_p, "grad")):
        assert row_err(got, want) <= tol[kind]
        if dtype == torch.bfloat16:
            assert float((got != want).float().mean()) <= 0.01
    again, _ = fa.flash_fwd(q, k, v, causal, d**-0.5)
    assert torch.equal(out, again)  # no atomics: the same bits every run


def test_cuda_flash_kernels_refuse_d_256():
    q = torch.zeros((2, 16, 256), device="cuda")
    with pytest.raises(ValueError):
        fa.flash_fwd(q, q, q, True, 1.0)
    with pytest.raises(ValueError):
        fa.flash_attention(q, q, q)
