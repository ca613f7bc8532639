"""heat_tpu_torch's CUDA kernels against their plain PyTorch versions, on a card.

Every test here needs an NVIDIA GPU (``cuda`` marker) and skips without one.
The file imports neither JAX nor heat_tpu, so a card's machine without them
runs it as it stands, without the repository's conftest (which sets JAX up):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_kernels.py

Tolerances:
- KMeans: labels exactly and counts exactly (no near ties in these blobs);
  min d² to 1e-6 of the expansion's magnitude (|x|² + |c|²) and sums to
  rtol 1e-5, atol 1e-4: the same float32 terms summed in another order.
  assign and em_stats at their edges (chip_smoke.py's EM_EDGE_CHECKS and
  check_em_edges): assign's d2 within D2_RTOL (1e-5) of |x|^2 + |c|^2 and a
  label apart from the plain version's only at a near tie (TIE_RTOL);
  em_stats' counts exactly those of assign's labels, sums within SUM_RTOL
  (1e-5) of their magnitude from a float64 scatter of those labels, against
  the plain version within its near-tie allowance; both the same bits twice.
  The products are split TF32 on the tensor cores (wgmma, or mma.sync past
  the k that wgmma's centres fit), about 2^-21 of |x||c|.
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
  - the grouped-query kernels take the same limits: their plain versions
    repeat K/V per group and run the multi-head ones, and dk, dv sum the
    group in float32 on both sides before the one rounding.
  - the positions kernels (ring attention's block) take the same limits:
    the same bodies and rounding points under another mask; a block wholly
    after its queries gives out 0 and lse -1e30 exactly.
  - past d = 256 the wide route (``csrc/flash_wide.cuh``,
    ``csrc/flash_wide_bwd.cuh``) takes the same limits at d = 257 to 2048
    (``WIDE_DIMS``), and each of its kernels repeats bit for bit, but for the bfloat16
    differing share, which grows with d (chip_smoke.py's
    bf16_share_limit, 1% x sqrt(d / 256), derives it: the tensor cores add
    a score's d products in 16-term groups, the plain version in one float32
    chain).
  - the bfloat16 forward (the tensor-core body, ``csrc/flash_fwd_tc.cuh``)
    and the float32 forward (the CUDA-core body, ``csrc/flash_f32.cuh``)
    take the same limits at every d they take (8, 33, 100 padded into
    64- and 128-column tiles), S around the 64-key and 128-row tiles,
    multi-head and grouped 4:1 and 8:1, and the ring's blocks; the output
    repeats bit for bit, and q or v off 16-byte alignment (loaded element
    by element into the same shared tiles) gives the same bits.
  - the float32 dq and dk/dv (the CUDA-core bodies,
    ``csrc/flash_f32.cuh``) take the float32 limits over the same
    shapes, but below 129 rows, where whole rows of dq and dk cancel to
    float32 noise (below): there rows reaching the row floor take the row
    error and rows below it chip_smoke.py's EDGE_F32_ATOL (_edge_err).
  - the bfloat16 dq and dk/dv (the tensor-core bodies,
    ``csrc/flash_bwd_tc.cuh``) take the same limits over the forward's
    shapes, but for the differing share: whole rows of dq and dk can cancel
    to float32 noise (at S = 1 every row: P = 1, O = V, dP - dd = 0 but for
    rounding; row 0 of a causal dq at any S), whose bits follow the order
    of the sums, so here the share counts the elements whose plain value
    reaches the row floor, and the row error holds the rest.  (The tests
    above keep the share of all elements at their shapes.)  dq and dk/dv
    repeat bit for bit, and with dO off 16-byte alignment give the same
    bits; a dead positions block gives exact zeros.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import heat_tpu_torch as htt
from heat_tpu_torch.ops import flash_attention as fa
from heat_tpu_torch.ops import kmeans_kernels as kk

ROW_FLOOR = 2.0**-7
FLASH_TOL = {torch.float32: {"out": 2e-5, "grad": 2e-4}, torch.bfloat16: {"out": 2.0**-6, "grad": 2.0**-6}}

pytestmark = pytest.mark.cuda

# chip_smoke.py (imports neither JAX nor heat_tpu) holds the edge shapes'
# share of differing elements above the row floor, _share_above_floor
_SPEC = importlib.util.spec_from_file_location("chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
_CHIP_SMOKE = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(_CHIP_SMOKE)


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
    # d past the tiles takes the streamed route (it raised before R6)
    lab200, d2_200 = kk.fused_assign(torch.zeros(8, 200, device="cuda"), torch.zeros(2, 200, device="cuda"))
    assert lab200.tolist() == [0] * 8 and d2_200.abs().max().item() == 0.0
    assert kk.launch_config(2, 200)["route"] == "streamed"


def test_auto_on_cuda_raises_past_the_kernels_limits():
    """Past the kernels' old limits (k = 2048 at d = 32 raised a
    shared-memory error before R6) 'auto' on a CUDA tensor still takes the
    kernels, now their streamed route, and fits as the torch path does.
    The name is the one the test had while it checked the refusal."""
    X = np.random.default_rng(0).standard_normal((4096, 32)).astype(np.float32)
    x = htt.array(X, split=0, device="gpu")
    km = htt.cluster.KMeans(n_clusters=2048, init=X[:2048], max_iter=1)
    assert km._use_kernel(x)  # 'auto' on a CUDA tensor: the kernels, never the torch path
    assert kk.launch_config(2048, 32, em=True)["route"] == "streamed"
    before = dict(kk.launch_counts)
    km.fit(x)
    assert kk.launch_counts["em_stats"] > before["em_stats"]
    lab, d2 = kk.fused_assign(x.larray, km._centers)
    lab_p, d2_p = kk._torch_assign(x.larray, km._centers)
    _CHIP_SMOKE.compare_assign(x.larray, km._centers, lab, d2, lab_p, d2_p)  # labels apart only at near ties


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
        "flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1, "flash_gqa_fwd": 0, "flash_gqa_bwd_dq": 0,
        "flash_gqa_bwd_dkv": 0, "flash_pos_fwd": 0, "flash_pos_bwd_dq": 0, "flash_pos_bwd_dkv": 0}
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,hk", [(8, 2), (8, 1)])
@pytest.mark.parametrize("S,d,causal", [(1000, 64, True), (129, 128, False), (77, 8, False)])
def test_cuda_gqa_flash_kernels_match_plain_versions(S, d, causal, hq, hk, dtype):
    """The grouped kernels against their plain versions over K/V repeated
    per group, with the tolerances of the multi-head kernels: dk and dv sum
    the group in float32 on both sides and round once."""
    g = torch.Generator(device="cuda").manual_seed(S + d + hq + hk)
    B = 2
    q, do = (torch.randn((B * hq, S, d), generator=g, device="cuda").to(dtype) for _ in range(2))
    k, v = (torch.randn((B * hk, S, d), generator=g, device="cuda").to(dtype) for _ in range(2))
    before = dict(fa.launch_counts)
    out, lse = fa.flash_gqa_fwd(q, k, v, causal, d**-0.5)
    dd = (do.float() * out.float()).sum(-1)
    dq = fa.flash_gqa_bwd_dq(q, k, v, do, lse, dd, causal, d**-0.5)
    dk, dv = fa.flash_gqa_bwd_dkv(q, k, v, do, lse, dd, causal, d**-0.5)
    torch.cuda.synchronize()
    assert {key: fa.launch_counts[key] - before[key] for key in before} == {
        "flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0, "flash_gqa_fwd": 1, "flash_gqa_bwd_dq": 1,
        "flash_gqa_bwd_dkv": 1, "flash_pos_fwd": 0, "flash_pos_bwd_dq": 0, "flash_pos_bwd_dkv": 0}
    assert dk.shape == k.shape and dv.shape == v.shape
    out_p, lse_p = fa._torch_flash_gqa_fwd(q, k, v, causal, d**-0.5)
    dq_p = fa._torch_flash_gqa_bwd_dq(q, k, v, do, lse, dd, causal, d**-0.5)
    dk_p, dv_p = fa._torch_flash_gqa_bwd_dkv(q, k, v, do, lse, dd, causal, d**-0.5)
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(lse, lse_p, atol=2e-5, rtol=2e-5)
    for got, want, kind in ((out, out_p, "out"), (dq, dq_p, "grad"), (dk, dk_p, "grad"), (dv, dv_p, "grad")):
        assert row_err(got, want) <= tol[kind]
        if dtype == torch.bfloat16:
            assert float((got != want).float().mean()) <= 0.01
    again, _ = fa.flash_gqa_fwd(q, k, v, causal, d**-0.5)
    dk2, dv2 = fa.flash_gqa_bwd_dkv(q, k, v, do, lse, dd, causal, d**-0.5)
    assert torch.equal(out, again) and torch.equal(dk, dk2) and torch.equal(dv, dv2)  # no atomics
    three = k.repeat(2, 1, 1)[:3]
    with pytest.raises(ValueError):  # K/V rows that do not divide the query rows
        fa.flash_gqa_fwd(q, three, three, causal, d**-0.5)
    with pytest.raises(ValueError):  # the multi-head wrapper takes one shape only
        fa.flash_fwd(q, k, v, causal, d**-0.5)


def test_cuda_flash_kernels_refuse_d_256():
    """Past d = 256, where the kernels once refused a head dim (R5b), every
    wrapper now launches the wide route: d = 257 through the multi-head,
    grouped and positions wrappers launches one kernel each, on the route
    the C dispatch reports as the wide one; d = 256 stays on the D = 256
    bodies, d = 128 on the tiled ones, and d = 0 raises."""
    assert [fa.route(d) for d in (1, 128, 129, 256, 257, 4096)] == ["tiled", "tiled", "d256", "d256", "wide", "wide"]
    with pytest.raises(ValueError, match="d >= 1"):
        fa.route(0)
    q = torch.randn((2, 16, 257), device="cuda")
    before = dict(fa.launch_counts)
    out, _ = fa.flash_fwd(q, q, q, True, 1.0)
    y = fa.flash_attention(q, q, q)
    yg = fa.flash_attention_gqa(q.view(1, 2, 16, 257), q[:1].view(1, 1, 16, 257), q[:1].view(1, 1, 16, 257))
    pos = torch.arange(16, dtype=torch.int32, device="cuda")
    op, _ = fa.flash_pos_fwd(q, q, q, pos, pos, True, 1.0, 16, True)
    torch.cuda.synchronize()
    assert out.shape == y.shape == op.shape == (2, 16, 257) and yg.shape == (1, 2, 16, 257)
    grew = {key: fa.launch_counts[key] - before[key] for key in before}
    assert grew == {key: 2 if key == "flash_fwd" else int(key in ("flash_gqa_fwd", "flash_pos_fwd")) for key in grew}
    t = q[..., :256].contiguous()
    out, _ = fa.flash_fwd(t, t, t, True, 1.0)
    assert out.shape == (2, 16, 256)
    with pytest.raises(ValueError, match="d >= 1"):
        fa.flash_fwd(q[..., :0], q[..., :0], q[..., :0], True, 1.0)


# the wide route's shapes: (query rows, K/V rows, S, causal) at each d it is
# held at: where the backward's split of d changes (chunks of 64 columns, 128
# for bfloat16 dq; clusters of up to 8 blocks, then passes), and past them
WIDE_DIMS = [257, 320, 384, 385, 512, 1024, 1025, 1126, 2048]
WIDE_SHAPES = [(4, 4, 200, True), (4, 2, 129, False), (8, 2, 200, True), (2, 2, 64, True)]


def _wide_share_ok(got, want, d, grad: bool) -> bool:
    """bfloat16's share of differing elements past d = 256, held to
    chip_smoke.py's bf16_share_limit (whose note derives it); a gradient's
    counts the elements above the row floor, as ``_assert_backward``'s at
    d <= 256 (rows of dq and dk that cancel to float32 noise, row 0 of a
    causal dq, are held by the row error)."""
    share = _CHIP_SMOKE._share_above_floor(got, want) if grad else float((got != want).float().mean())
    return share <= _CHIP_SMOKE.bf16_share_limit(d)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", WIDE_SHAPES, ids=lambda s: "-".join(map(str, s)))
@pytest.mark.parametrize("d", WIDE_DIMS)
def test_cuda_wide_kernels_match_plain_versions(d, shape, dtype):
    """The wide route's forward, dq and dk/dv (multi-head where the K/V rows
    equal the query rows, grouped otherwise) against their plain versions
    (float32 gradients: the plain formulas in float64), with the d <= 256
    tolerances (the differing share: the wide one); the
    same bits twice; one launch a kernel, on the route the C dispatch
    reports as the wide one."""
    bhq, bhk, S, causal = shape
    g = torch.Generator(device="cuda").manual_seed(S + d + bhk)
    q, do = (torch.randn((bhq, S, d), generator=g, device="cuda").to(dtype) for _ in range(2))
    k, v = (torch.randn((bhk, S, d), generator=g, device="cuda").to(dtype) for _ in range(2))
    kind = "flash_" if bhq == bhk else "flash_gqa_"
    fwd, bwd_dq, bwd_dkv = (getattr(fa, kind + n) for n in ("fwd", "bwd_dq", "bwd_dkv"))
    plain = [getattr(fa, "_torch_" + kind + n) for n in ("fwd", "bwd_dq", "bwd_dkv")]
    before = dict(fa.launch_counts)
    out, lse = fwd(q, k, v, causal, d**-0.5)
    dd = (do.float() * out.float()).sum(-1)
    dq = bwd_dq(q, k, v, do, lse, dd, causal, d**-0.5)
    dk, dv = bwd_dkv(q, k, v, do, lse, dd, causal, d**-0.5)
    torch.cuda.synchronize()
    assert fa.route(d) == "wide"
    assert {key: fa.launch_counts[key] - before[key] for key in before} == {
        key: int(key in (kind + "fwd", kind + "bwd_dq", kind + "bwd_dkv")) for key in before}
    out_p, lse_p = plain[0](q, k, v, causal, d**-0.5)
    dq_p = plain[1](q, k, v, do, lse, dd, causal, d**-0.5)
    dk_p, dv_p = plain[2](q, k, v, do, lse, dd, causal, d**-0.5)
    if dtype == torch.float32:  # the plain formulas in float64, as chip_smoke.py holds them
        dq_p, dk_p, dv_p = _CHIP_SMOKE.wide_bwd_f64(q, k, v, do, lse, dd, d**-0.5,
                                                    _CHIP_SMOKE.causal_keep(S, causal, q.device))
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(lse, lse_p, atol=2e-5, rtol=2e-5)
    for got, want, key in ((out, out_p, "out"), (dq, dq_p, "grad"), (dk, dk_p, "grad"), (dv, dv_p, "grad")):
        assert row_err(got, want) <= tol[key]
        if dtype == torch.bfloat16:
            assert _wide_share_ok(got, want, d, key == "grad")
    again, _ = fwd(q, k, v, causal, d**-0.5)
    dq2 = bwd_dq(q, k, v, do, lse, dd, causal, d**-0.5)
    dk2, dv2 = bwd_dkv(q, k, v, do, lse, dd, causal, d**-0.5)
    assert torch.equal(out, again) and torch.equal(dq, dq2) and torch.equal(dk, dk2) and torch.equal(dv, dv2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", WIDE_DIMS)
def test_cuda_wide_positions_kernels_match_plain_versions(d, dtype):
    """The wide route under the positions mask: a ragged, rectangular ring
    block with pad keys and a nonzero lse cotangent, and a dead block."""
    g = torch.Generator(device="cuda").manual_seed(d)
    for Sq, Sk, qo, ko, causal, s_valid in ((100, 77, 50, 30, True, 160), (64, 64, 0, 64, True, 128)):
        q, do = (torch.randn((3, Sq, d), generator=g, device="cuda").to(dtype) for _ in range(2))
        k, v = (torch.randn((3, Sk, d), generator=g, device="cuda").to(dtype) for _ in range(2))
        args = (torch.arange(qo, qo + Sq, dtype=torch.int32, device="cuda"),
                torch.arange(ko, ko + Sk, dtype=torch.int32, device="cuda"), causal, d**-0.5, s_valid, True)
        out, lse = fa.flash_pos_fwd(q, k, v, *args)
        dd = (do.float() * out.float()).sum(-1) - torch.randn((3, Sq), generator=g, device="cuda")
        dq = fa.flash_pos_bwd_dq(q, k, v, do, lse, dd, *args)
        dk, dv = fa.flash_pos_bwd_dkv(q, k, v, do, lse, dd, *args)
        out_p, lse_p = fa._torch_flash_pos_fwd(q, k, v, *args)
        dq_p = fa._torch_flash_pos_bwd_dq(q, k, v, do, lse, dd, *args)
        dk_p, dv_p = fa._torch_flash_pos_bwd_dkv(q, k, v, do, lse, dd, *args)
        if dtype == torch.float32:
            dq_p, dk_p, dv_p = _CHIP_SMOKE.wide_bwd_f64(q, k, v, do, lse, dd, d**-0.5,
                                                        _CHIP_SMOKE.pos_keep(*args[:3], s_valid, True))
        tol = FLASH_TOL[dtype]
        torch.testing.assert_close(lse, lse_p, atol=2e-5, rtol=2e-5)
        for got, want, key in ((out, out_p, "out"), (dq, dq_p, "grad"), (dk, dk_p, "grad"), (dv, dv_p, "grad")):
            assert row_err(got, want) <= tol[key]
            if dtype == torch.bfloat16:
                assert _wide_share_ok(got, want, d, key == "grad")
        if qo + Sq <= ko:  # every key after every query
            assert not out.any() and bool((lse == fa.NO_MASS).all()) and not dk.any() and not dv.any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [320, 512, 1025])
def test_cuda_wide_backward_repeats_bit_for_bit(d, dtype):
    """The wide route's dq and dk/dv, whose clusters sum the blocks' partial
    scores in rank order and write each output once: two runs of each
    kernel give the same bits, multi-head, grouped (4 query rows a K/V row)
    and under the positions mask, at a split of one pass (320, 512) and of
    several (1025); and the launcher's split is the one the route reports."""
    g = torch.Generator(device="cuda").manual_seed(d + 1)
    S = 300
    for bhq, bhk in ((4, 4), (8, 2)):
        q, do = (torch.randn((bhq, S, d), generator=g, device="cuda").to(dtype) for _ in range(2))
        k, v = (torch.randn((bhk, S, d), generator=g, device="cuda").to(dtype) for _ in range(2))
        kind = "flash_" if bhq == bhk else "flash_gqa_"
        fwd, bwd_dq, bwd_dkv = (getattr(fa, kind + n) for n in ("fwd", "bwd_dq", "bwd_dkv"))
        out, lse = fwd(q, k, v, True, d**-0.5)
        dd = (do.float() * out.float()).sum(-1)
        runs = [(bwd_dq(q, k, v, do, lse, dd, True, d**-0.5), *bwd_dkv(q, k, v, do, lse, dd, True, d**-0.5))
                for _ in range(2)]
        assert all(torch.equal(a, b) for a, b in zip(*runs))
    q, do = (torch.randn((2, S, d), generator=g, device="cuda").to(dtype) for _ in range(2))
    k, v = (torch.randn((2, 200, d), generator=g, device="cuda").to(dtype) for _ in range(2))
    args = (torch.arange(100, 100 + S, dtype=torch.int32, device="cuda"),
            torch.arange(0, 200, dtype=torch.int32, device="cuda"), True, d**-0.5, 250, True)
    out, lse = fa.flash_pos_fwd(q, k, v, *args)
    dd = (do.float() * out.float()).sum(-1)
    runs = [(fa.flash_pos_bwd_dq(q, k, v, do, lse, dd, *args), *fa.flash_pos_bwd_dkv(q, k, v, do, lse, dd, *args))
            for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    chunk = 128 if dtype == torch.bfloat16 else 64
    for kernel in ("dq", "dkv"):
        plan = fa.wide_plan(d, dtype, kernel)
        chunks = -(-d // chunk)
        assert plan["chunk"] == chunk and plan["cluster"] <= 8 and plan["cluster"] * plan["passes"] >= chunks
        assert plan["plan_products_per_pair"] == 2 * plan["passes"] + (1 if kernel == "dq" else 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [320, 512, 1024, 1126])
def test_cuda_wide_forward_repeats_bit_for_bit(d, dtype):
    """The wide route's forward, whose clusters sum the blocks' partial
    scores in rank order and keep each row's running max and sum in one
    block: two runs give the same out and lse, multi-head, grouped (4 query
    rows a K/V row) and under the positions mask, at a split of one pass
    (320, 512; bfloat16 also 1024) and of several (float32 at 1024, both
    dtypes at 1126); and the launcher's split gives a live tile pair 2
    products at d = 512, n_p + 1 where d takes n_p passes."""
    g = torch.Generator(device="cuda").manual_seed(d + 2)
    S = 300
    for bhq, bhk in ((4, 4), (8, 2)):
        q = torch.randn((bhq, S, d), generator=g, device="cuda").to(dtype)
        k, v = (torch.randn((bhk, S, d), generator=g, device="cuda").to(dtype) for _ in range(2))
        fwd = fa.flash_fwd if bhq == bhk else fa.flash_gqa_fwd
        runs = [fwd(q, k, v, True, d**-0.5) for _ in range(2)]
        assert all(torch.equal(a, b) for a, b in zip(*runs))
    q = torch.randn((2, S, d), generator=g, device="cuda").to(dtype)
    k, v = (torch.randn((2, 200, d), generator=g, device="cuda").to(dtype) for _ in range(2))
    args = (torch.arange(100, 100 + S, dtype=torch.int32, device="cuda"),
            torch.arange(0, 200, dtype=torch.int32, device="cuda"), True, d**-0.5, 250, True)
    runs = [fa.flash_pos_fwd(q, k, v, *args) for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    chunk = 128 if dtype == torch.bfloat16 else 64
    chunks = -(-d // chunk)
    plan = fa.wide_plan(d, dtype, "fwd")
    assert plan["chunk"] == chunk and plan["cluster"] <= 8 and plan["cluster"] * plan["passes"] >= chunks
    assert plan["passes"] == -(-chunks // 8) and plan["plan_products_per_pair"] == plan["passes"] + 1
    assert d != 512 or plan["plan_products_per_pair"] == 2


# positions blocks: (Sq, Sk, d, query offset, key offset, causal, s_valid)
POS_BLOCKS = [(256, 256, 64, 256, 256, True, 512),  # the diagonal block of a causal ring
              (256, 256, 64, 256, 0, True, 512),  # a past block: every key before every query
              (256, 256, 64, 0, 256, True, 512),  # a dead block: every key after every query
              (100, 77, 128, 50, 30, True, 160),  # rectangular and ragged, half live
              (129, 200, 64, 0, 0, False, 150),  # full attention with pad keys past s_valid
              (64, 130, 8, 7, 0, False, 2**30)]  # unmasked: every key attends


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Sq,Sk,d,qo,ko,causal,s_valid", POS_BLOCKS)
def test_cuda_positions_kernels_match_plain_versions(Sq, Sk, d, qo, ko, causal, s_valid, dtype):
    """The positions kernels against their plain versions, with a nonzero
    lse cotangent folded into dd."""
    g = torch.Generator(device="cuda").manual_seed(Sq + Sk + d)
    q, do = (torch.randn((6, Sq, d), generator=g, device="cuda").to(dtype) for _ in range(2))
    k, v = (torch.randn((6, Sk, d), generator=g, device="cuda").to(dtype) for _ in range(2))
    qpos = torch.arange(qo, qo + Sq, dtype=torch.int32, device="cuda")
    kpos = torch.arange(ko, ko + Sk, dtype=torch.int32, device="cuda")
    masked = causal or s_valid < 2**30
    args = (qpos, kpos, causal, d**-0.5, s_valid, masked)
    before = dict(fa.launch_counts)
    out, lse = fa.flash_pos_fwd(q, k, v, *args)
    dd = (do.float() * out.float()).sum(-1) - torch.randn((6, Sq), generator=g, device="cuda")
    dq = fa.flash_pos_bwd_dq(q, k, v, do, lse, dd, *args)
    dk, dv = fa.flash_pos_bwd_dkv(q, k, v, do, lse, dd, *args)
    torch.cuda.synchronize()
    assert {key: fa.launch_counts[key] - before[key] for key in before} == {
        key: int(key.startswith("flash_pos_")) for key in before}
    assert dk.shape == k.shape and dv.shape == v.shape and lse.shape == (6, Sq)
    out_p, lse_p = fa._torch_flash_pos_fwd(q, k, v, *args)
    dq_p = fa._torch_flash_pos_bwd_dq(q, k, v, do, lse, dd, *args)
    dk_p, dv_p = fa._torch_flash_pos_bwd_dkv(q, k, v, do, lse, dd, *args)
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(lse, lse_p, atol=2e-5, rtol=2e-5)
    for got, want, kind in ((out, out_p, "out"), (dq, dq_p, "grad"), (dk, dk_p, "grad"), (dv, dv_p, "grad")):
        assert row_err(got, want) <= tol[kind]
        if dtype == torch.bfloat16:
            assert float((got != want).float().mean()) <= 0.01
    if qo + Sq <= ko:  # every key after every query
        assert not out.any() and bool((lse == fa.NO_MASS).all())
    again, lse2 = fa.flash_pos_fwd(q, k, v, *args)
    dk2, dv2 = fa.flash_pos_bwd_dkv(q, k, v, do, lse, dd, *args)
    assert torch.equal(out, again) and torch.equal(lse, lse2) and torch.equal(dk, dk2) and torch.equal(dv, dv2)


def test_cuda_flash_attention_block_pads_and_slices():
    """flash_attention_block on the card: ragged sides padded to the tile,
    against the dense oracle, forward and gradients (float32)."""
    g = torch.Generator(device="cuda").manual_seed(9)
    q, k, v = (torch.randn((2, 3, n, 32), generator=g, device="cuda").requires_grad_(True) for n in (70, 90, 90))
    qpos = torch.arange(40, 110, device="cuda")
    kpos = torch.arange(0, 90, device="cuda")
    out, lse = fa.flash_attention_block(q, k, v, qpos, kpos, causal=True, scale=0.2, s_valid=120)
    w, gl = torch.randn_like(out), torch.randn_like(lse)
    grads = torch.autograd.grad((out * w).sum() + (lse * gl).sum(), (q, k, v))
    out_d, lse_d = fa._dense_block_pos(q, k, v, qpos, kpos, True, 0.2, 120, True)
    grads_d = torch.autograd.grad((out_d * w).sum() + (lse_d * gl).sum(), (q, k, v))
    torch.testing.assert_close(out, out_d, atol=2e-5, rtol=2e-5)
    torch.testing.assert_close(lse, lse_d, atol=2e-5, rtol=2e-5)
    for got, want in zip(grads, grads_d):
        torch.testing.assert_close(got, want, atol=2e-4, rtol=2e-4)


def _misaligned(t: torch.Tensor) -> torch.Tensor:
    """t's values in a contiguous tensor whose data starts one element past
    the allocator's alignment, so not on a 16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape).copy_(t)
    assert out.data_ptr() % 16
    return out


def _assert_forward(fwd, plain, q, k, v, *args):
    """One forward against its plain version, repeated, and again with q off
    16-byte alignment (and, in float32, with v); returns (out, lse).  The
    row error to FLASH_TOL, and in bfloat16 at most 1% of the elements apart."""
    out, lse = fwd(q, k, v, *args)
    again, lse2 = fwd(q, k, v, *args)
    off, lse3 = fwd(_misaligned(q), k, v, *args)
    off_v, lse4 = fwd(q, k, _misaligned(v), *args)
    out_p, lse_p = plain(q, k, v, *args)
    torch.cuda.synchronize()
    assert out.shape == q.shape and out.dtype == q.dtype and lse.shape == q.shape[:2]
    torch.testing.assert_close(lse, lse_p, atol=2e-5, rtol=2e-5)
    assert row_err(out, out_p) <= FLASH_TOL[q.dtype]["out"]
    if q.dtype == torch.bfloat16:
        assert float((out != out_p).float().mean()) <= 0.01
    assert torch.equal(out, off_v) and torch.equal(lse, lse4)
    assert torch.equal(out, again) and torch.equal(lse, lse2)  # no atomics: the same bits every run
    assert torch.equal(out, off) and torch.equal(lse, lse3)  # element-wise loads fill the same tiles
    return out, lse


@pytest.mark.parametrize("group", [1, 4, 8])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [1, 15, 127, 129, 1000])
@pytest.mark.parametrize("d", [8, 33, 64, 100, 128])
def test_cuda_bf16_forward_matches_plain_version(d, S, causal, group):
    """The tensor-core forward through flash_fwd (group 1) and
    flash_gqa_fwd (4 or 8 query rows to a K/V row), 2 K/V rows."""
    g = torch.Generator(device="cuda").manual_seed(1000 * d + 10 * S + group + causal)
    q = torch.randn((2 * group, S, d), generator=g, device="cuda").to(torch.bfloat16)
    k, v = (torch.randn((2, S, d), generator=g, device="cuda").to(torch.bfloat16) for _ in range(2))
    fwd, plain, key = ((fa.flash_fwd, fa._torch_flash_fwd, "flash_fwd") if group == 1 else
                       (fa.flash_gqa_fwd, fa._torch_flash_gqa_fwd, "flash_gqa_fwd"))
    before = dict(fa.launch_counts)
    _assert_forward(fwd, plain, q, k, v, causal, d**-0.5)
    assert {name: fa.launch_counts[name] - before[name] for name in before} == {
        name: 4 * (name == key) for name in before}


# ring blocks at (Sq, Sk) = (300, 300), ragged against both tiles:
# name -> (query offset, key offset, causal, s_valid)
BF16_RING_BLOCKS = {"diagonal": (300, 300, True, 600), "past": (300, 0, True, 600), "dead": (0, 300, True, 600),
                    "pad keys": (0, 0, False, 250)}


@pytest.mark.parametrize("d", [33, 64, 128])
@pytest.mark.parametrize("block", list(BF16_RING_BLOCKS))
def test_cuda_bf16_forward_positions_blocks(block, d):
    """The tensor-core forward under the positions mask: the ring's
    diagonal, past and dead blocks, and full attention with pad keys; the
    dead block gives out 0 and lse -1e30 exactly."""
    qo, ko, causal, s_valid = BF16_RING_BLOCKS[block]
    g = torch.Generator(device="cuda").manual_seed(d + qo + ko)
    q, k, v = (torch.randn((4, 300, d), generator=g, device="cuda").to(torch.bfloat16) for _ in range(3))
    qpos = torch.arange(qo, qo + 300, dtype=torch.int32, device="cuda")
    kpos = torch.arange(ko, ko + 300, dtype=torch.int32, device="cuda")
    args = (qpos, kpos, causal, d**-0.5, s_valid, True)
    out, lse = _assert_forward(fa.flash_pos_fwd, fa._torch_flash_pos_fwd, q, k, v, *args)
    if block == "dead":
        assert not out.any() and bool((lse == fa.NO_MASS).all())
    else:
        assert bool(torch.isfinite(lse).all()) and bool((lse > fa.NO_MASS).all())


@pytest.mark.parametrize("group", [1, 4, 8])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [1, 15, 127, 129, 1000])
@pytest.mark.parametrize("d", [8, 33, 64, 100, 128])
def test_cuda_f32_forward_matches_plain_version(d, S, causal, group):
    """The float32 forward (the CUDA-core body, ``csrc/flash_f32.cuh``)
    through flash_fwd (group 1) and flash_gqa_fwd, over the bfloat16
    forward's shapes: d on and off the 16-byte loads, S around the 64-row
    tiles; repeated, and with q or v off 16-byte alignment, to the same bits."""
    g = torch.Generator(device="cuda").manual_seed(4000 * d + 10 * S + group + causal)
    q = torch.randn((2 * group, S, d), generator=g, device="cuda")
    k, v = (torch.randn((2, S, d), generator=g, device="cuda") for _ in range(2))
    fwd, plain, key = ((fa.flash_fwd, fa._torch_flash_fwd, "flash_fwd") if group == 1 else
                       (fa.flash_gqa_fwd, fa._torch_flash_gqa_fwd, "flash_gqa_fwd"))
    before = dict(fa.launch_counts)
    _assert_forward(fwd, plain, q, k, v, causal, d**-0.5)
    assert {name: fa.launch_counts[name] - before[name] for name in before} == {
        name: 4 * (name == key) for name in before}


@pytest.mark.parametrize("d", [33, 64, 128])
@pytest.mark.parametrize("block", list(BF16_RING_BLOCKS))
def test_cuda_f32_forward_positions_blocks(block, d):
    """The float32 forward under the positions mask at the ring's blocks;
    the dead block, which returns before it loads a tile, gives out 0 and
    lse -1e30 exactly."""
    qo, ko, causal, s_valid = BF16_RING_BLOCKS[block]
    g = torch.Generator(device="cuda").manual_seed(7 * d + qo + ko)
    q, k, v = (torch.randn((4, 300, d), generator=g, device="cuda") for _ in range(3))
    qpos = torch.arange(qo, qo + 300, dtype=torch.int32, device="cuda")
    kpos = torch.arange(ko, ko + 300, dtype=torch.int32, device="cuda")
    out, lse = _assert_forward(fa.flash_pos_fwd, fa._torch_flash_pos_fwd, q, k, v, qpos, kpos, causal, d**-0.5,
                               s_valid, True)
    if block == "dead":
        assert not out.any() and bool((lse == fa.NO_MASS).all())
    else:
        assert bool(torch.isfinite(lse).all()) and bool((lse > fa.NO_MASS).all())


@pytest.mark.parametrize("case", _CHIP_SMOKE.EM_EDGE_CHECKS, ids=lambda c: "-".join(map(str, c)))
def test_cuda_em_stats_edges(case):
    """assign and em_stats at chip_smoke.py's edge shapes (check_em_edges):
    k of 1 to 300, the products by wgmma and by mma.sync, d of 1 to 128, n
    of 0, 1, under a tile, off a block and past the rows, bfloat16, rows in
    random order, rows off 16-byte alignment, one cluster holding 99% of 1e6
    rows; assign's d2 within D2_RTOL and labels apart only at near ties; em
    counts equal to bincount of assign's labels, sums within SUM_RTOL of
    their float64 scatter, against the plain version; both twice to the
    same bits (the check raises otherwise)."""
    before = dict(kk.launch_counts)
    _CHIP_SMOKE.check_em_edges([case])
    assert kk.launch_counts["em_stats"] == before["em_stats"] + 2
    assert kk.launch_counts["assign"] == before["assign"] + 2


# the largest k each kernel took before its products moved to the tensor
# cores, by d (its shared-memory layout then): none may fall
OLD_K_LIMITS = {32: (1696, 848), 64: (828, 414), 128: (416, 208)}
# the largest k of (assign, em_stats) now, by d and dtype, as kmeans.cu's
# source note and ROADMAP R6 state them: one centre more raises
NEW_K_LIMITS = {(32, torch.float32): (1720, 862), (64, torch.float32): (856, 428),
                (128, torch.float32): (416, 208), (32, torch.bfloat16): (1736, 869),
                (64, torch.bfloat16): (872, 436), (128, torch.bfloat16): (432, 216)}


@pytest.mark.parametrize("limits", ["old", "new"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", sorted(OLD_K_LIMITS))
def test_cuda_kmeans_kernels_launch_at_the_old_k_limits(d, dtype, limits):
    """assign at its largest k and em_stats at its own, before the tensor
    cores ("old") and as stated now ("new"), each against its plain version
    (chip_smoke's compare_assign and compare_em), by mma.sync: these k are
    past what wgmma's centres hold.  At the new limits, one centre more
    raises the shared-memory error in both kernels."""
    k_assign, k_em = OLD_K_LIMITS[d] if limits == "old" else NEW_K_LIMITS[d, dtype]
    x, c = _CHIP_SMOKE.em_edge_inputs(3000, k_assign + 1, d, str(dtype).replace("torch.", ""), "shuffled", seed=d)
    ca = c[:k_assign].contiguous()
    lab, d2 = kk.fused_assign(x, ca)
    lab_p, d2_p = kk._torch_assign(x, ca)
    _CHIP_SMOKE.compare_assign(x, ca, lab, d2, lab_p, d2_p)
    ce = c[:k_em].contiguous()
    sums, counts = kk.fused_em_stats(x, ce)
    lab_e, _ = kk.fused_assign(x, ce)
    sums_p, counts_p = kk._torch_em_stats(x, ce, x.shape[0])
    lab_ep, _ = kk._torch_assign(x, ce)
    _CHIP_SMOKE.compare_em(x, ce, x.shape[0], sums, counts, lab_e, sums_p, counts_p, int((lab_e != lab_ep).sum()))
    for k, em in ((k_assign, False), (k_em, True)):
        assert kk.launch_config(k, d, dtype, em=em)["products"] == "mma.sync"
        assert kk.launch_config(k, d, dtype, em=em)["route"] == "tiled"
    if limits == "new":
        # one centre more raised a shared-memory error before R6: it now
        # takes the streamed route and matches the plain version, and
        # em_stats' counts stay those of assign's labels (the streamed
        # route's products are the mma.sync route's to the bit)
        lab_p, d2_p = kk._torch_assign(x, c)
        lab, d2 = kk.fused_assign(x, c)
        assert kk.launch_config(k_assign + 1, d, dtype)["route"] == "streamed"
        _CHIP_SMOKE.compare_assign(x, c, lab, d2, lab_p, d2_p)
        ce = c[:k_em + 1].contiguous()
        assert kk.launch_config(k_em + 1, d, dtype, em=True)["route"] == "streamed"
        sums, counts = kk.fused_em_stats(x, ce)
        lab_e, _ = kk.fused_assign(x, ce)
        sums_p, counts_p = kk._torch_em_stats(x, ce, x.shape[0])
        lab_ep, _ = kk._torch_assign(x, ce)
        _CHIP_SMOKE.compare_em(x, ce, x.shape[0], sums, counts, lab_e, sums_p, counts_p,
                               int((lab_e != lab_ep).sum()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_both_kernels_take_the_same_products_at_every_k(dtype):
    """Both kernels pick wgmma or mma.sync by the same rule, so em_stats'
    counts are bincount of assign's labels on either side of the switch
    (k = 256 and 257 at d = 32 in float32), and each launch takes whole
    warpgroups under wgmma."""
    switch = {torch.float32: 256, torch.bfloat16: 263}[dtype]
    for k in (switch, switch + 1):
        a, e = kk.launch_config(k, 32, dtype), kk.launch_config(k, 32, dtype, em=True)
        assert a["products"] == e["products"] == ("wgmma" if k == switch else "mma.sync")
        if a["products"] == "wgmma":
            assert a["warps"] % 4 == 0 and e["warps"] % 4 == 0
        x, c = _CHIP_SMOKE.em_edge_inputs(5000, k, 32, str(dtype).replace("torch.", ""), "shuffled", seed=k)
        lab, _ = kk.fused_assign(x, c)
        _, counts = kk.fused_em_stats(x, c)
        assert torch.equal(counts, torch.bincount(lab.long(), minlength=k).float())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kmeans_resident_warps_equal_the_occupancy_calculator(dtype):
    """The warps each kernel's launch holds on an SM at once, counted by the
    warps themselves (resident_warps), reach what the occupancy calculator
    gives the launch (launch_config), on every SM the launch used, at a grid
    of every resident block; the counter is off outside the call."""
    x, c = _CHIP_SMOKE.em_edge_inputs(4_000_000, 64, 32, str(dtype).replace("torch.", ""), "blobs", seed=3)
    for run, em in ((lambda: kk.fused_assign(x, c), False), (lambda: kk.fused_em_stats(x, c), True)):
        used = kk.resident_warps(run)
        assert used and set(used) == {kk.launch_config(64, 32, dtype, em=em)["resident_warps"]}
        assert len(used) == torch.cuda.get_device_properties(0).multi_processor_count
        run()
        assert kk.resident_warps(lambda: None) == []


def _assert_backward(names, q, k, v, do, *args, g_lse=None):
    """dq and dk/dv of the wrappers ``names`` against their plain versions,
    repeated, and again with dO off 16-byte alignment; ``g_lse``, an lse
    cotangent, folds into dd.  bfloat16: the row error and the share above
    the row floor; float32: the row error, but below 129 rows chip_smoke's
    edge criterion (rows below the row floor are float32 noise of a
    cancelled sum, held to EDGE_F32_ATOL).  Returns (dq, dk, dv)."""
    (fwd, bwd_dq, bwd_dkv), (plain_dq, plain_dkv) = (getattr(fa, n) for n in names), (
        getattr(fa, f"_torch_{n}") for n in names[1:])
    out, lse = fwd(q, k, v, *args)
    dd = (do.float() * out.float()).sum(-1) - (0.0 if g_lse is None else g_lse)
    before = dict(fa.launch_counts)
    grads = (bwd_dq(q, k, v, do, lse, dd, *args), *bwd_dkv(q, k, v, do, lse, dd, *args))
    again = (bwd_dq(q, k, v, do, lse, dd, *args), *bwd_dkv(q, k, v, do, lse, dd, *args))
    off = _misaligned(do)
    shifted = (bwd_dq(q, k, v, off, lse, dd, *args), *bwd_dkv(q, k, v, off, lse, dd, *args))
    plain = (plain_dq(q, k, v, do, lse, dd, *args), *plain_dkv(q, k, v, do, lse, dd, *args))
    torch.cuda.synchronize()
    assert {n: fa.launch_counts[n] - before[n] for n in before} == {n: 3 * (n in names[1:]) for n in before}
    assert grads[0].shape == q.shape and grads[1].shape == grads[2].shape == k.shape
    for got, rep, mis, want in zip(grads, again, shifted, plain):
        assert got.dtype == q.dtype
        assert torch.equal(got, rep) and torch.equal(got, mis)  # no atomics; element-wise loads, same tiles
        if q.dtype == torch.bfloat16:
            assert row_err(got, want) <= FLASH_TOL[torch.bfloat16]["grad"]
            assert _CHIP_SMOKE._share_above_floor(got, want) <= 0.01
        elif min(q.shape[1], k.shape[1]) < 129:
            assert _CHIP_SMOKE._edge_ok(_CHIP_SMOKE._edge_err(got, want))
        else:
            assert row_err(got, want) <= FLASH_TOL[torch.float32]["grad"]
    return grads


def _backward_case(dtype, seed, d, S, causal, group):
    """dq and dk/dv in ``dtype`` through flash_bwd_dq and flash_bwd_dkv
    (group 1) or the grouped wrappers (group query rows to a K/V row), 2
    K/V rows, by _assert_backward."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, do = (torch.randn((2 * group, S, d), generator=g, device="cuda").to(dtype) for _ in range(2))
    k, v = (torch.randn((2, S, d), generator=g, device="cuda").to(dtype) for _ in range(2))
    names = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv") if group == 1 else (
        "flash_gqa_fwd", "flash_gqa_bwd_dq", "flash_gqa_bwd_dkv")
    _assert_backward(names, q, k, v, do, causal, d**-0.5)


def _backward_block(dtype, seed, block, d):
    """dq and dk/dv in ``dtype`` of the ring block ``block`` at (4, 300,
    300, d) with a nonzero lse cotangent, by _assert_backward; the dead
    block gives exact zeros."""
    qo, ko, causal, s_valid = BF16_RING_BLOCKS[block]
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (torch.randn((4, 300, d), generator=g, device="cuda").to(dtype) for _ in range(4))
    g_lse = torch.randn((4, 300), generator=g, device="cuda")
    qpos = torch.arange(qo, qo + 300, dtype=torch.int32, device="cuda")
    kpos = torch.arange(ko, ko + 300, dtype=torch.int32, device="cuda")
    grads = _assert_backward(("flash_pos_fwd", "flash_pos_bwd_dq", "flash_pos_bwd_dkv"), q, k, v, do, qpos,
                             kpos, causal, d**-0.5, s_valid, True, g_lse=g_lse)
    if block == "dead":
        assert not any(t.any() for t in grads)


@pytest.mark.parametrize("group", [1, 4, 8])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [1, 15, 127, 129, 1024])
@pytest.mark.parametrize("d", [8, 33, 64, 100, 128])
def test_cuda_bf16_backward_matches_plain_version(d, S, causal, group):
    """The tensor-core dq and dk/dv through flash_bwd_dq and flash_bwd_dkv
    (group 1) and the grouped wrappers (4 or 8 query rows to a K/V row, dk
    and dv summed over the group), 2 K/V rows."""
    _backward_case(torch.bfloat16, 2000 * d + 10 * S + group + causal, d, S, causal, group)


@pytest.mark.parametrize("d", [33, 64, 128])
@pytest.mark.parametrize("block", list(BF16_RING_BLOCKS))
def test_cuda_bf16_backward_positions_blocks(block, d):
    """The tensor-core dq and dk/dv under the positions mask, with a nonzero
    lse cotangent: the ring's diagonal, past and dead blocks and full
    attention with pad keys; the dead block gives exact zeros."""
    qo, ko, _, _ = BF16_RING_BLOCKS[block]
    _backward_block(torch.bfloat16, 3 * d + qo + ko, block, d)


@pytest.mark.parametrize("group", [1, 4, 8])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [1, 15, 127, 129, 1024])
@pytest.mark.parametrize("d", [8, 33, 64, 100, 128])
def test_cuda_f32_backward_matches_plain_version(d, S, causal, group):
    """The float32 dq and dk/dv (the CUDA-core bodies,
    ``csrc/flash_f32.cuh``) over the bfloat16 test's shapes: d on and
    off the 16-byte loads (33), S around the 32- and 64-row tiles."""
    _backward_case(torch.float32, 3000 * d + 10 * S + group + causal, d, S, causal, group)


@pytest.mark.parametrize("d", [33, 64, 128])
@pytest.mark.parametrize("block", list(BF16_RING_BLOCKS))
def test_cuda_f32_backward_positions_blocks(block, d):
    """The float32 dq and dk/dv under the positions mask, at the bfloat16
    test's blocks; the dead block gives exact zeros."""
    qo, ko, _, _ = BF16_RING_BLOCKS[block]
    _backward_block(torch.float32, 5 * d + qo + ko, block, d)


def _gloo_rank(rank, store):
    """One of two processes on cuda:0 in a gloo group: the communicator's
    collectives on CUDA tensors, each result on the card with the right
    values, and each collective's transport: gloo's own send/recv refuse
    CUDA buffers, so ``Send``, ``Exscan`` and ``Scan`` stage them through
    host memory; its collectives take them as they are (all_to_all_single,
    reduce_scatter, gather, scatter, reduce and barrier too).  Then
    ``ht.matmul`` of CUDA DNDarrays stays on the card."""
    import heat_tpu_torch as ht

    ht.core.bootstrap.init_distributed(f"file://{store}", world_size=2, rank=rank, backend="gloo", timeout_s=60)
    try:
        comm = ht.core.communication.get_comm()
        x = torch.tensor([rank, 10 + rank], dtype=torch.float32, device="cuda")
        for op in ("Allreduce", "Allgather", "Alltoall", "ReduceScatter", "Bcast", "Reduce", "Scatter", "Gather"):
            assert comm.transport(x, op) == "gloo", op
        for op in ("Send", "Exscan", "Scan"):
            assert comm.transport(x, op) == "gloo-host-staged", op
        got = comm.Send(x, shift=1)
        assert got.is_cuda and got.tolist() == [1 - rank, 11 - rank]
        total = comm.Allreduce(x.clone())
        assert total.is_cuda and total.tolist() == [1, 21]
        root = comm.Bcast(x.clone(), root=1)
        assert root.is_cuda and root.tolist() == [1, 11]
        parts = comm.Allgather(x)
        assert all(p.is_cuda for p in parts) and [p.tolist() for p in parts] == [[0, 10], [1, 11]]
        block = torch.arange(6, dtype=torch.float32, device="cuda").reshape(2, 3) + 100 * rank
        results = {
            "Alltoall": (comm.Alltoall(block, 1, 0), [[0, 1], [3, 4], [100, 101], [103, 104]] if rank == 0 else
                         [[2], [5], [102], [105]]),
            "ReduceScatter": (comm.ReduceScatter(block, 1), [[100, 102], [106, 108]] if rank == 0 else [[104], [110]]),
            "Exscan": (comm.Exscan(x), [0, 0] if rank == 0 else [0, 10]),
            "Scan": (comm.Scan(x), [0, 10] if rank == 0 else [1, 21]),
            "Reduce": (comm.Reduce(x.clone(), root=0), [1, 21] if rank == 0 else [0, 0]),
            "Scatter": (comm.Scatter(block, root=0, axis=1), [[0, 1], [3, 4]] if rank == 0 else [[2], [5]]),
            "Gather": (comm.Gather(x[:rank + 1], root=1), [0, 0, 0] if rank == 0 else [0, 1, 11]),
            "Allgatherv": (comm.Allgatherv(x[:rank + 1]), [0, 1, 11]),
            "Isend": (comm.Wait(comm.Isend(x, 1)), [1 - rank, 11 - rank]),
        }
        for name, (out, want) in results.items():
            assert out.is_cuda and out.tolist() == want, (name, out, want)
        comm.Barrier()
        a = torch.arange(35, dtype=torch.float32, device="cuda").reshape(7, 5) / 7
        b = torch.arange(20, dtype=torch.float32, device="cuda").reshape(5, 4) / 5
        for sa, sb in ((0, 0), (1, 0), (None, 1), (0, 1)):
            c = ht.matmul(ht.array(a, split=sa), ht.array(b, split=sb))
            assert c.larray.is_cuda and c.device == "gpu"
            torch.testing.assert_close(c.resplit(None).larray, a @ b, rtol=1e-5, atol=1e-5)
        s = ht.linalg.matmul_summa(ht.array(a, split=0), ht.array(b, split=0))
        assert s.larray.is_cuda
        torch.testing.assert_close(s.resplit(None).larray, a @ b, rtol=1e-5, atol=1e-5)
        gi = torch.Generator(device="cuda").manual_seed(9)
        ia = torch.randint(-2**31, 2**31 - 1, (7, 5), generator=gi, dtype=torch.int32, device="cuda")
        ib = torch.randint(-2**31, 2**31 - 1, (5, 4), generator=gi, dtype=torch.int32, device="cuda")
        want = ia.cpu().numpy() @ ib.cpu().numpy()
        for sa, sb in ((0, 0), (1, 0)):
            c = ht.matmul(ht.array(ia, split=sa), ht.array(ib, split=sb))
            assert c.larray.is_cuda and c.dtype is ht.int32
            np.testing.assert_array_equal(c.resplit(None).larray.cpu().numpy(), want)
        s = ht.linalg.matmul_summa(ht.array(ia, split=0), ht.array(ib, split=0))
        np.testing.assert_array_equal(s.resplit(None).larray.cpu().numpy(), want)
        torch.distributed.barrier()
    finally:
        ht.core.bootstrap.finalize_distributed()


def test_cuda_collectives_under_gloo_on_one_card(tmp_path):
    """The communicator's transport on one card: two gloo ranks on cuda:0
    (NCCL refuses two ranks on one card) run every collective on CUDA
    tensors, and ``ht.matmul`` of CUDA DNDarrays, through the
    communicator."""
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_gloo_rank, args=(r, str(tmp_path / "store"))) for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=120)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(5)
    assert [p.exitcode for p in procs] == [0, 0]


def test_cuda_matmul_stays_on_the_card():
    """At world size 1 ``ht.matmul`` of CUDA DNDarrays is one
    ``torch.matmul`` of the local tensors on the card, bit for bit, in full
    float32 (TF32 left off)."""
    assert not torch.backends.cuda.matmul.allow_tf32
    g = torch.Generator(device="cuda").manual_seed(3)
    a = torch.randn(300, 200, generator=g, device="cuda")
    b = torch.randn(200, 100, generator=g, device="cuda")
    for sa, sb in ((0, 0), (None, 1), (1, None)):
        c = htt.matmul(htt.array(a, split=sa), htt.array(b, split=sb))
        assert c.larray.is_cuda and c.device == "gpu" and c.dtype is htt.float32
        assert torch.equal(c.larray, a @ b)
    err = float((a @ b - (a.double() @ b.double())).abs().max() / (a.double() @ b.double()).abs().max())
    assert err < 1e-5


@pytest.mark.parametrize("dtype", [np.int32, np.uint8, np.int16, np.int8])
def test_cuda_integer_matmul_is_exact_and_wraps_as_numpy(dtype):
    """torch has no integer GEMM on the card: ``ht.matmul`` of integer CUDA
    DNDarrays takes exact float64 products of 16-bit halves
    (``basics._int_matmul``) and wraps as the reference's ``jnp.matmul``
    and numpy's integer product do; bool @ bool is the or of ands; int64
    raises a TypeError."""
    info = np.iinfo(dtype)
    rng = np.random.default_rng(int(info.bits))
    a = rng.integers(info.min, info.max, (300, 1000), endpoint=True).astype(dtype)
    b = rng.integers(info.min, info.max, (1000, 70), endpoint=True).astype(dtype)
    want = a @ b
    for sa, sb in ((0, 0), (None, None), (1, 0)):
        c = htt.matmul(htt.array(torch.from_numpy(a).cuda(), split=sa), htt.array(torch.from_numpy(b).cuda(), split=sb))
        assert c.larray.is_cuda and c.dtype.__name__ == np.dtype(dtype).name
        np.testing.assert_array_equal(c.numpy(), want)
    from heat_tpu_torch.linalg import basics

    basics_k = basics._EXACT_K
    basics._EXACT_K = 256  # K in four chunks, each exact
    try:
        np.testing.assert_array_equal(basics._int_matmul(torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda())
                                      .cpu().numpy(), want)
    finally:
        basics._EXACT_K = basics_k
    p, q = rng.random((50, 40)) > 0.7, rng.random((40, 30)) > 0.7
    got = htt.matmul(htt.array(torch.from_numpy(p).cuda(), split=0), htt.array(torch.from_numpy(q).cuda(), split=0))
    assert got.larray.is_cuda and got.dtype is htt.bool
    np.testing.assert_array_equal(got.numpy(), (p.astype(np.int64) @ q.astype(np.int64)) > 0)
    with pytest.raises(TypeError):
        htt.matmul(htt.array(torch.ones(4, 4, dtype=torch.int64, device="cuda")),
                   htt.array(torch.ones(4, 4, dtype=torch.int64, device="cuda")))


def test_cuda_qr_svd_cdist_and_solvers_stay_on_the_card():
    """The linear algebra of the config-1 path at a small size on the card,
    under TF32 matmul precision set by the caller: every result on the
    card, in full float32 (within 1e-4 of float64), and the caller's
    precision restored."""
    flags = torch.backends.cuda.matmul
    old = flags.fp32_precision
    flags.fp32_precision = "tf32"
    try:
        g = torch.Generator(device="cuda").manual_seed(5)
        a = torch.randn(4099, 64, generator=g, device="cuda")
        for method in ("auto", "householder"):
            q, r = htt.linalg.qr(htt.array(a, split=0), method=method)
            assert q.larray.is_cuda and r.larray.is_cuda and flags.fp32_precision == "tf32"
            qd, rd = q.larray.double(), r.larray.double()
            assert float((qd @ rd - a.double()).norm() / a.double().norm()) < 1e-5
            assert float((qd.T @ qd - torch.eye(64, device="cuda", dtype=torch.float64)).abs().max()) < 1e-4
        u, s, v = htt.linalg.svd(htt.array(a, split=0))
        s64 = torch.linalg.svdvals(a.double())
        assert u.larray.is_cuda and float((s.larray.double() - s64).abs().max() / s64.max()) < 1e-5
        x, y = torch.randn(500, 32, generator=g, device="cuda"), torch.randn(300, 32, generator=g, device="cuda")
        d64 = torch.cdist(x.double(), y.double())
        for expand in (False, True):
            d = htt.spatial.cdist(htt.array(x, split=0), htt.array(y), quadratic_expansion=expand)
            assert d.larray.is_cuda and float((d.larray.double() - d64).abs().max() / d64.max()) < 1e-5
        m = torch.randn(256, 256, generator=g, device="cuda")
        spd = m @ m.T / 256 + torch.eye(256, device="cuda")
        bvec = torch.randn(256, generator=g, device="cuda")
        sol = htt.linalg.cg(htt.array(spd, split=0), htt.array(bvec, split=0), tol=1e-5)
        want = torch.linalg.solve(spd.double(), bvec.double())
        assert sol.larray.is_cuda and float((sol.larray.double() - want).abs().max() / want.abs().max()) < 1e-4
        up = torch.triu(m) + 16 * torch.eye(256, device="cuda")
        for blocked in (True, False):
            t = htt.linalg.solve_triangular(htt.array(up, split=0), htt.array(bvec, split=0), blocked=blocked)
            want = torch.linalg.solve_triangular(up.double(), bvec.double()[:, None], upper=True)[:, 0]
            assert t.larray.is_cuda and float((t.larray.double() - want).abs().max() / want.abs().max()) < 1e-5
        assert flags.fp32_precision == "tf32"
    finally:
        flags.fp32_precision = old


def _data_parallel_rank(rank, store):
    """One of two gloo processes on cuda:0: DataParallel (hooked buckets,
    then ``overlap_sync``, at least two buckets each) and DASO (2 groups x 1) on a
    small ResNet.  Every tensor handed to a collective, every bucket buffer
    and every DASO snapshot is a CUDA tensor, and nothing inside the
    bucketed sync reads a tensor back to the host."""
    import torch.distributed as dist

    import heat_tpu_torch as ht
    from heat_tpu_torch.core import collectives

    ht.core.bootstrap.init_distributed(f"file://{store}", world_size=2, rank=rank, backend="gloo", timeout_s=60)
    seen, in_sync = {"collective": set(), "bucket": set()}, [0]

    def record(fn, kind):
        def wrapped(*args, **kwargs):
            tensors = [a for a in args if isinstance(a, torch.Tensor)]
            tensors += [t for a in args if isinstance(a, (list, tuple)) for t in a if isinstance(t, torch.Tensor)]
            # floating data only: Split's colour table is an int64 control message, on the host under gloo
            seen[kind].update(str(t.device) for t in tensors if t.is_floating_point())
            out = fn(*args, **kwargs)
            if kind == "bucket" and isinstance(out, torch.Tensor):
                seen[kind].add(str(out.device))
            return out
        return wrapped

    def syncing(fn):
        def wrapped(*args, **kwargs):
            in_sync[0] += 1
            try:
                return fn(*args, **kwargs)
            finally:
                in_sync[0] -= 1
        return wrapped

    def no_host(name):
        orig = getattr(torch.Tensor, name)

        def guarded(self, *args, **kwargs):
            if in_sync[0]:
                raise AssertionError(f"Tensor.{name} inside the bucketed sync")
            return orig(self, *args, **kwargs)
        return guarded

    for name in ("all_reduce", "reduce_scatter", "all_gather", "broadcast"):
        setattr(dist, name, record(getattr(dist, name), "collective"))
    collectives._flatten = record(collectives._flatten, "bucket")
    for name in ("bucketed_grad_allreduce", "dispatch_bucket_allreduce", "dispatch_bucket_averages",
                 "consume_bucket_averages", "bucketed_param_sync", "dispatch_all_bucket_averages"):
        setattr(collectives, name, syncing(getattr(collectives, name)))
    collectives._GradBucket.wait = syncing(collectives._GradBucket.wait)
    for name in ("cpu", "numpy", "tolist", "item"):
        setattr(torch.Tensor, name, no_host(name))
    try:
        ht.use_device("gpu")
        ce = ht.nn.functional.cross_entropy
        g = torch.Generator(device="cuda").manual_seed(rank)
        x = torch.randn(6, 3, 16, 16, generator=g, device="cuda")
        y = torch.randint(0, 5, (6,), generator=g, device="cuda")
        for overlap in (False, True):
            torch.manual_seed(rank)
            model = ht.nn.models.resnet((1, 1), width=8, num_classes=5)
            budget = sum(p.numel() * 4 for p in model.parameters()) // 2 + 1
            dp = ht.nn.DataParallel(model, optimizer=ht.optim.DataParallelOptimizer("sgd", lr=0.1, momentum=0.9),
                                    overlap_sync=overlap, grad_bucket_bytes=budget)
            assert dp._plan.n_buckets >= 2
            loss = dp.make_train_step(ce)(x, y)
            assert loss.is_cuda
            assert all(p.is_cuda and p.grad.is_cuda for p in model.parameters())
            assert all(b.is_cuda for b in model.buffers())
        torch.manual_seed(rank)
        model = ht.nn.models.resnet((1, 1), width=8, num_classes=5)
        daso = ht.optim.DASO(ht.optim.DataParallelOptimizer("sgd", lr=0.1), total_local_comm_size=1,
                             warmup_steps=1, global_skip=2, stale_steps=1, overlap_sync=True)
        daso.init(model)
        for _ in range(4):
            assert daso.step(ce, x, y).is_cuda
        assert daso._pending is None or all(f.flat.is_cuda for f in daso._pending[0][1])
        assert all(p.is_cuda for p in daso.consolidated_params().values())
        assert seen["collective"] == {"cuda:0"}, seen
        assert seen["bucket"] == {"cuda:0"}, seen
        dist.barrier()
    finally:
        ht.core.bootstrap.finalize_distributed()


def test_cuda_data_parallel_and_daso_stay_on_the_card(tmp_path):
    """DataParallel's and DASO's parameters, gradients, buckets and
    snapshots are CUDA tensors, every collective of data takes CUDA tensors
    (under NCCL: no host copy), and the bucketed sync reads nothing back to
    the host (two gloo ranks on cuda:0; NCCL refuses two ranks on one card)."""
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_data_parallel_rank, args=(r, str(tmp_path / "store"))) for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=180)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(5)
    assert [p.exitcode for p in procs] == [0, 0]


def _device_to_host_copies(fn, tmp_path):
    """The bytes of each device-to-host copy torch.profiler's trace shows
    during ``fn()``."""
    import json

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return [int(e["args"]["bytes"]) for e in events if e.get("cat") == "gpu_memcpy" and "DtoH" in e.get("name", "")]


def test_cuda_indexing_and_setitem_stay_on_the_card(tmp_path):
    """Every kind of key, ``__setitem__``, ``where``, ``nonzero`` and
    ``fill_diagonal`` on CUDA arrays at world size 1: each result a CUDA
    tensor equal to torch's own indexing of the same tensor, and nothing
    copied to the host but scalars (a bound or a count: at most 8 bytes a
    copy) and, for ``str``, the printed edges."""
    g = torch.Generator(device="cuda").manual_seed(21)
    a = torch.randn(1000, 33, generator=g, device="cuda")
    idx = torch.randint(0, 1000, (500,), generator=g, device="cuda")
    m = a[:, 0] > 0
    x = htt.array(a, split=0)

    def run():
        out = []
        for key, want in ((idx, a[idx]), ((slice(None), 3), a[:, 3]), (slice(None, None, -1), a.flip(0)),
                          ((slice(None), slice(None, None, 2)), a[:, ::2]), (5, a[5]), (m, a[m]),
                          ((idx[:7], slice(2, 9)), a[idx[:7], 2:9]), ((None, Ellipsis, 4), a[None, :, 4])):
            got = x[key]
            assert got.larray.is_cuda and torch.equal(got.larray, want)
            out.append(got)
        y = htt.array(a, split=1)
        y[y < 0] = 0
        y[idx[:3]] = htt.array(torch.ones(3, 33, device="cuda"), split=0)
        want = a.clone()
        want[want < 0] = 0
        want[idx[:3]] = 1.0
        assert y.larray.is_cuda and torch.equal(y.larray, want)
        w = htt.where(x > 0, x, 0)
        assert w.larray.is_cuda and torch.equal(w.larray, torch.where(a > 0, a, 0))
        nz = htt.nonzero(htt.array(m, split=0))
        assert nz.larray.is_cuda and torch.equal(nz.larray, torch.nonzero(m).reshape(-1).int())
        f = htt.array(a, split=1).fill_diagonal(-1.0)
        assert f.larray.is_cuda and torch.equal(f.larray.diagonal(), torch.full((33,), -1.0, device="cuda"))
        return out

    copies = _device_to_host_copies(run, tmp_path)
    assert all(c <= 8 for c in copies), copies
    big = htt.array(torch.randn(10_000, 500, generator=g, device="cuda"), split=0)
    text = []
    copies = _device_to_host_copies(lambda: text.append(str(big)), tmp_path)
    assert "..." in text[0] and 0 < sum(copies) <= 7 * 7 * 4 + 8 * len(copies), copies


def test_cuda_hermitian_is_formed_on_the_card(tmp_path):
    """``matrixgallery.hermitian`` draws and forms its matrix on the card:
    a CUDA result, Hermitian (positive definite on request), and nothing
    of it copied to the host."""
    from heat_tpu_torch.utils.data import matrixgallery as mg

    out = []
    copies = _device_to_host_copies(lambda: out.extend([mg.hermitian(256, split=0),
                                                        mg.hermitian(256, split=1, positive_definite=True,
                                                                     dtype=htt.float32)]), tmp_path)
    assert all(c <= 8 for c in copies), copies
    h, pd = (o.larray for o in out)
    assert h.is_cuda and h.dtype == torch.complex64 and torch.equal(h, h.conj().T)
    assert pd.is_cuda and torch.linalg.eigvalsh(pd.double()).min() > 0


def test_cuda_statistics_manipulations_and_sort_stay_on_the_card(tmp_path, monkeypatch):
    """The slice's statistics, manipulations, sort, unique and random draws
    on CUDA arrays at world size 1: every result a CUDA tensor; nothing
    routes through the host (``torch.histogram`` and ``torch.quantile``,
    which have no CUDA path for these inputs, must not be called) and no
    copy to the host is larger than a control value (counts, bounds: at
    most 4 KiB, the arrays being 1 MB and more)."""
    from unittest import mock

    def refuse(*args, **kwargs):
        raise AssertionError("a host-routed torch call")

    g = torch.Generator(device="cuda").manual_seed(22)
    a = torch.randn(4096, 64, generator=g, device="cuda")
    v = torch.rand(1 << 20, generator=g, device="cuda")
    w = torch.randint(0, 1000, (1 << 20,), generator=g, device="cuda", dtype=torch.int32)
    x, xv, xw = htt.array(a, split=0), htt.array(v, split=0), htt.array(w, split=0)
    out = []

    def run():
        with mock.patch.object(torch, "histogram", refuse), mock.patch.object(torch, "quantile", refuse):
            htt.random.seed(3)
            out.extend([htt.random.rand(1000, 64, split=0), htt.random.randn(1000, 64, split=1),
                        htt.random.randint(0, 9, (5000,), split=0), htt.random.permutation(5000)])
            for axis in (None, 0, 1):
                out.extend([htt.mean(x, axis), htt.var(x, axis), htt.std(x, axis), htt.argmax(x, axis),
                            htt.nanmax(x, axis), htt.skew(x, axis), htt.percentile(x, [5, 50], axis=axis)])
            out.extend([htt.cov(x, rowvar=False), htt.corrcoef(x[:, :8], rowvar=False), *htt.histogram(x, 50),
                        htt.histc(x, 20), htt.bincount(xw), htt.digitize(x, htt.array(torch.linspace(-1, 1, 5,
                                                                                                      device="cuda")))])
            out.extend([*htt.sort(xv), htt.argsort(x, 0), *htt.topk(xv, 100), htt.median(xv), htt.unique(xw),
                        htt.searchsorted(htt.sort(xv)[0], xv[:1000]), htt.percentile(xv, [1, 99]),
                        htt.unique_counts(xw)[1], htt.partition(x, 3, 1)])
            out.extend([htt.reshape(x, (2048, 128)), htt.concatenate([x, x]), htt.roll(x, 17, 0), htt.pad(x, 2),
                        htt.flip(x, 0), htt.take(x, [5, 0, 4095], axis=0), htt.repeat(x, 2, 0), htt.tile(x, (2, 1)),
                        htt.diagonal(x), htt.stack([x, x]), htt.unfold(x, 0, 3), htt.squeeze(x[:1])])
            out.extend([htt.einsum("ij,ik->jk", x, x), htt.kron(x[:8, :8], x[:4, :4]), htt.linalg.det(x[:64]),
                        htt.linalg.inv(x[:64]), htt.linalg.tensordot(x, x, ([0], [0])),
                        htt.linalg.einsum("ij,jk->ik", htt.array(w[:64].reshape(8, 8), split=0),
                                          htt.array(w[:64].reshape(8, 8)))])

    copies = _device_to_host_copies(run, tmp_path)
    assert all(c <= 4096 for c in copies), sorted(copies)[-5:]
    for r in out:
        assert r.larray.is_cuda, r.shape
    values, indices = htt.sort(xv)
    want = torch.sort(v, stable=True)
    assert torch.equal(values.larray, want.values) and torch.equal(indices.larray.long(), want.indices)
    assert torch.equal(htt.unique(xw).larray, torch.unique(w))
    ie = htt.linalg.einsum("ij,jk->ik", htt.array(w[:64].reshape(8, 8)), htt.array(w[:64].reshape(8, 8)))
    wi = w[:64].reshape(8, 8).cpu().long()
    assert ie.larray.is_cuda and ie.larray.dtype == torch.int32 and torch.equal(ie.larray.cpu().long(), wi @ wi)


def _tiled_rank(rank, store):
    import heat_tpu_torch as ht

    ht.core.bootstrap.init_distributed(f"file://{store}", world_size=2, rank=rank, backend="gloo", timeout_s=60)
    try:
        ht.use_device("gpu")
        comm = ht.core.communication.get_comm()
        g = torch.Generator(device="cuda").manual_seed(11)
        a = torch.randn(8, 12, 30, generator=g, device="cuda")
        for src, dst in ((0, 1), (0, None), (None, 0), (1, 2)):
            comm.reset_traffic()
            mono = ht.array(a, split=src).resplit(dst, memory_budget=0)
            mono_bytes = {k: v["bytes"] for k, v in comm.traffic().items()}
            comm.reset_traffic()
            tiled = ht.array(a, split=src).resplit(dst, memory_budget=2000)
            assert {k: v["bytes"] for k, v in comm.traffic().items()} == mono_bytes, (src, dst)
            inplace = ht.array(a, split=src).resplit_(dst, memory_budget="2K")
            for t in (tiled, inplace):
                assert t.larray.is_cuda and t.split == dst and torch.equal(t.larray, mono.larray), (src, dst)
        x = ht.array(torch.randn(301, 6, generator=g, device="cuda"), split=0)
        init = x.larray[:4].clone() if rank == 0 else torch.empty(4, 6, device="cuda")
        comm.Bcast(init)
        for est in (ht.cluster.KMedians(4, init=init, max_iter=3), ht.cluster.KMedoids(4, init=init, max_iter=3),
                    ht.cluster.BatchParallelKMeans(4, max_iter=3)):
            est.fit(x)
            assert est.labels_.larray.is_cuda and est.cluster_centers_.larray.is_cuda
        torch.distributed.barrier()
    finally:
        ht.core.bootstrap.finalize_distributed()


def test_cuda_estimators_and_tiled_resplit_stay_on_the_card(tmp_path):
    """The slice's estimators on CUDA arrays at world size 1: every fitted
    attribute and result a CUDA tensor; the k-clusterers' E-steps are the
    kernels, never their plain versions (patched to raise): KMedians and
    KMedoids launch ``assign`` once an iteration and once for the labels and
    ``em_stats`` never, BatchParallelKMeans and Spectral launch
    ``em_stats``.  Then two gloo ranks on the card: the tiled resplit bit for
    bit the monolithic one with its bytes, and the k-clusterers' fits."""
    from unittest import mock

    def refuse(*args, **kwargs):
        raise AssertionError("a plain version ran on a CUDA tensor")

    g = torch.Generator(device="cuda").manual_seed(5)
    means = torch.rand(4, 8, generator=g, device="cuda") * 40 - 20
    lab = torch.randint(0, 4, (20000,), generator=g, device="cuda")
    X = means[lab] + torch.randn(20000, 8, generator=g, device="cuda")
    x = htt.array(X, split=0)
    y = htt.array(lab.to(torch.int32), split=0)
    init = X[:4].clone()
    with mock.patch.object(kk, "_torch_assign", refuse), mock.patch.object(kk, "_torch_em_stats", refuse):
        for name in ("KMedians", "KMedoids"):
            kk.launch_counts.update(assign=0, em_stats=0)
            est = getattr(htt.cluster, name)(4, init=init, max_iter=6).fit(x)
            assert kk.launch_counts == {"assign": est.n_iter_ + 1, "em_stats": 0}, (name, kk.launch_counts)
            assert est.cluster_centers_.larray.is_cuda and est.labels_.larray.is_cuda
            assert est.predict(x).larray.is_cuda
        for name in ("BatchParallelKMeans", "BatchParallelKMedians"):
            kk.launch_counts.update(assign=0, em_stats=0)
            est = getattr(htt.cluster, name)(4, random_state=1).fit(x)
            assert kk.launch_counts["assign"] >= 1 and (kk.launch_counts["em_stats"] >= 1) == (name.endswith("Means"))
            assert est.cluster_centers_.larray.is_cuda and est.labels_.larray.is_cuda
        kk.launch_counts.update(assign=0, em_stats=0)
        sp = htt.cluster.Spectral(4, gamma=0.005, n_lanczos=60).fit(htt.array(X[:600], split=0))
        assert kk.launch_counts["em_stats"] >= 1 and kk.launch_counts["assign"] >= 1
        assert sp.labels_.larray.is_cuda
    T = torch.randn(4000, 32, generator=g, device="cuda")
    t = htt.array(T, split=0)
    outs = []
    for solver in ("full", "hierarchical", "randomized"):
        p = htt.decomposition.PCA(4, svd_solver=solver).fit(t)
        outs += [p.components_, p.singular_values_, p.transform(t)]
    ip = htt.decomposition.IncrementalPCA(4, batch_size=1000).fit(t)
    outs += [ip.components_, ip.transform(t)]
    dmd = htt.decomposition.DMD(svd_rank=4).fit(htt.array(T[:, :20], split=0))
    outs += [dmd.rom_eigenvalues_, dmd.predict(htt.array(T[:, 0], split=0), 2), dmd.predict_next(htt.array(
        T[:, :2], split=0))]
    lasso = htt.regression.Lasso(lam=0.01).fit(t, htt.array(T[:, 0] * 2 + 1, split=0))
    outs += [lasso.theta, lasso.predict(t)]
    nb = htt.naive_bayes.GaussianNB().fit(x, y)
    outs += [nb.theta_, nb.var_, nb.predict(x), nb.predict_proba(x)]
    knn = htt.classification.KNeighborsClassifier(3).fit(x, y)
    outs.append(knn.predict(htt.array(X[:100], split=0)))
    for kind in ("StandardScaler", "MinMaxScaler", "MaxAbsScaler", "RobustScaler", "Normalizer"):
        s = getattr(htt.preprocessing, kind)().fit(x)
        outs.append(s.transform(x))
    outs.append(htt.graph.Laplacian(lambda v: htt.spatial.rbf(v, sigma=4.0)).construct(htt.array(X[:300], split=0)))
    for r in outs:
        assert r.larray.is_cuda, r.shape
    assert torch.equal(nb.predict(x).larray, lab.to(torch.int32))
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_tiled_rank, args=(r, str(tmp_path / "store"))) for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=180)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(5)
    assert [p.exitcode for p in procs] == [0, 0]


def test_cuda_convolve_is_ieee_float32_and_integers_take_the_exact_route():
    """convolve on CUDA tensors: IEEE float32 products (within float32
    rounding of the float64 result, where TF32's 10-bit products would lie
    ~1e-3 off), even under the caller's TF32 setting, which it restores;
    an integer convolution exact (the float64 route) and refused past
    2^53; the result on the card."""
    g = torch.Generator(device="cuda").manual_seed(16)
    a = torch.randn(200_000, generator=g, device="cuda")
    v = torch.randn(511, generator=g, device="cuda")
    want = torch.nn.functional.conv1d(a.double()[None, None], v.double().flip(0)[None, None], padding=510)[0, 0]
    prev = torch.backends.cudnn.conv.fp32_precision
    torch.backends.cudnn.conv.fp32_precision = "tf32"
    try:
        got = htt.convolve(htt.array(a, split=0), htt.array(v), mode="full")
        assert torch.backends.cudnn.conv.fp32_precision == "tf32"
    finally:
        torch.backends.cudnn.conv.fp32_precision = prev
    assert got.larray.is_cuda and got.dtype is htt.float32
    err = float((got.larray.double() - want).abs().max() / want.abs().max())
    assert err < 1e-5, err
    ai = torch.randint(-100, 100, (5000,), generator=g, device="cuda", dtype=torch.int32)
    vi = torch.randint(-9, 9, (33,), generator=g, device="cuda", dtype=torch.int32)
    res = htt.convolve(htt.array(ai, split=0), htt.array(vi), mode="same")
    want_i = np.convolve(ai.cpu().numpy().astype(np.int64), vi.cpu().numpy().astype(np.int64), mode="same")
    assert res.larray.is_cuda and res.dtype is htt.int32
    np.testing.assert_array_equal(res.larray.cpu().numpy(), want_i)
    big = htt.array(torch.full((64,), 2**30, dtype=torch.int64, device="cuda"))
    with pytest.raises(ValueError, match="2\\^53"):
        htt.convolve(big, htt.array(torch.full((9,), 2**22, dtype=torch.int64, device="cuda")))


def test_cuda_fft_and_sparse_matmul_stay_on_the_card():
    """fft and the sparse product of CUDA arrays compute on the card (the
    host copy of a tensor patched to raise while they run); an integer
    sparse product is exact through float64 and refused past 2^53."""
    from unittest import mock

    g = torch.Generator(device="cuda").manual_seed(17)
    x = htt.array(torch.randn(512, 256, generator=g, device="cuda"), split=0)
    dense = torch.randn(300, 8, generator=g, device="cuda")
    csr = (torch.rand(400, 300, generator=g, device="cuda") < 0.05).float() * torch.randn(
        400, 300, generator=g, device="cuda")
    s = htt.sparse.sparse_csr_matrix(csr.to_sparse_csr(), split=0)

    def refuse(self, *args, **kwargs):
        raise AssertionError("a CUDA tensor was copied to the host")

    with mock.patch.object(torch.Tensor, "cpu", refuse), mock.patch.object(torch.Tensor, "numpy", refuse):
        outs = [htt.fft.fft2(x), htt.fft.rfft(x, axis=0), htt.fft.ifftn(x), htt.fft.fftshift(x),
                s @ htt.array(dense), htt.sparse.add(s, s).todense()]
    for r in outs:
        assert r.larray.is_cuda
    torch.testing.assert_close(outs[0].larray, torch.fft.fft2(x.larray))
    torch.testing.assert_close(outs[4].larray, csr @ dense, rtol=1e-5, atol=1e-5)
    si = htt.sparse.sparse_csr_matrix((csr != 0).to(torch.int32).to_sparse_csr())
    di = torch.randint(-50, 50, (300, 8), generator=g, device="cuda", dtype=torch.int32)
    got = si @ htt.array(di)
    assert got.larray.is_cuda and got.dtype is htt.int32
    torch.testing.assert_close(got.larray, ((csr != 0).double() @ di.double()).to(torch.int32))
    huge = htt.sparse.sparse_csr_matrix(torch.full((2, 3), 2**30, dtype=torch.int64, device="cuda"))
    with pytest.raises(ValueError, match="2\\^53"):
        huge @ htt.array(torch.full((3, 2), 2**22, dtype=torch.int64, device="cuda"))


def test_cuda_supports_hdf5_is_false_only_without_h5py():
    """``supports_hdf5()`` answers whether ``import h5py`` succeeds, and
    nothing else (the card's machine has no h5py)."""
    try:
        import h5py  # noqa: F401

        have = True
    except ImportError:
        have = False
    assert htt.supports_hdf5() is have
    assert htt.supports_netcdf() is (have or importlib.util.find_spec("netCDF4") is not None)


def test_cuda_io_round_trips_keep_the_card(tmp_path):
    """Files written from CUDA arrays load back onto the card bit for bit."""
    g = torch.Generator(device="cuda").manual_seed(18)
    x = htt.array(torch.randn(1001, 7, generator=g, device="cuda"), split=0)
    for name in ("a.npy", "a.csv", "a.zarr"):
        htt.save(x, str(tmp_path / name))
        y = htt.load(str(tmp_path / name), split=0)
        assert y.larray.is_cuda and torch.equal(y.larray, x.larray), name
    htt.save_array_checkpoint(x, str(tmp_path / "ck"))
    y = htt.load_array_checkpoint(str(tmp_path / "ck"))
    assert y.larray.is_cuda and torch.equal(y.larray, x.larray)


def _moe_rank(rank, store):
    """One of 2 gloo ranks on cuda:0: MoE(comm=) with its experts sharded,
    forward and backward with the host copy of a tensor refused; the
    Alltoall buffers, the scatter and the gather stay on the card."""
    from unittest import mock

    import heat_tpu_torch as ht

    ht.core.bootstrap.init_distributed(f"file://{store}", world_size=2, rank=rank, backend="gloo", timeout_s=60)
    try:
        ht.use_device("gpu")
        comm = ht.core.communication.get_comm()
        torch.manual_seed(0)
        moe = ht.nn.MoE(32, 4, hidden_dim=64, top_k=2, capacity_factor=1.0, comm=comm)
        assert moe.sharded and moe.w1.is_cuda and moe.w1.shape[0] == 2
        x = torch.randn(37 + rank, 32, device="cuda", requires_grad=True)
        seen = []
        real = comm.Alltoall

        def watched(t, *args, **kw):
            out = real(t, *args, **kw)
            seen.append((t.is_cuda, out.is_cuda))
            return out

        def refuse(self, *args, **kwargs):
            raise AssertionError("a CUDA tensor was copied to the host")

        with mock.patch.object(comm, "Alltoall", watched), mock.patch.object(torch.Tensor, "numpy", refuse):
            y = moe(x)
            y.square().sum().backward()
        assert seen and all(a and b for a, b in seen), seen
        assert y.is_cuda and x.grad.is_cuda and moe.route_stats.is_cuda and moe.aux_loss.is_cuda
        assert all(p.grad.is_cuda for p in moe.parameters())
        torch.distributed.barrier()
    finally:
        ht.core.bootstrap.finalize_distributed()


def test_cuda_moe_buffers_stay_on_the_card(tmp_path):
    """MoE on the card: at world size 1 the routing, the (E, C, D) scatter
    and the gather compute on CUDA tensors with the host copy refused; on 2
    gloo ranks of the card the expert-parallel Alltoalls take and give CUDA
    tensors (gloo's all_to_all on the card), forward and backward."""
    from unittest import mock

    def refuse(self, *args, **kwargs):
        raise AssertionError("a CUDA tensor was copied to the host")

    torch.manual_seed(0)
    moe = htt.nn.MoE(32, 4, hidden_dim=64, top_k=2, capacity_factor=0.5)
    x = torch.randn(64, 32, device="cuda", requires_grad=True)
    with mock.patch.object(torch.Tensor, "cpu", refuse), mock.patch.object(torch.Tensor, "numpy", refuse):
        y = moe(x)
        y.sum().backward()
        dec = moe.decode_apply(x.detach())
    assert y.is_cuda and dec.is_cuda and x.grad.is_cuda and all(p.grad.is_cuda for p in moe.parameters())
    assert int(moe.route_stats[0]) > 0  # capacity binds: claims were dropped
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_moe_rank, args=(r, str(tmp_path / "store"))) for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=180)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(5)
    assert [p.exitcode for p in procs] == [0, 0]


@pytest.mark.parametrize("kind", ["LSTM", "GRU", "Conv3d"])
def test_cuda_recurrent_and_conv3d_are_ieee_float32(kind):
    """LSTM, GRU and Conv3d on CUDA tensors under ``_full_float32`` equal
    float64 within float32 rounding (TF32's 10-bit products would lie ~1e-3
    off), forward and backward (the module in evaluation), even where the
    caller asked for TF32; the caller's settings come back."""
    from heat_tpu_torch.linalg.basics import _full_float32

    torch.manual_seed(3)
    if kind == "Conv3d":
        m = htt.nn.Conv3d(8, 16, 3)
        x = torch.randn(2, 8, 12, 16, 16, device="cuda")
    else:
        m = getattr(htt.nn, kind)(64, 128, num_layers=2)
        x = torch.randn(8, 40, 64, device="cuda")
    m64 = getattr(htt.nn, kind)(*((8, 16, 3) if kind == "Conv3d" else (64, 128)),
                                **({} if kind == "Conv3d" else {"num_layers": 2})).double()
    m64.load_state_dict({k: v.double() for k, v in m.state_dict().items()})
    m.eval()  # differentiable in evaluation too (cuDNN's RNN backward needs a training-flagged forward)
    flags = [torch.backends.cudnn.conv, torch.backends.cudnn.rnn, torch.backends.cuda.matmul]
    prev = [f.fp32_precision for f in flags]
    for f in flags:
        f.fp32_precision = "tf32"
    try:
        with _full_float32():
            y = m(x.requires_grad_(True))
            y = y[0] if isinstance(y, tuple) else y
            y.square().sum().backward()
        assert [f.fp32_precision for f in flags] == ["tf32"] * 3
    finally:
        for f, p in zip(flags, prev):
            f.fp32_precision = p
    x64 = x.detach().double().requires_grad_(True)
    y64 = m64(x64)
    y64 = y64[0] if isinstance(y64, tuple) else y64
    y64.square().sum().backward()
    assert y.is_cuda and x.grad.is_cuda
    for got, want in [(y, y64), (x.grad, x64.grad)] + [(p.grad, q.grad) for p, q in zip(m.parameters(),
                                                                                     m64.parameters())]:
        err = float((got.double() - want).abs().max() / want.abs().max())
        assert err < 1e-5, (kind, err)


def test_cuda_seq2seq_forward_launches_the_flash_forward():
    """Seq2SeqTransformer's forward at equal source and target lengths runs
    the flash forward for every encoder block, every decoder
    self-attention and every cross-attention, and never the plain version
    or the dense path (both patched to raise); its logits are on the card."""
    from unittest import mock

    torch.manual_seed(0)
    m = htt.nn.models.Seq2SeqTransformer(101, 103, 64, 4, enc_depth=2, dec_depth=3, max_len=128).eval()
    src = torch.randint(0, 101, (2, 96), device="cuda")
    tgt = torch.randint(0, 103, (2, 96), device="cuda")

    def refuse(*args, **kwargs):
        raise AssertionError("the plain attention ran")

    before = dict(fa.launch_counts)
    with mock.patch.object(fa, "_torch_flash_fwd", refuse), \
            mock.patch.object(htt.nn.attention, "_dense_attention", refuse), torch.no_grad():
        logits = m(src, tgt)
    launched = {k: fa.launch_counts[k] - before[k] for k in before}
    assert logits.is_cuda and logits.shape == (2, 96, 103)
    assert launched["flash_fwd"] == 2 + 3 + 3, launched
    assert sum(launched.values()) == launched["flash_fwd"], launched


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [129, 200, 256, 512])
def test_cuda_kmeans_streamed_route_matches_plain_versions(d, dtype):
    """Past 128 columns both kernels take the streamed route (R6): each
    against its plain version with chip_smoke.py's checks, em_stats' counts
    those of assign's labels, both the same bits twice, one launch each."""
    name = str(dtype).replace("torch.", "")
    x, c = _CHIP_SMOKE.em_edge_inputs(6001, 37, d, name, "shuffled", seed=d)
    assert kk.launch_config(37, d, dtype)["route"] == kk.launch_config(37, d, dtype, em=True)["route"] == "streamed"
    before = dict(kk.launch_counts)
    lab, d2 = kk.fused_assign(x, c)
    sums, counts = kk.fused_em_stats(x, c, 5999)
    assert {key: kk.launch_counts[key] - before[key] for key in before} == {"assign": 1, "em_stats": 1}
    lab_p, d2_p = kk._torch_assign(x, c)
    _CHIP_SMOKE.compare_assign(x, c, lab, d2, lab_p, d2_p)
    sums_p, counts_p = kk._torch_em_stats(x, c, 5999)
    _CHIP_SMOKE.compare_em(x, c, 5999, sums, counts, lab, sums_p, counts_p, int((lab[:5999] != lab_p[:5999]).sum()))
    again = kk.fused_em_stats(x, c, 5999)
    assert torch.equal(again[0], sums) and torch.equal(again[1], counts)


def test_cuda_estimators_fit_d256():
    """KMedians, KMedoids, the batch-parallel fits and Spectral fit 256-column
    data on the card through the kernels (they raised past d = 128 before
    R6); started at the blobs, KMedians and KMedoids recover them."""
    g = torch.Generator(device="cuda").manual_seed(11)
    means = torch.randn(4, 256, generator=g, device="cuda") * 8
    lab = torch.randint(0, 4, (4000,), generator=g, device="cuda")
    X = means[lab] + 0.5 * torch.randn(4000, 256, generator=g, device="cuda")
    x = htt.array(X, split=0)
    init = means + 0.1
    for name in ("KMedians", "KMedoids", "BatchParallelKMeans", "BatchParallelKMedians"):
        before = dict(kk.launch_counts)
        kw = {"init": init, "max_iter": 6} if name in ("KMedians", "KMedoids") else {"random_state": 1}
        est = getattr(htt.cluster, name)(4, **kw).fit(x)
        assert kk.launch_counts["assign"] > before["assign"], name
        assert est.cluster_centers_.larray.is_cuda and est.cluster_centers_.shape == (4, 256)
        got = est.predict(x).larray.long()
        assert got.is_cuda and int(got.min()) >= 0 and int(got.max()) < 4
        if "init" in kw:  # started at the blobs: each blob one label, the generating partition
            assert torch.unique(torch.stack([lab, got]), dim=1).shape[1] == 4, name
    before = dict(kk.launch_counts)
    sp = htt.cluster.Spectral(4, gamma=1e-4, n_lanczos=60).fit(htt.array(X[:600], split=0))
    assert kk.launch_counts["em_stats"] > before["em_stats"] and sp.labels_.larray.is_cuda


FLASH_WIDE_CASES = [(kind, d, causal) for kind in ("mha", "gqa", "pos") for d in (96, 160, 256)
                    for causal in (True, False)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind,d,causal", FLASH_WIDE_CASES)
def test_cuda_flash_head_dims_past_128(kind, d, causal, dtype):
    """Every body (forward, dq, dk/dv) under both masks (the static one for
    multi-head and grouped attention, the positions one for a ring block)
    at d = 96, 160 and 256 (R5: 160 and 256 raised before), against the
    plain versions with the tolerances above, one launch each."""
    g = torch.Generator(device="cuda").manual_seed(d + causal)
    S, scale = 300, d**-0.5
    if kind == "pos":
        q, k, v, do = (torch.randn((4, S, d), generator=g, device="cuda").to(dtype) for _ in range(4))
        qpos = torch.arange(S, 2 * S, dtype=torch.int32, device="cuda")
        kpos = torch.arange(S, 2 * S, dtype=torch.int32, device="cuda") - (0 if causal else S)
        extra = (qpos, kpos)
        tail = (scale, 2 * S, True)
        names = ("flash_pos_fwd", "flash_pos_bwd_dq", "flash_pos_bwd_dkv")
    else:
        hk = 2 if kind == "gqa" else 8
        q, do = (torch.randn((8, S, d), generator=g, device="cuda").to(dtype) for _ in range(2))
        k, v = (torch.randn((hk, S, d), generator=g, device="cuda").to(dtype) for _ in range(2))
        extra, tail = (), (scale,)
        names = ("flash_gqa_fwd", "flash_gqa_bwd_dq", "flash_gqa_bwd_dkv") if kind == "gqa" else (
            "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    fwd, bdq, bdkv = (getattr(fa, n) for n in names)
    fwd_p, bdq_p, bdkv_p = (getattr(fa, f"_torch_{n}") for n in names)
    before = dict(fa.launch_counts)
    out, lse = fwd(q, k, v, *extra, causal, *tail)
    dd = (do.float() * out.float()).sum(-1)
    dq = bdq(q, k, v, do, lse, dd, *extra, causal, *tail)
    dk, dv = bdkv(q, k, v, do, lse, dd, *extra, causal, *tail)
    torch.cuda.synchronize()
    assert {n: fa.launch_counts[n] - before[n] for n in names} == dict.fromkeys(names, 1)
    out_p, lse_p = fwd_p(q, k, v, *extra, causal, *tail)
    dq_p = bdq_p(q, k, v, do, lse, dd, *extra, causal, *tail)
    dk_p, dv_p = bdkv_p(q, k, v, do, lse, dd, *extra, causal, *tail)
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(lse, lse_p, atol=2e-5, rtol=2e-5)
    for got, want, what in ((out, out_p, "out"), (dq, dq_p, "grad"), (dk, dk_p, "grad"), (dv, dv_p, "grad")):
        assert row_err(got, want) <= tol[what], what
        if dtype == torch.bfloat16:
            assert float((got != want).float().mean()) <= 0.01, what
