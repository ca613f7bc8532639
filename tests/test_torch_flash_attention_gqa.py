"""The port's grouped-query flash attention against heat_tpu's Pallas GQA kernels.

``flash_attention_gqa`` takes q ``(B, H_q, S, d)`` and k, v ``(B, H_kv, S, d)``;
on the CPU the port runs the grouped wrappers' plain versions
(``_torch_flash_gqa_*``: K/V repeated per group, dk and dv summed over the
group in float32 and rounded once), through the same
``torch.autograd.Function`` that launches the kernels on the card.  The
reference runs ``_flash_gqa_fwd_impl``/``_flash_gqa_bwd_impl`` in interpret
mode, as its own tests do (every S here is <= 512, so ``_pallas_gate`` takes
the kernel), and its ``path_counts["pallas"]`` must rise.  The same numpy
inputs (standard normal q, k, v and a cotangent w, batch 2) go to both.

The cases cover S in {1, 5, 128, 300}, d in {8, 64}, (H_q, H_kv) in
{(4, 2), (4, 1), (8, 2)}, causal and full, float32 and bfloat16: every
(S, heads) pair in both dtypes, with d and causal cycling through their
values, so that each dtype sees every (d, causal) pair.  (The full product,
96 cases at 1-2 s of interpret mode each, would add minutes to the suite.)

Tolerances are those of ``test_torch_flash_attention.py``, by ``row_err``:
float32 2e-5 on out and 2e-4 on dq, dk, dv, lse atol and rtol 2e-5; bfloat16
2^-6 (one rounding step of 2^-7, and a P or dS that rounds one step apart
where the float32 scores differ in the last bits).  dk and dv in bfloat16
round once after the group sum on both sides, as the reference's one
float32 scratch per K/V head does.  The plain forward runs at the
reference's key tile (``KEY_TILE``), so P rounds at the same running
maximum on both sides.
"""

import importlib
import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from heat_tpu_torch.ops import flash_attention as fa
from test_torch_cuda_kernels import row_err

ref = importlib.import_module("heat_tpu.ops.flash_attention")

SEQ = [1, 5, 128, 300]
DIMS = [8, 64]
HEADS = [(4, 2), (4, 1), (8, 2)]
B = 2
TOL = {"float32": dict(out=2e-5, grad=2e-4), "bfloat16": dict(out=2.0**-6, grad=2.0**-6)}
LSE_TOL = 2e-5
CASES = [(S, DIMS[i % 2], hq, hk, bool(i // 2 % 2), dtype)
         for i, (S, (hq, hk)) in enumerate(itertools.product(SEQ, HEADS)) for dtype in ("float32", "bfloat16")]


def _inputs(S, d, hq, hk, dtype, seed):
    """q, w (B, hq, S, d) and k, v (B, hk, S, d) for each side."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((B, h, S, d)).astype(np.float32) for h in (hq, hk, hk, hq)]
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32, torch.float32)
    return [jnp.asarray(a, dtype=jdt) for a in arrs], [torch.from_numpy(a).to(tdt) for a in arrs]


def _close(got: torch.Tensor, want, tol, what):
    err = row_err(got.detach(), torch.from_numpy(np.array(jnp.asarray(want, jnp.float32))))
    assert err <= tol, f"{what}: rows differ by {err} of their largest value (limit {tol})"


@pytest.mark.parametrize("S,d,hq,hk,causal,dtype", CASES)
def test_gqa_matches_reference_kernel(S, d, hq, hk, causal, dtype, monkeypatch):
    (jq, jk, jv, jw), (tq, tk, tv, tw) = _inputs(S, d, hq, hk, dtype, seed=S * 7 + d + hq * 3 + hk)
    tol = TOL[dtype]
    blk = min(512, -(-S // 128) * 128)  # the reference's tile (_blocks), >= S here
    monkeypatch.setattr(fa, "KEY_TILE", blk)
    before = ref.path_counts["pallas"]
    out_r, vjp = jax.vjp(lambda q, k, v: ref.flash_attention_gqa(q, k, v, causal=causal), jq, jk, jv)
    grads_r = vjp(jw.astype(out_r.dtype))
    assert ref.path_counts["pallas"] > before  # the reference ran its Pallas GQA kernels, not its dense path

    counts = dict(fa.launch_counts)
    q, k, v = (t.clone().requires_grad_(True) for t in (tq, tk, tv))
    out = fa.flash_attention_gqa(q, k, v, causal=causal)
    out.backward(tw)
    assert fa.launch_counts == counts  # CPU tensors never launch a kernel
    assert out.shape == tq.shape and out.dtype == tq.dtype
    assert k.grad.shape == tk.shape and v.grad.shape == tv.shape
    _close(out, out_r, tol["out"], "out")
    for g, g_r, name in zip((q.grad, k.grad, v.grad), grads_r, ("dq", "dk", "dv")):
        assert g.dtype == tq.dtype
        _close(g, g_r, tol["grad"], name)

    # lse: the reference GQA kernel's second output, on its padded inputs
    Sp = -(-S // blk) * blk
    flat = [a.reshape(-1, S, d) for a in (jq, jk, jv)]
    padded = [jnp.pad(a, ((0, 0), (0, Sp - S), (0, 0))) for a in flat]
    _, lse_r = ref._flash_gqa_fwd_impl(*padded, causal, 1.0 / d**0.5, S, hq, hk, True)
    _, lse = fa.flash_gqa_fwd(*(t.reshape(-1, S, d) for t in (tq, tk, tv)), causal, 1.0 / d**0.5)
    assert lse.dtype == torch.float32 and lse.shape == (B * hq, S)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_r[:, :S]), atol=LSE_TOL, rtol=LSE_TOL, err_msg="lse")


@pytest.mark.parametrize("causal", [False, True])
def test_gqa_plain_versions_are_the_gradient_of_dense_attention(causal):
    """The grouped plain versions against autograd through the dense path
    over K/V repeated per group: dk, dv are the group sums of the repeated
    K/V's gradients."""
    rng = np.random.default_rng(3)
    q, w = (torch.from_numpy(rng.standard_normal((12, 77, 16)).astype(np.float32)) for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((3, 77, 16)).astype(np.float32)) for _ in range(2))
    out, lse = fa._torch_flash_gqa_fwd(q, k, v, causal, 0.25)
    dd = (w * out).sum(-1)
    dq = fa._torch_flash_gqa_bwd_dq(q, k, v, w, lse, dd, causal, 0.25)
    dk, dv = fa._torch_flash_gqa_bwd_dkv(q, k, v, w, lse, dd, causal, 0.25)
    leaves = [q.clone().requires_grad_(True)] + [t.repeat_interleave(4, 0).requires_grad_(True) for t in (k, v)]
    dense = fa._dense_attention(*leaves, causal, 0.25, 77)
    torch.testing.assert_close(out, dense, atol=1e-5, rtol=1e-5)
    dense.backward(w)
    torch.testing.assert_close(dq, leaves[0].grad, atol=1e-4, rtol=1e-4)
    for got, leaf in zip((dk, dv), leaves[1:]):
        torch.testing.assert_close(got, leaf.grad.unflatten(0, (3, 4)).sum(1), atol=1e-4, rtol=1e-4)


def test_gqa_dkv_rounds_once_after_the_group_sum():
    """bfloat16 dk, dv: the group's float32 sum rounded once, not a sum of
    per-head bfloat16 gradients (which rounds g times)."""
    rng = np.random.default_rng(4)
    q, w = (torch.from_numpy(rng.standard_normal((8, 40, 8)).astype(np.float32)).to(torch.bfloat16)
            for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((1, 40, 8)).astype(np.float32)).to(torch.bfloat16)
            for _ in range(2))
    out, lse = fa._torch_flash_gqa_fwd(q, k, v, True, 0.3)
    dd = (w.float() * out.float()).sum(-1)
    dk, dv = fa._torch_flash_gqa_bwd_dkv(q, k, v, w, lse, dd, True, 0.3)
    kr, vr = (t.repeat_interleave(8, 0) for t in (k, v))
    dk32, dv32 = fa._torch_dkv_f32(q, kr, vr, w, lse, dd, True, 0.3)
    assert torch.equal(dk, dk32.sum(0, keepdim=True).to(torch.bfloat16))
    assert torch.equal(dv, dv32.sum(0, keepdim=True).to(torch.bfloat16))
    per_head = fa._torch_flash_bwd_dkv(q, kr, vr, w, lse, dd, True, 0.3)[0]
    assert not torch.equal(dk, per_head.sum(0, keepdim=True, dtype=torch.bfloat16))


@pytest.mark.parametrize(
    "q_shape,kv_shape",
    [((2, 4, 8), (3, 4, 8)),  # K/V rows do not divide the query rows
     ((2, 4, 8), (2, 5, 8)),  # another S
     ((2, 4, 8), (1, 4, 7))],  # another d
)
def test_gqa_wrapper_argument_checks(q_shape, kv_shape):
    q, kv = torch.zeros(q_shape), torch.zeros(kv_shape)
    with pytest.raises(ValueError):
        fa.flash_gqa_fwd(q, kv, kv, False, 1.0)
    with pytest.raises(ValueError):  # the multi-head wrapper takes one shape only
        fa.flash_fwd(torch.zeros(4, 4, 8), torch.zeros(2, 4, 8), torch.zeros(2, 4, 8), False, 1.0)


def test_flash_attention_gqa_shape_checks_and_delegation():
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.standard_normal((2, 4, 10, 8)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 2, 10, 8)).astype(np.float32))
    with pytest.raises(ValueError):
        fa.flash_attention_gqa(q, k, k[..., :9, :])  # k and v differ
    with pytest.raises(ValueError):
        fa.flash_attention_gqa(q, k[:1], k[:1])  # leading axes differ
    with pytest.raises(ValueError):
        fa.flash_attention_gqa(q[:, :3], k, k)  # 3 query heads on 2 K/V heads
    with pytest.raises(ValueError):
        fa.flash_attention_gqa(q[0, 0], k[0, 0], k[0, 0])  # no head axis
    want = fa._dense_attention(q, k.repeat_interleave(2, 1), k.repeat_interleave(2, 1), True, 8**-0.5, 10)
    torch.testing.assert_close(fa.flash_attention_gqa(q, k, k, causal=True), want, atol=1e-5, rtol=1e-5)
    # equal head counts are flash_attention
    torch.testing.assert_close(fa.flash_attention_gqa(q, q, q, scale=0.2), fa.flash_attention(q, q, q, scale=0.2))
