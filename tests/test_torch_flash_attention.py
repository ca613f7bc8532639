"""The port's flash attention against heat_tpu's Pallas flash kernels.

On the CPU the port's wrappers run their plain PyTorch versions, through
the same ``torch.autograd.Function`` that launches the kernels on the card.
The reference runs its Pallas kernels in interpret mode, as its own tests
do: every S here is <= 512, so ``_pallas_gate`` takes the kernel, forward
and custom-VJP backward, and not its dense path.  The same numpy inputs
(standard normal q, k, v, and a cotangent w) go to both, at leading axes
(2, 3).

The plain forward carries the online softmax's running maximum over key
tiles as the kernels do, 64 keys a tile on the card.  The reference's
tile is the padded S here (at most 512, one tile), so the comparison runs
the plain forward at the reference's tile: P then rounds at the same
running maximum on both sides.  (At 64-key tiles bfloat16 P rounds at
other values than the reference's, and rows differ by up to ~2^-6.)

Tolerances, by ``row_err`` (each row's largest error over that row's
largest value; see ``test_torch_cuda_kernels.py``):
- float32: 2e-5 on out, 2e-4 on dq, dk, dv; lse atol and rtol 2e-5.  Both
  sides compute in float32 and differ by sum order: a few float32 ulps of
  each term, summed over up to 512 keys (<= 1.3e-5 here).  At S = 1, dq
  cancels to 0 exactly (dS = p(dp - dd) with dd = dp), and what remains is
  the float32 rounding of dp - dd, ~9e-7 at d = 64: 1.1e-4 of the row
  floor 2^-7.
- bfloat16: 2^-6 on out, dq, dk, dv; lse stays float32 and keeps 2e-5.
  Results round to bfloat16, whose step is at most 2^-7 of a value; where
  the two sides' float32 scores differ in the last bits a P or dS may
  round one step apart too, and the backward's dd = rowsum(dO * O) takes
  an O that may differ by one step.  Measured over this grid: <= 7.1e-3.
The kernels themselves run on the card: ``test_torch_cuda_kernels.py``.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from heat_tpu_torch.ops import flash_attention as fa
from test_torch_cuda_kernels import row_err

ref = importlib.import_module("heat_tpu.ops.flash_attention")

SEQ = [1, 5, 128, 300, 512]
DIMS = [8, 64]
LEAD = (2, 3)
TOL = {"float32": dict(out=2e-5, grad=2e-4), "bfloat16": dict(out=2.0**-6, grad=2.0**-6)}
LSE_TOL = 2e-5


def _inputs(S, d, dtype, seed=0):
    """q, k, v, w as numpy float32 holding the values both sides see, and each side's arrays."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(LEAD + (S, d)).astype(np.float32) for _ in range(4)]
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32, torch.float32)
    jx = [jnp.asarray(a, dtype=jdt) for a in arrs]
    tx = [torch.from_numpy(a).to(tdt) for a in arrs]
    return jx, tx


def _close(got: torch.Tensor, want, tol, what):
    err = row_err(got.detach(), torch.from_numpy(np.asarray(jnp.asarray(want, jnp.float32))))
    assert err <= tol, f"{what}: rows differ by {err} of their largest value (limit {tol})"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("S", SEQ)
def test_flash_matches_reference_kernel(S, d, causal, dtype, monkeypatch):
    (jq, jk, jv, jw), (tq, tk, tv, tw) = _inputs(S, d, dtype, seed=S * 7 + d)
    tol = TOL[dtype]
    blk = min(512, -(-S // 128) * 128)  # the reference's tile (_blocks), >= S here
    monkeypatch.setattr(fa, "KEY_TILE", blk)
    before = ref.path_counts["pallas"]
    out_r, vjp = jax.vjp(lambda q, k, v: ref.flash_attention(q, k, v, causal=causal), jq, jk, jv)
    grads_r = vjp(jw.astype(out_r.dtype))
    assert ref.path_counts["pallas"] > before  # the reference ran its Pallas kernel, not its dense path

    counts = dict(fa.launch_counts)
    q, k, v = (t.clone().requires_grad_(True) for t in (tq, tk, tv))
    out = fa.flash_attention(q, k, v, causal=causal)
    out.backward(tw)
    assert fa.launch_counts == counts  # CPU tensors never launch a kernel
    assert out.shape == tq.shape and out.dtype == tq.dtype
    _close(out, out_r, tol["out"], "out")
    for g, g_r, name in zip((q.grad, k.grad, v.grad), grads_r, ("dq", "dk", "dv")):
        assert g.dtype == tq.dtype
        _close(g, g_r, tol["grad"], name)

    # lse: the reference kernel's second output, on its padded inputs
    Sp = -(-S // blk) * blk
    flat = [a.reshape(-1, S, d) for a in (jq, jk, jv)]
    padded = [jnp.pad(a, ((0, 0), (0, Sp - S), (0, 0))) for a in flat]
    _, lse_r = ref._flash_fwd_impl(*padded, causal, 1.0 / d**0.5, S, True)
    _, lse = fa.flash_fwd(*(t.reshape(-1, S, d) for t in (tq, tk, tv)), causal, 1.0 / d**0.5)
    assert lse.dtype == torch.float32 and lse.shape == (6, S)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_r[:, :S]), atol=LSE_TOL, rtol=LSE_TOL, err_msg="lse")


def test_plain_versions_are_the_gradient_of_dense_attention():
    """dq, dk, dv of the plain versions against autograd through the dense path."""
    rng = np.random.default_rng(3)
    q, k, v, w = (torch.from_numpy(rng.standard_normal((4, 77, 16)).astype(np.float32)) for _ in range(4))
    for causal in (False, True):
        out, lse = fa._torch_flash_fwd(q, k, v, causal, 0.25)
        dd = (w * out).sum(-1)
        dq = fa._torch_flash_bwd_dq(q, k, v, w, lse, dd, causal, 0.25)
        dk, dv = fa._torch_flash_bwd_dkv(q, k, v, w, lse, dd, causal, 0.25)
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        dense = fa._dense_attention(*leaves, causal, 0.25, 77)
        torch.testing.assert_close(out, dense, atol=1e-5, rtol=1e-5)
        dense.backward(w)
        for got, leaf in zip((dq, dk, dv), leaves):
            torch.testing.assert_close(got, leaf.grad, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("causal", [False, True])
def test_plain_forward_follows_the_online_recurrence(causal):
    """The plain forward against _online_update and _finalize run tile by
    tile, as the kernel runs them, in bfloat16.  P is the same to the bit
    (same scores, same running maximum), so the two differ by float32 sum
    order only: a result moves at most one bfloat16 step (2^-7 of it), and
    only where that order carries it across a rounding boundary, ~1e-4 of
    the elements.  Rounding P at the whole row's maximum instead moves
    5-24% of them."""
    rng = np.random.default_rng(6)
    q, k, v = (torch.from_numpy(rng.standard_normal((3, 200, 16)).astype(np.float32)).to(torch.bfloat16)
               for _ in range(3))
    out, lse = fa._torch_flash_fwd(q, k, v, causal, 0.25)
    s = fa._scores(q, k, causal, 0.25)
    m, l, acc = torch.full((3, 200), float("-inf")), torch.zeros(3, 200), torch.zeros(3, 200, 16)
    for k0 in range(0, 200, fa.KEY_TILE):
        st = s[..., k0 : k0 + fa.KEY_TILE]
        m_new = torch.maximum(m, st.amax(-1))
        safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.where(torch.isfinite(st), torch.exp(st - safe[..., None]), 0.0)
        corr = torch.where(torch.isfinite(m), torch.exp(m - safe), 0.0)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + p.to(torch.bfloat16).float() @ v[:, k0 : k0 + fa.KEY_TILE].float()
        m = m_new
    want = (acc / l.clamp_min(1e-30)[..., None]).to(torch.bfloat16)
    assert row_err(out, want) <= 2.0**-7
    assert float((out != want).float().mean()) <= 1e-3
    torch.testing.assert_close(lse, m + torch.log(l), atol=1e-5, rtol=1e-5)


def test_fully_masked_rows_give_zero_with_finite_grads():
    rng = np.random.default_rng(4)
    arrs = [rng.standard_normal((2, 6, 8)).astype(np.float32) for _ in range(3)]
    bias = np.zeros((6, 6), np.float32)
    bias[2, :] = -np.inf  # row 2 sees no key
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in arrs]
    out = fa._dense_attention(*leaves, False, 0.3, 6, bias=torch.from_numpy(bias))
    out.sum().backward()
    assert torch.equal(out[:, 2], torch.zeros(2, 8))
    assert all(bool(torch.isfinite(t.grad).all()) for t in leaves)
    want = ref._dense_attention(*(jnp.asarray(a) for a in arrs), False, 0.3, 6, bias=jnp.asarray(bias))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), atol=1e-6)


def test_dense_attention_masks_trailing_keys_and_returns_probs():
    rng = np.random.default_rng(5)
    arrs = [rng.standard_normal((3, 9, 4)).astype(np.float32) for _ in range(3)]
    for causal in (False, True):
        out, p = fa._dense_attention(*(torch.from_numpy(a) for a in arrs), causal, 0.5, 6, return_probs=True)
        out_r, p_r = ref._dense_attention(*(jnp.asarray(a) for a in arrs), causal, 0.5, 6, return_probs=True)
        np.testing.assert_allclose(out.numpy(), np.asarray(out_r), atol=1e-6)
        np.testing.assert_allclose(p.numpy(), np.asarray(p_r), atol=1e-6)
        assert float(p[..., 6:].abs().max()) == 0.0


@pytest.mark.parametrize(
    "args,exc",
    [
        ((torch.zeros(2, 4, 8), torch.zeros(2, 4, 8), torch.zeros(2, 5, 8)), ValueError),
        ((torch.zeros(2, 4, 8, dtype=torch.float64),) * 3, TypeError),
        ((torch.zeros(2, 4, 8), torch.zeros(2, 4, 8, dtype=torch.bfloat16), torch.zeros(2, 4, 8)), TypeError),
        ((torch.zeros(4, 8),) * 3, ValueError),
        ((torch.zeros(2, 8, 4).transpose(1, 2),) * 3, ValueError),
        ((np.zeros((2, 4, 8), np.float32),) * 3, TypeError),
    ],
)
def test_wrapper_argument_checks(args, exc):
    with pytest.raises(exc):
        fa.flash_fwd(*args, False, 1.0)


def test_flash_attention_shape_checks_and_default_scale():
    q = torch.randn(2, 3, 10, 8)
    with pytest.raises(ValueError):
        fa.flash_attention(q, q[..., :9, :], q)
    want = fa._dense_attention(q, q, q, True, 8**-0.5, 10)
    torch.testing.assert_close(fa.flash_attention(q, q, q, causal=True), want, atol=1e-5, rtol=1e-5)
