"""The port's flash attention past head dim 256 against heat_tpu's Pallas flash kernels.

On the card every head dim past 256 runs the wide route
(``csrc/flash_wide.cuh``); on the CPU the port's wrappers run the same
plain versions the route is held to there, through the same
``torch.autograd.Function``.  The reference runs its Pallas kernels in
interpret mode wherever ``_pallas_gate`` sends them on the CPU (S <= 512
and its VMEM estimate, which every shape here meets), as its own tests do.
The same numpy inputs go to both at d = 257, 320, 512 and 1126: multi-head
attention causal and full and grouped-query attention, each forward, lse
and the gradients by ``jax.vjp`` against ``torch.autograd``.  The
positions block and ``nn.MultiheadAttention`` at head dim 512 are in
``test_torch_flash_wide_block.py``.

Tolerances, float32, as ``test_torch_flash_attention.py`` derives them:
2e-5 on out and lse, 2e-4 on dq, dk, dv (``row_err``: each row's largest
error over that row's largest value); both sides sum in float32 in another
order.  The plain forward takes the reference's tile (the padded S, one
tile here), so P is taken at the same running maximum on both sides.  The
wide kernels themselves run on the card (``test_torch_cuda_kernels.py``,
``cuda``-marked, and ``chip_smoke.py``).

Past d = 256, causal, the rows of dq and dk that cancel (row 0 of dq: one
key, dS = p (dp - dd) with dd = dp) keep float32 rounding noise of the
terms' scale, which ``row_err`` measures against the row floor.
``test_float32_gradients_against_float64`` holds the port's float32 plain
dq, dk and dv and the reference's Pallas gradients against the float64
gradient of dense attention on the same inputs: the port's error may be at
most twice the reference's (two float32 sum orders) plus 1e-6.
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

DIMS = [257, 320, 512, 1126]
S = 70  # ragged against the 64-key tiles and the reference's 128-row blocks
TOL = dict(out=2e-5, grad=2e-4)
LSE_TOL = 2e-5


def _arrays(shapes, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _close(got: torch.Tensor, want, tol, what):
    err = row_err(got.detach().float(), torch.from_numpy(np.array(jnp.asarray(want, jnp.float32))))
    assert err <= tol, f"{what}: rows differ by {err} of their largest value (limit {tol})"


def _port_grads(fn, arrs, w):
    """fn's output on torch copies of ``arrs`` and its gradients under cotangent ``w``."""
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in arrs]
    counts = dict(fa.launch_counts)
    out = fn(*leaves)
    out.backward(torch.from_numpy(w))
    assert fa.launch_counts == counts  # CPU tensors never launch a kernel
    return out, [t.grad for t in leaves]


@pytest.fixture
def reference_tile(monkeypatch):
    """The plain forward at the reference's key tile: the padded S, one tile."""
    monkeypatch.setattr(fa, "KEY_TILE", -(-S // 128) * 128)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", DIMS)
def test_mha_matches_reference(d, causal, reference_tile):
    lead = (1, 2)
    q, k, v, w = _arrays([lead + (S, d)] * 4, seed=d + causal)
    before = ref.path_counts["pallas"]
    out_r, vjp = jax.vjp(lambda *a: ref.flash_attention(*a, causal=causal), *map(jnp.asarray, (q, k, v)))
    grads_r = vjp(jnp.asarray(w))
    assert ref.path_counts["pallas"] > before  # the reference ran its Pallas kernels, not its dense path
    out, grads = _port_grads(lambda *a: fa.flash_attention(*a, causal=causal), (q, k, v), w)
    _close(out, out_r, TOL["out"], "out")
    for g, g_r, name in zip(grads, grads_r, ("dq", "dk", "dv")):
        _close(g, g_r, TOL["grad"], name)

    Sp = -(-S // 128) * 128
    padded = [jnp.pad(jnp.asarray(a).reshape(-1, S, d), ((0, 0), (0, Sp - S), (0, 0))) for a in (q, k, v)]
    _, lse_r = ref._flash_fwd_impl(*padded, causal, 1.0 / d**0.5, S, True)
    _, lse = fa.flash_fwd(*(torch.from_numpy(a).reshape(-1, S, d) for a in (q, k, v)), causal, 1.0 / d**0.5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_r[:, :S]), atol=LSE_TOL, rtol=LSE_TOL, err_msg="lse")


@pytest.mark.parametrize("d", DIMS)
def test_gqa_matches_reference(d, reference_tile):
    """4 query heads on 2 K/V heads; causal at the odd dims, full at the even."""
    causal = bool(d % 2)
    q, w = _arrays([(1, 4, S, d)] * 2, seed=d)
    k, v = _arrays([(1, 2, S, d)] * 2, seed=d + 1)
    before = ref.path_counts["pallas"]
    out_r, vjp = jax.vjp(lambda *a: ref.flash_attention_gqa(*a, causal=causal), *map(jnp.asarray, (q, k, v)))
    grads_r = vjp(jnp.asarray(w))
    assert ref.path_counts["pallas"] > before
    out, grads = _port_grads(lambda *a: fa.flash_attention_gqa(*a, causal=causal), (q, k, v), w)
    _close(out, out_r, TOL["out"], "out")
    for g, g_r, name in zip(grads, grads_r, ("dq", "dk", "dv")):
        _close(g, g_r, TOL["grad"], name)


def _dense_grads_f64(q, k, v, w, causal: bool):
    """The float64 autograd gradient (dq, dk, dv) of dense softmax attention,
    K/V heads repeated over their query heads: the witness both float32
    sides are measured against."""
    leaves = [torch.from_numpy(a).double().requires_grad_(True) for a in (q, k, v)]
    qd, kd, vd = leaves
    g = qd.shape[-3] // kd.shape[-3]
    kd, vd = (t.repeat_interleave(g, dim=-3) for t in (kd, vd))
    d = q.shape[-1]
    s = torch.einsum("...qd,...kd->...qk", qd, kd) * d**-0.5
    if causal:
        S_ = s.shape[-1]
        s = s.masked_fill(torch.ones((S_, S_), dtype=torch.bool).triu(1), float("-inf"))
    out = torch.einsum("...qk,...kd->...qd", torch.softmax(s, -1), vd)
    out.backward(torch.from_numpy(w).double())
    return [t.grad for t in leaves]


# (batch, query heads, K/V heads, S, d), causal: the grouped shapes where the
# float32 plain versions' cancelled rows read above 2e-4 of the row floor
# (d = 320, 1025), and a multi-head one
C12_CASES = [(1, 16, 2, 200, 320), (1, 8, 2, 200, 1025), (1, 4, 4, 200, 512)]


@pytest.mark.parametrize("shape", C12_CASES, ids=lambda s: "-".join(map(str, s)))
def test_float32_gradients_against_float64(shape):
    """On cancelled rows the port's float32 dq, dk and dv are within twice
    the reference's own float32 error (plus 1e-6) of float64."""
    B, hq, hk, S_, d = shape
    q, k, v, w = _arrays([(B, hq, S_, d), (B, hk, S_, d), (B, hk, S_, d), (B, hq, S_, d)], seed=S_ + d)
    ref_fn = ref.flash_attention if hq == hk else ref.flash_attention_gqa
    port_fn = fa.flash_attention if hq == hk else fa.flash_attention_gqa
    before = ref.path_counts["pallas"]
    _, vjp = jax.vjp(lambda *a: ref_fn(*a, causal=True), *map(jnp.asarray, (q, k, v)))
    grads_r = vjp(jnp.asarray(w))
    assert ref.path_counts["pallas"] > before
    _, grads = _port_grads(lambda *a: port_fn(*a, causal=True), (q, k, v), w)
    truth = _dense_grads_f64(q, k, v, w, causal=True)
    for g, g_r, t, name in zip(grads, grads_r, truth, ("dq", "dk", "dv")):
        err = row_err(g.double(), t)
        err_r = row_err(torch.from_numpy(np.array(g_r, np.float64)), t)
        print(f"{name}: port {err:.3g}, reference {err_r:.3g} of the row floor against float64")
        assert err <= 2 * err_r + 1e-6, f"{name}: the port reads {err} of the row floor, the reference {err_r}"


def test_wide_plan_names_every_wide_kernel():
    """``wide_plan`` takes the forward beside dq and dk/dv, in the order of
    the C function's kernel codes, and refuses any other kernel or dtype
    before it builds anything."""
    assert fa.WIDE_KERNELS == ("dq", "dkv", "fwd")
    for kernel, dtype in (("bwd", torch.float32), ("fwd", torch.float16)):
        with pytest.raises(ValueError, match="'fwd', 'dq' or 'dkv'"):
            fa.wide_plan(512, dtype, kernel)
