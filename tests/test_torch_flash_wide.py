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
