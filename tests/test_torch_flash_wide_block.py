"""The port's positions block and attention layer past head dim 256 against heat_tpu's.

The companion of ``test_torch_flash_wide.py`` (whose note gives the
routes, the reference's interpret mode and the tolerances): the positions
block (ring attention's step) with its mask at d = 257, 320, 512 and 1126,
forward, lse and the gradients under a nonzero lse cotangent; and
``nn.MultiheadAttention(1024, 2)`` (head dim 512) against the reference's
layer with the weights carried across by ``utils.convert``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from heat_tpu.nn import attention as ref_attention

import heat_tpu_torch as ht
from heat_tpu_torch.ops import flash_attention as fa
from heat_tpu_torch.utils import convert
from test_torch_flash_wide import DIMS, LSE_TOL, TOL, _arrays, _close, ref


# (Sq, Sk, query offset, key offset, causal, s_valid): the ring's diagonal
# block, a past block, and a rectangular one whose keys at positions >= 60
# are pad
BLOCKS = {257: (64, 64, 64, 64, True, 160), 320: (64, 64, 64, 0, True, 160), 512: (50, 70, 0, 0, False, 60),
          1126: (64, 64, 64, 64, True, 160)}


@pytest.mark.parametrize("d", DIMS)
def test_positions_block_matches_reference(d):
    """The masked positions block: out, lse and the gradients under a
    nonzero lse cotangent, against the reference's positions kernels."""
    Sq, Sk, qo, ko, causal, s_valid = BLOCKS[d]
    q, w = _arrays([(1, 2, Sq, d)] * 2, seed=d + 5)
    k, v = _arrays([(1, 2, Sk, d)] * 2, seed=d + 6)
    g = _arrays([(1, 2, Sq)], seed=d + 7)[0]
    qpos, kpos = np.arange(qo, qo + Sq, dtype=np.int32), np.arange(ko, ko + Sk, dtype=np.int32)
    scale = d**-0.5

    def block_r(q, k, v):
        return ref.flash_attention_block(q, k, v, jnp.asarray(qpos), jnp.asarray(kpos), causal=causal, scale=scale,
                                         s_valid=s_valid, impl="interpret")

    (out_r, lse_r), vjp = jax.vjp(block_r, *map(jnp.asarray, (q, k, v)))
    grads_r = vjp((jnp.asarray(w), jnp.asarray(g)))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out, lse = fa.flash_attention_block(*leaves, torch.from_numpy(qpos), torch.from_numpy(kpos), causal=causal,
                                        scale=scale, s_valid=s_valid)
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum() + (lse * torch.from_numpy(g)).sum(), leaves)
    _close(out, out_r, TOL["out"], "out")
    np.testing.assert_allclose(lse.detach().numpy(), np.asarray(lse_r), atol=LSE_TOL, rtol=LSE_TOL, err_msg="lse")
    for t, t_r, name in zip(grads, grads_r, ("dq", "dk", "dv")):
        _close(t, t_r, TOL["grad"], name)


@pytest.mark.parametrize("causal", [False, True])
def test_multihead_attention_at_head_dim_512(causal):
    """``nn.MultiheadAttention(1024, 2)`` with the reference layer's weights:
    the output and the gradient of the input."""
    E, H = 1024, 2
    rm = ref_attention.MultiheadAttention(E, H)
    p = rm.init(jax.random.key(3))
    pm = convert.multihead_attention_from_reference(jax.tree_util.tree_map(np.asarray, p), embed_dim=E,
                                                    num_heads=H, device="cpu")
    assert pm.head_dim == 512
    x, w = _arrays([(2, 40, E)] * 2, seed=11 + causal)
    y_r, vjp = jax.vjp(lambda a: rm.apply(p, a, causal=causal), jnp.asarray(x))
    (gx_r,) = vjp(jnp.asarray(w))
    xt = torch.from_numpy(x).requires_grad_(True)
    counts = dict(fa.launch_counts)
    y = pm(xt, causal=causal)
    y.backward(torch.from_numpy(w))
    assert fa.launch_counts == counts
    assert isinstance(pm, ht.nn.MultiheadAttention)
    _close(y, y_r, TOL["out"], "out")
    _close(xt.grad, gx_r, TOL["grad"], "dx")
