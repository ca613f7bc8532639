"""The port's MoE and the MoE transformers against heat_tpu's, on the CPU.

The reference's parameters (its own ``init``) go into the port through
``utils.convert``; the same seeded numpy inputs go to both.  The models
are small: vocab <= 64, E 8 or 32, 4 heads, depth 2, S <= 12.

Tolerances, float32:
- MoE outputs and gradients: atol 2e-6 (routing decisions equal exactly;
  the k terms of a token and the expert GEMMs sum in another order);
- model logits and gradients: atol 2e-5, as ``test_torch_transformer_lm``
  (the flash sums run in another order; the blocks add a few roundings);
- greedy generation: tokens equal exactly (the seeds give top-2 logit
  gaps far above the float32 differences).
"""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import heat_tpu as ref_ht
from heat_tpu.nn import models as ref_models
from heat_tpu.nn.moe import _routing as ref_routing

import heat_tpu_torch as ht
from heat_tpu_torch.nn import models, moe
from heat_tpu_torch.utils import convert

ATOL = 2e-5
MOE_ATOL = 2e-6


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _x(*shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _tokens(shape, vocab, seed=3):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _vjp(fn, args, cot):
    """fn(*args) and its vjp of ``cot``, as one compiled program."""
    def both(args, c):
        out, vjp = jax.vjp(fn, *args)
        return out, vjp(c)

    return jax.jit(both)(args, jnp.asarray(cot))


def _grads_close(module, ref_grads, atol):
    flat = convert._flatten(_np(ref_grads))
    for name, p in module.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), flat[name], atol=atol, rtol=0, err_msg=name)


# ---------------------------------------------------------------------- #
# MoE
# ---------------------------------------------------------------------- #
D, E_EXP, HID = 8, 4, 16


def _moe_pair(top_k, cf, seed=0):
    rm = ref_ht.nn.MoE(D, E_EXP, hidden_dim=HID, top_k=top_k, capacity_factor=cf)
    p = rm.init(jax.random.key(seed))
    pm = convert.moe_from_reference(_np(p), embed_dim=D, num_experts=E_EXP, hidden_dim=HID, top_k=top_k,
                                    capacity_factor=cf, device="cpu")
    return rm, p, pm


@pytest.mark.parametrize("top_k", [1, 2, 3])
@pytest.mark.parametrize("cf", [64.0, 0.5])
def test_moe_dense_routing_matches_reference(top_k, cf):
    """Outputs and every gradient, capacity binding (cf 0.5: claims
    dropped) and not (cf 64)."""
    rm, p, pm = _moe_pair(top_k, cf)
    x = _x(3, 5, D)
    w = _x(3, 5, D, seed=2)
    y_r, (g_r, dx_r) = _vjp(lambda params, xs: rm.apply(params, xs), (p, jnp.asarray(x)), w)
    xt = _t(x).requires_grad_(True)
    y = pm(xt)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_r), atol=MOE_ATOL, rtol=0)
    (y * _t(w)).sum().backward()
    _grads_close(pm, g_r, MOE_ATOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx_r), atol=MOE_ATOL, rtol=0)
    dropped, claims = pm.route_stats.tolist()
    assert claims == 15 * top_k and (dropped > 0) == (cf < 1.0)
    # the drops are the reference's: its dispatch serves exactly the kept claims
    dispatch, _ = ref_routing(jax.nn.softmax(jnp.asarray(x.reshape(-1, D)) @ p["router"]), top_k,
                              rm._capacity(15))
    assert int(np.asarray(dispatch).sum()) == claims - dropped


def test_moe_pad_tokens_take_no_capacity():
    """A zero-gate claim takes no queue position, so a pad first in line
    evicts no real token (the reference's test_moe_pipeline case)."""
    gates = torch.tensor([[0.0, 0.0], [1.0, 0.0], [1.0, 0.0]])
    token, slot, weight, kept, valid = moe._routing(gates, 1, 2)
    assert kept.tolist() == [False, True, True] and valid.tolist() == [False, True, True]
    assert slot.tolist() == [4, 0, 1] and weight.tolist() == [0.0, 1.0, 1.0]
    dispatch, _ = ref_routing(jnp.asarray(gates.numpy()), top_k=1, capacity=2)
    np.testing.assert_array_equal(np.asarray(dispatch.sum(axis=(1, 2))), kept.float().numpy())


def test_moe_decode_apply_and_load_balance_loss():
    rm, p, pm = _moe_pair(2, 64.0)
    x = _x(4, 3, D, seed=5)
    want = np.asarray(jax.jit(rm.decode_apply)(p, jnp.asarray(x)))
    got = pm.decode_apply(_t(x))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=MOE_ATOL, rtol=0)
    np.testing.assert_allclose(got.detach().numpy(), pm(_t(x)).detach().numpy(), atol=MOE_ATOL, rtol=0)
    lbl = pm.load_balance_loss(_t(x)).detach()
    assert float(lbl) == pytest.approx(float(rm.load_balance_loss(p, jnp.asarray(x))), abs=1e-6)
    pm(_t(x))
    assert float(pm.aux_loss.detach()) == pytest.approx(float(lbl), abs=1e-6)
    # uniform router: the bound 1 is met
    with torch.no_grad():
        pm.router.zero_()
    assert float(pm.load_balance_loss(_t(x))) >= 1.0 - 1e-6


def test_moe_indivisible_experts_warn_and_batch_axis_raises():
    """Experts that do not divide the ranks warn with the reference's words
    and take the dense path (every expert here); ``batch_axis`` raises."""
    fake = types.SimpleNamespace(size=3, rank=1)
    m = ht.nn.MoE(D, E_EXP, hidden_dim=HID, comm=fake, device="cpu")
    assert not m.sharded and m.w1.shape[0] == E_EXP
    with pytest.warns(UserWarning, match="not divisible.*ROUTING NUMERICS"):
        m(_t(_x(4, D)))
    with pytest.raises(ValueError, match="batch_axis"):
        ht.nn.MoE(D, E_EXP, batch_axis="dp", device="cpu")
    with pytest.raises(ValueError, match="top_k"):
        ht.nn.MoE(D, E_EXP, top_k=5, device="cpu")
    rep, shards = moe.split_parameters(m)
    assert shards == [] and len(rep) == 5


# ---------------------------------------------------------------------- #
# models
# ---------------------------------------------------------------------- #
V, EMB, H = 53, 32, 4
LM_MOE = dict(vocab_size=V, embed_dim=EMB, num_heads=H, depth=2, max_len=32, num_experts=4, moe_top_k=2,
              moe_capacity_factor=2.0)


def test_moe_lm_forward_gradients_and_generate():
    rm = ref_models.TransformerLM(**LM_MOE)
    p = rm.init(jax.random.key(7))
    lm = convert.transformer_lm_from_reference(_np(p), **LM_MOE, device="cpu")
    assert isinstance(lm.blocks[0].ff, ht.nn.MoE) and lm.blocks[0].ff is not lm.blocks[1].ff
    tok = _tokens((2, 12), V)
    tgt = _tokens((2, 12), V, seed=4)

    def ref_loss(params):
        return ref_ht.nn.functional.cross_entropy(rm.apply(params, jnp.asarray(tok)).reshape(-1, V),
                                                  jnp.asarray(tgt).reshape(-1))

    logits_r, (loss_r, g_r) = jax.jit(lambda q: (rm.apply(q, jnp.asarray(tok)), jax.value_and_grad(ref_loss)(q)))(p)
    logits = lm(_t(tok).long())
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(logits_r), atol=ATOL, rtol=0)
    loss = ht.nn.functional.cross_entropy(logits.reshape(-1, V), _t(tgt).long().reshape(-1))
    assert float(loss) == pytest.approx(float(loss_r), rel=1e-6)
    loss.backward()
    _grads_close(lm, g_r, ATOL)
    prompt = _tokens((2, 4), V, seed=9)
    want = np.asarray(rm.generate(p, jnp.asarray(prompt), 8))
    np.testing.assert_array_equal(lm.generate(_t(prompt), 8).numpy(), want)


def test_moe_encoder_forward_and_gradients():
    re = ref_models.transformer_encoder(EMB, H, depth=2, num_experts=2, moe_top_k=1)
    p = re.init(jax.random.key(2))
    enc = convert.load_reference(models.transformer_encoder(EMB, H, depth=2, num_experts=2, moe_top_k=1,
                                                            device="cpu"), _np(p))
    x = _x(2, 10, EMB)
    w = _x(2, 10, EMB, seed=3)
    y_r, (g_r,) = _vjp(lambda params: re.apply(params, jnp.asarray(x)), (p,), w)
    y = enc(_t(x))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_r), atol=ATOL, rtol=0)
    (y * _t(w)).sum().backward()
    _grads_close(enc, g_r, ATOL)
