"""The port's transformer path against heat_tpu's, on the CPU.

The reference's parameter pytrees (from its own ``init``) go into the port
through ``utils.convert``; the same numpy inputs go to both.  The reference
runs its Pallas flash kernels in interpret mode (S <= 512), the port its
plain versions through the same autograd function the kernels use.  The
width is small: vocab 61, E 32, 4 heads (d = 8), depth 2, max_len 64,
S <= 32.  Grouped-query attention (``num_kv_heads`` 2 and 1) runs through
the same tests of the attention module, and the grouped LM at the shape of
the reference's own ``test_lm_with_gqa`` (vocab 19, E 16, 4 query and 2 K/V
heads, depth 2, rope).

Tolerances, all float32:
- modules (Linear, LayerNorm, Embedding, GELU): atol 1e-6, the same
  expression in another library (one GEMM of at most 32 terms);
- attention, the encoder and LM logits: atol 2e-5; the flash sums run in
  another order (tiled vs one pass) and the blocks add a few float32
  roundings each, on values of magnitude <= ~5;
- loss: rtol 1e-6; gradients: atol 2e-5 of values <= ~1 (the backward
  repeats the forward's rounding differences once more);
- Adam end to end: atol 2e-5 on the parameters after each of 5 steps, at
  lr 3e-3 and eps 1e-4.  An Adam step moves a parameter by up to lr/eps
  times a change of its gradient; the two sides' gradients differ by
  float32 noise (~1e-7 here, and the key bias's gradient is 0 in exact
  arithmetic and pure noise on both sides), so at the default eps (1e-8)
  noise alone would move a parameter by a sizeable part of lr.  lr/eps = 30
  keeps that below 1e-5 over 5 steps;
- the optimizers on identical gradients (the reference's), at their
  default hyperparameters: atol 1e-6 after 3 steps (the same update in
  another expression order);
- decode_step against the forward: atol 2e-5 (another attention path: the
  einsum tail instead of flash);
- greedy generation and top-k = 1 sampling: tokens equal exactly (the
  seeds give top-2 logit gaps far above the float32 differences);
- sampling at temperature 1: by support only (top-k membership, nucleus
  membership, EOS pinning), since ``torch.Generator`` and ``jax.random``
  draw different numbers.
"""

import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import heat_tpu as ref_ht
from heat_tpu.nn import attention as ref_attention
from heat_tpu.nn import models as ref_models
from heat_tpu.nn import modules as ref_modules

import heat_tpu_torch as ht
from heat_tpu_torch.nn import models
from heat_tpu_torch.ops import flash_attention as fa
from heat_tpu_torch.utils import convert

V, E, H, DEPTH, MAX_LEN = 61, 32, 4, 2, 64
CFG = dict(vocab_size=V, embed_dim=E, num_heads=H, depth=DEPTH, max_len=MAX_LEN)
ATOL = 2e-5


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a), tree)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(got.detach().numpy() if isinstance(got, torch.Tensor) else got,
                               np.asarray(want), atol=atol, rtol=rtol)


def _tree_close(got, want, atol=ATOL):
    flat_got, flat_want = convert._flatten(got), convert._flatten(_np(want))
    assert flat_got.keys() == flat_want.keys()
    for key in flat_want:
        np.testing.assert_allclose(flat_got[key], flat_want[key], atol=atol, rtol=0, err_msg=key)


def _lm_pair(seed=0, **kw):
    """(reference model, its params, port model with the same params)."""
    cfg = {**CFG, **kw}
    rm = ref_models.TransformerLM(**cfg)
    params = rm.init(jax.random.key(seed))
    pm = convert.transformer_lm_from_reference(_np(params), **cfg, device="cpu")
    return rm, params, pm


def _tokens(shape, seed=1):
    return np.random.default_rng(seed).integers(0, V, shape).astype(np.int32)


# ---------------------------------------------------------------------- #
# modules
# ---------------------------------------------------------------------- #
def test_modules_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 8)).astype(np.float32)
    lin_r = ref_modules.Linear(8, 6)
    p = lin_r.init(jax.random.key(0))
    lin = convert._load(ht.nn.Linear(8, 6, device="cpu"), _np(p))
    _close(lin(_t(x)), lin_r.apply(p, jnp.asarray(x)), atol=1e-6)
    ln_r = ref_modules.LayerNorm(8)
    lp = {"weight": rng.standard_normal(8).astype(np.float32), "bias": rng.standard_normal(8).astype(np.float32)}
    ln = convert._load(ht.nn.LayerNorm(8, device="cpu"), lp)
    assert ln.eps == 1e-5
    _close(ln(_t(x)), ln_r.apply(lp, jnp.asarray(x)), atol=1e-6)
    emb_r = ref_modules.Embedding(11, 4)
    ep = emb_r.init(jax.random.key(1))
    emb = convert._load(ht.nn.Embedding(11, 4, device="cpu"), _np(ep))
    idx = rng.integers(0, 11, (2, 7))
    _close(emb(_t(idx)), emb_r.apply(ep, jnp.asarray(idx)), atol=0)
    for approx in ("none", "tanh"):
        _close(ht.nn.GELU(approximate=approx)(_t(x)), ref_modules.GELU(approx).apply((), jnp.asarray(x)), atol=1e-6)
    assert ht.nn.GELU().approximate == "none"


def test_module_defaults_follow_the_reference():
    torch.manual_seed(0)
    lin = ht.nn.Linear(100, 50, device="cpu")
    assert float(lin.weight.detach().abs().max()) <= 0.1 and float(lin.bias.detach().abs().max()) <= 0.1
    emb = ht.nn.Embedding(1000, 64, device="cpu")
    assert abs(float(emb.weight.detach().std()) - 1.0) < 0.02  # standard normal
    ln = ht.nn.LayerNorm(16, device="cpu")
    assert torch.equal(ln.weight, torch.ones(16)) and torch.equal(ln.bias, torch.zeros(16))
    assert ht.nn.Dropout().p == 0.5
    if not torch.cuda.is_available():
        prev = ht.get_device()
        ht.use_device("gpu")  # the package's default
        try:
            with pytest.raises(RuntimeError):
                ht.nn.Linear(2, 2)
        finally:
            ht.use_device(prev)


# ---------------------------------------------------------------------- #
# functional
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_cross_entropy(reduction):
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((4, 6, V)).astype(np.float32)
    t = rng.integers(0, V, (4, 6))
    got = ht.nn.functional.cross_entropy(_t(logits), _t(t), reduction=reduction)
    want = ref_ht.nn.functional.cross_entropy(jnp.asarray(logits), jnp.asarray(t), reduction=reduction)
    _close(got, want, atol=2e-6, rtol=1e-6)


def test_scaled_dot_product_attention():
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((2, 4, 12, 8)).astype(np.float32) for _ in range(3))
    bmask = rng.random((12, 12)) > 0.3
    fmask = rng.standard_normal((12, 12)).astype(np.float32)
    sdpa, sdpa_r = ht.nn.functional.scaled_dot_product_attention, ref_ht.nn.functional.scaled_dot_product_attention
    for kw in (dict(is_causal=True), dict(is_causal=False, scale=0.2)):
        _close(sdpa(_t(q), _t(k), _t(v), **kw), sdpa_r(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw))
    for mask, tmask in ((bmask, _t(bmask)), (fmask, _t(fmask))):
        _close(sdpa(_t(q), _t(k), _t(v), attn_mask=tmask),
               sdpa_r(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), attn_mask=jnp.asarray(mask)))
    kg, vg = k[:, :2], v[:, :2]
    _close(sdpa(_t(q), _t(kg), _t(vg), attn_mask=_t(bmask), enable_gqa=True),
           sdpa_r(jnp.asarray(q), jnp.asarray(kg), jnp.asarray(vg), attn_mask=jnp.asarray(bmask), enable_gqa=True))
    # unmasked grouped-query: the grouped flash path on both sides
    for kw in (dict(is_causal=True), dict(is_causal=False, scale=0.2)):
        counts = dict(fa.launch_counts)
        _close(sdpa(_t(q), _t(kg), _t(vg), enable_gqa=True, **kw),
               sdpa_r(jnp.asarray(q), jnp.asarray(kg), jnp.asarray(vg), enable_gqa=True, **kw))
        assert fa.launch_counts == counts


# ---------------------------------------------------------------------- #
# attention
# ---------------------------------------------------------------------- #
def _mha_pair(rope=False, seed=4, num_kv_heads=None):
    rm = ref_attention.MultiheadAttention(E, H, rope=rope, num_kv_heads=num_kv_heads)
    p = rm.init(jax.random.key(seed))
    return rm, p, convert.multihead_attention_from_reference(_np(p), embed_dim=E, num_heads=H, rope=rope,
                                                             num_kv_heads=num_kv_heads, device="cpu")


@pytest.mark.parametrize("rope", [False, True])
@pytest.mark.parametrize("causal", [False, True])
def test_mha_self_attention(causal, rope):
    rm, p, pm = _mha_pair(rope)
    x = np.random.default_rng(5).standard_normal((2, 24, E)).astype(np.float32)
    counts = dict(fa.launch_counts)
    _close(pm(_t(x), causal=causal), rm.apply(p, jnp.asarray(x), causal=causal))
    assert fa.launch_counts == counts


def test_mha_cross_attention_and_cross_step():
    rm, p, pm = _mha_pair()
    rng = np.random.default_rng(6)
    x, mem = rng.standard_normal((2, 9, E)).astype(np.float32), rng.standard_normal((2, 17, E)).astype(np.float32)
    y = pm(_t(x), kv=_t(mem))
    _close(y, rm.apply(p, jnp.asarray(x), kv=jnp.asarray(mem)))
    kh, vh = pm.precompute_kv(_t(mem))
    for t in (0, 4, 8):
        _close(pm.cross_step(_t(x[:, t : t + 1]), kh, vh), y[:, t : t + 1].detach().numpy())


def test_mha_masks_and_weights():
    rm, p, pm = _mha_pair(seed=7)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 10, E)).astype(np.float32)
    kpm = np.zeros((2, 10), bool)
    kpm[0, 7:] = True
    kpm[1, :] = True  # every key of batch 1 ignored: fully-masked rows give 0
    bmask = rng.random((10, 10)) > 0.7
    fmask = rng.standard_normal((10, 10)).astype(np.float32)
    xr = jnp.asarray(x)
    _close(pm(_t(x), key_padding_mask=_t(kpm)), rm.apply(p, xr, key_padding_mask=jnp.asarray(kpm)))
    _close(pm(_t(x), attn_mask=_t(bmask), causal=True), rm.apply(p, xr, attn_mask=jnp.asarray(bmask), causal=True))
    _close(pm(_t(x), attn_mask=_t(fmask)), rm.apply(p, xr, attn_mask=jnp.asarray(fmask)))
    for avg in (True, False):
        y, w = pm(_t(x), need_weights=True, average_attn_weights=avg, causal=True)
        y_r, w_r = rm.apply(p, xr, need_weights=True, average_attn_weights=avg, causal=True)
        _close(y, y_r)
        _close(w, w_r)
        assert w.shape == ((2, 10, 10) if avg else (2, H, 10, 10))


def _shapes(tree):
    return {key: a.shape for key, a in convert._flatten(_np(tree)).items()}


def test_mha_unported_features_raise():
    # grouped-query attention is ported: the reference's parameter shapes, and its init bound
    gqa = ht.nn.MultiheadAttention(E, H, num_kv_heads=2, device="cpu")
    ref_gqa = ref_attention.MultiheadAttention(E, H, num_kv_heads=2)
    assert _shapes(convert.to_reference(gqa)) == _shapes(ref_gqa.init(jax.random.key(0)))
    assert gqa.in_proj_weight.shape == (E + 2 * 2 * (E // H), E) and gqa.kv_dim == 16
    assert float(gqa.in_proj_weight.detach().abs().max()) <= (6.0 / (E + 2 * 16 + E)) ** 0.5
    # comm= is ported: a world-1 communicator runs the ring's one-process path, the no-comm output
    world_one = ht.core.communication.Communication()
    rm, p, pm = _mha_pair(rope=True)
    ring = convert.multihead_attention_from_reference(_np(p), embed_dim=E, num_heads=H, rope=True, comm=world_one,
                                                      device="cpu")
    x = _t(np.random.default_rng(2).standard_normal((2, 12, E)).astype(np.float32))
    torch.testing.assert_close(ring(x, causal=True), pm(x, causal=True), atol=0, rtol=0)
    with pytest.raises(ValueError):
        ht.nn.MultiheadAttention(E, 5, device="cpu")
    # mixture-of-experts blocks are ported: the same constructions hold the reference's function
    tok = _tokens((2, 12))
    for cfg in (dict(CFG, num_experts=4), dict(CFG, remat=True)):
        r_lm = ref_models.TransformerLM(**cfg)
        p_lm = r_lm.init(jax.random.key(5))
        lm = convert.transformer_lm_from_reference(_np(p_lm), **cfg, device="cpu")
        _close(lm(_t(tok).long()), jax.jit(r_lm.apply)(p_lm, jnp.asarray(tok)))
    r_enc = ref_models.transformer_encoder(E, H, depth=1, num_experts=2)
    p_enc = r_enc.init(jax.random.key(6))
    enc = convert.load_reference(models.transformer_encoder(E, H, depth=1, num_experts=2, device="cpu"), _np(p_enc))
    xe = np.random.default_rng(4).standard_normal((2, 12, E)).astype(np.float32)
    _close(enc(_t(xe)), jax.jit(r_enc.apply)(p_enc, jnp.asarray(xe)))
    rm = ref_models.TransformerLM(**CFG, num_kv_heads=2)
    assert _shapes(convert.to_reference(models.TransformerLM(**CFG, num_kv_heads=2, device="cpu"))) == \
        _shapes(rm.init(jax.random.key(0)))
    with pytest.raises(ValueError):
        models.TransformerLM(**CFG, num_kv_heads=3, device="cpu")
    lm = models.TransformerLM(**CFG, comm=world_one, device="cpu")
    plain = convert.transformer_lm_from_reference(convert.to_reference(lm), **CFG, device="cpu")
    tok = _t(_tokens((2, 20))).long()
    torch.testing.assert_close(lm(tok), plain(tok), atol=0, rtol=0)
    with warnings.catch_warnings():  # remat is ported: no warning
        warnings.simplefilter("error")
        assert models.TransformerLM(**CFG, remat=True, device="cpu").blocks[0].remat


@pytest.mark.parametrize("rope", [False, True])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("num_kv_heads", [2, 1])
def test_gqa_mha_self_attention_and_gradients(num_kv_heads, causal, rope):
    """Grouped-query self-attention (the grouped flash path on both sides),
    and the gradient of every parameter and of the input."""
    rm, p, pm = _mha_pair(rope, seed=15, num_kv_heads=num_kv_heads)
    rng = np.random.default_rng(15)
    x, w = (rng.standard_normal((2, 24, E)).astype(np.float32) for _ in range(2))
    y_r, vjp = jax.vjp(lambda params, xs: rm.apply(params, xs, causal=causal), p, jnp.asarray(x))
    grads_r, dx_r = vjp(jnp.asarray(w))
    xt = _t(x).requires_grad_(True)
    counts = dict(fa.launch_counts)
    y = pm(xt, causal=causal)
    y.backward(_t(w))
    assert fa.launch_counts == counts
    _close(y, y_r)
    _close(xt.grad, dx_r)
    _tree_close(convert._unflatten({n: q.grad.numpy() for n, q in pm.named_parameters()}), grads_r)


@pytest.mark.parametrize("num_kv_heads", [2, 1])
def test_gqa_mha_masks_weights_and_cross_attention(num_kv_heads):
    """The dense paths over K/V repeated per group: masks, need_weights,
    cross-attention, and cross_step against the grouped decode tail."""
    rm, p, pm = _mha_pair(seed=16, num_kv_heads=num_kv_heads)
    rng = np.random.default_rng(16)
    x = rng.standard_normal((2, 10, E)).astype(np.float32)
    mem = rng.standard_normal((2, 13, E)).astype(np.float32)
    kpm = np.zeros((2, 10), bool)
    kpm[0, 6:] = True
    bmask = rng.random((10, 10)) > 0.7
    xr = jnp.asarray(x)
    _close(pm(_t(x), key_padding_mask=_t(kpm)), rm.apply(p, xr, key_padding_mask=jnp.asarray(kpm)))
    _close(pm(_t(x), attn_mask=_t(bmask), causal=True), rm.apply(p, xr, attn_mask=jnp.asarray(bmask), causal=True))
    y, wts = pm(_t(x), need_weights=True, average_attn_weights=False, causal=True)
    y_r, w_r = rm.apply(p, xr, need_weights=True, average_attn_weights=False, causal=True)
    _close(y, y_r)
    _close(wts, w_r)
    assert wts.shape == (2, H, 10, 10)
    yc = pm(_t(x), kv=_t(mem))
    _close(yc, rm.apply(p, xr, kv=jnp.asarray(mem)))
    kh, vh = pm.precompute_kv(_t(mem))
    assert kh.shape == (2, num_kv_heads, 13, E // H)
    kh_r, vh_r = rm.precompute_kv(p, jnp.asarray(mem))
    _close(kh, kh_r)
    for t in (0, 5, 9):
        _close(pm.cross_step(_t(x[:, t : t + 1]), kh, vh), rm.cross_step(p, xr[:, t : t + 1], kh_r, vh_r))


@pytest.mark.parametrize("rope", [False, True])
@pytest.mark.parametrize("num_kv_heads", [2, 1])
def test_gqa_decode_step_matches_reference(num_kv_heads, rope):
    """decode_step against the reference's, one position at a time, with a
    cache of num_kv_heads heads; and against the port's own causal forward."""
    rm, p, pm = _mha_pair(rope, seed=17, num_kv_heads=num_kv_heads)
    x = np.random.default_rng(17).standard_normal((3, 9, E)).astype(np.float32)
    cache, cache_r = pm.init_cache(3, 9), rm.init_cache(3, 9)
    assert cache["k"].shape == (3, num_kv_heads, 9, E // H) == cache_r["k"].shape
    with torch.no_grad():
        full = pm(_t(x), causal=True)
        for t in range(9):
            y, cache = pm.decode_step(_t(x[:, t : t + 1]), cache)
            y_r, cache_r = rm.decode_step(p, jnp.asarray(x[:, t : t + 1]), cache_r)
            _close(y, y_r)
            _close(y, full[:, t : t + 1].numpy())
    _close(cache["k"], cache_r["k"])
    _close(cache["v"], cache_r["v"])


def test_apply_rope_is_relative():
    rng = np.random.default_rng(8)
    q, k = (_t(rng.standard_normal((1, 1, 1, 8)).astype(np.float32)) for _ in range(2))
    dots = [float((ht.nn.apply_rope(q, i + 3) * ht.nn.apply_rope(k, i)).sum()) for i in range(4)]
    assert max(dots) - min(dots) < 1e-5
    x = rng.standard_normal((2, 3, 7, 8)).astype(np.float32)
    _close(ht.nn.apply_rope(_t(x), torch.arange(7)), ref_attention.apply_rope(jnp.asarray(x), jnp.arange(7)),
           atol=1e-6)


def test_transformer_encoder():
    for causal in (False, True):
        rm = ref_models.transformer_encoder(E, H, depth=2, causal=causal)
        p = rm.init(jax.random.key(9))
        pm = convert._load(models.transformer_encoder(E, H, depth=2, causal=causal, device="cpu"), _np(p))
        x = np.random.default_rng(9).standard_normal((2, 20, E)).astype(np.float32)
        _close(pm(_t(x)), rm.apply(p, jnp.asarray(x)))


# ---------------------------------------------------------------------- #
# TransformerLM
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("positions,tied", [("learned", False), ("sinusoidal", False), ("rope", False),
                                            ("learned", True)])
def test_lm_logits(positions, tied):
    rm, params, pm = _lm_pair(positions=positions, tie_embeddings=tied)
    tok = _tokens((3, 32))
    _close(pm(_t(tok)), rm.apply(params, jnp.asarray(tok)))
    with pytest.raises(ValueError):
        pm(_t(_tokens((1, MAX_LEN + 1))))


def _grad_ref(rm):
    """The reference's jitted (loss, grads) of next-token cross-entropy: ``fn(params, tokens)``."""
    def loss(p, tok):
        logits = rm.apply(p, tok[:, :-1])
        return ref_ht.nn.functional.cross_entropy(logits.reshape(-1, V), tok[:, 1:].reshape(-1))
    return jax.jit(jax.value_and_grad(loss))


def _loss(pm, tok):
    return ht.nn.functional.cross_entropy(pm(tok[:, :-1]).reshape(-1, V), tok[:, 1:].reshape(-1))


@pytest.mark.parametrize("positions", ["learned", "rope"])
def test_lm_loss_and_every_gradient(positions):
    rm, params, pm = _lm_pair(seed=3, positions=positions)
    tok = _tokens((4, 33), seed=3)
    loss_r, grads_r = _grad_ref(rm)(params, jnp.asarray(tok))
    loss = _loss(pm, _t(tok).long())
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(loss_r), rtol=1e-6)
    grads = convert._unflatten({n: p.grad.numpy() for n, p in pm.named_parameters()})
    _tree_close(grads, grads_r)


def test_adam_steps_match_reference():
    rm, params, pm = _lm_pair(seed=5)
    opt_r = ref_ht.optim.DataParallelOptimizer("adam", lr=3e-3, eps=1e-4)
    opt_r.init_state(params)
    opt = ht.optim.DataParallelOptimizer("adam", pm.parameters(), lr=3e-3, eps=1e-4)
    rng = np.random.default_rng(5)
    grad_ref = _grad_ref(rm)
    for step in range(5):
        tok = rng.integers(0, V, (4, 25)).astype(np.int32)
        _, grads_r = grad_ref(params, jnp.asarray(tok))
        params = opt_r.step(params, grads_r)
        opt.zero_grad()
        _loss(pm, _t(tok).long()).backward()
        assert opt.step()
        _tree_close(convert.to_reference(pm), params)
    assert opt.guard_stats() == {"steps": 5, "skipped": 0} == opt_r.guard_stats()


@pytest.mark.parametrize("name,kw", [("adam", {}), ("adamw", {}), ("sgd", dict(lr=0.1, momentum=0.9)),
                                     ("sgd", dict(weight_decay=0.1, momentum=0.5, nesterov=True))])
def test_named_optimizers_match_reference_on_the_same_gradients(name, kw):
    rm, params, pm = _lm_pair(seed=6)
    opt_r = ref_ht.optim.DataParallelOptimizer(name, **kw)
    opt_r.init_state(params)
    opt = ht.optim.DataParallelOptimizer(name, pm.parameters(), **kw)
    named = dict(pm.named_parameters())
    grad_ref = _grad_ref(rm)
    for step in range(3):
        tok = _tokens((2, 17), seed=step)
        _, grads_r = grad_ref(params, jnp.asarray(tok))
        params = opt_r.step(params, grads_r)
        for key, g in convert._flatten(_np(grads_r)).items():
            named[key].grad = torch.from_numpy(np.array(g))
        opt.step()
        _tree_close(convert.to_reference(pm), params, atol=1e-6)


def test_nonfinite_gradient_skips_the_step():
    rm, params, pm = _lm_pair(seed=7)
    tok = _t(_tokens((2, 17), seed=7)).long()
    opt = ht.optim.DataParallelOptimizer("adam", pm.parameters(), lr=1e-2)
    _loss(pm, tok).backward()
    assert opt.step()
    before = {n: p.detach().clone() for n, p in pm.named_parameters()}
    state = {i: {k: v.clone() for k, v in s.items()} for i, s in enumerate(opt.state.values())}
    opt.zero_grad()
    _loss(pm, tok).backward()
    pm.blocks[0].mha.in_proj_weight.grad[3, 4] = float("nan")
    assert not opt.step()
    assert all(torch.equal(p, before[n]) for n, p in pm.named_parameters())
    for i, s in enumerate(opt.state.values()):
        assert all(torch.equal(v, state[i][k]) for k, v in s.items())
    assert opt.guard_stats() == {"steps": 2, "skipped": 1}
    # the reference's guard does the same
    opt_r = ref_ht.optim.DataParallelOptimizer("adam", lr=1e-2)
    opt_r.init_state(params)
    _, grads_r = _grad_ref(rm)(params, jnp.asarray(_tokens((2, 17), seed=7)))
    grads_r["embed"]["weight"] = grads_r["embed"]["weight"].at[0, 0].set(jnp.inf)
    after = opt_r.step(params, grads_r)
    _tree_close(_np(after), params, atol=0)
    assert opt_r.guard_stats() == {"steps": 1, "skipped": 1}
    unguarded = ht.optim.DataParallelOptimizer("sgd", pm.parameters(), guard_nonfinite=False)
    assert unguarded.step() and unguarded.guard_stats() == {"steps": 0, "skipped": 0}


@pytest.mark.parametrize("positions", ["learned", "sinusoidal", "rope"])
def test_decode_step_matches_forward(positions):
    _, _, pm = _lm_pair(seed=8, positions=positions)
    tok = _t(_tokens((3, 20), seed=8))
    with torch.no_grad():
        full = pm(tok)
        caches = pm.init_caches(3, 20)
        rows = [pm.decode_step(tok[:, t], t, caches)[0] for t in range(20)]
    _close(torch.stack(rows, 1), full.numpy())
    assert all(c["index"] == 20 for c in caches)
    with pytest.raises(ValueError):
        pm.decode_step(tok[:, 0], 0, caches)  # past the cache


@pytest.mark.parametrize("positions,tied", [("learned", False), ("rope", False), ("sinusoidal", True)])
def test_greedy_generate_matches_reference(positions, tied):
    rm, params, pm = _lm_pair(seed=9, positions=positions, tie_embeddings=tied)
    prompt = _tokens((3, 6), seed=9)
    want = rm.generate(params, jnp.asarray(prompt), 14)
    got = pm.generate(_t(prompt), 14)
    assert got.dtype == torch.int32 and got.shape == (3, 20)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


GQA_CFG = dict(vocab_size=19, embed_dim=16, num_heads=4, depth=2, max_len=32, num_kv_heads=2, positions="rope")


def _gqa_lm_pair(seed):
    rm = ref_models.TransformerLM(**GQA_CFG)
    params = rm.init(jax.random.key(seed))
    return rm, params, convert.transformer_lm_from_reference(_np(params), **GQA_CFG, device="cpu")


def test_gqa_lm_logits_loss_and_every_gradient():
    """TransformerLM(num_kv_heads=2, positions='rope') at the reference's
    own test shape: logits, loss and every parameter's gradient."""
    rm, params, pm = _gqa_lm_pair(seed=18)
    tok = np.random.default_rng(18).integers(0, 19, (2, 9)).astype(np.int32)
    _close(pm(_t(tok[:, :-1])), rm.apply(params, jnp.asarray(tok[:, :-1])))

    def loss(p, t):
        logits = rm.apply(p, t[:, :-1])
        return ref_ht.nn.functional.cross_entropy(logits.reshape(-1, 19), t[:, 1:].reshape(-1))

    loss_r, grads_r = jax.value_and_grad(loss)(params, jnp.asarray(tok))
    counts = dict(fa.launch_counts)
    tt = _t(tok).long()
    lp = ht.nn.functional.cross_entropy(pm(tt[:, :-1]).reshape(-1, 19), tt[:, 1:].reshape(-1))
    lp.backward()
    assert fa.launch_counts == counts
    np.testing.assert_allclose(float(lp.detach()), float(loss_r), rtol=1e-6)
    _tree_close(convert._unflatten({n: p.grad.numpy() for n, p in pm.named_parameters()}), grads_r)


def test_gqa_lm_decode_and_greedy_generate_match_reference():
    rm, params, pm = _gqa_lm_pair(seed=19)
    tok = np.random.default_rng(19).integers(0, 19, (2, 8)).astype(np.int32)
    with torch.no_grad():
        full = pm(_t(tok))
        caches = pm.init_caches(2, 8)
        assert caches[0]["k"].shape == (2, 2, 8, 4)
        rows = [pm.decode_step(_t(tok[:, t]), t, caches)[0] for t in range(8)]
    _close(torch.stack(rows, 1), full.numpy())
    want = rm.generate(params, jnp.asarray(tok[:, :3]), 20)
    got = pm.generate(_t(tok[:, :3]), 20)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_top_k_one_sampling_and_eos_pinning_match_reference():
    rm, params, pm = _lm_pair(seed=10)
    prompt = _tokens((3, 5), seed=10)
    greedy = pm.generate(_t(prompt), 12).numpy()
    eos = int(greedy[0, 8])  # row 0 emits it at position 8
    prompt[1, 2] = eos  # an EOS in the prompt stops nothing
    want = rm.generate(params, jnp.asarray(prompt), 12, temperature=0.7, top_k=1, eos_id=eos, key=jax.random.key(0))
    got = pm.generate(_t(prompt), 12, temperature=0.7, top_k=1, eos_id=eos,
                      generator=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got[0, 8:] == eos).all()
    for row in got.numpy():  # every generated EOS pins the rest of its row
        hits = np.flatnonzero(row[5:] == eos)
        assert hits.size == 0 or (row[5 + hits[0]:] == eos).all()


def _sampled_support(pm, ys, S0, keep):
    """Every generated token lies in ``keep(logits)`` of the teacher-forced logits before it."""
    with torch.no_grad():
        logits = pm(ys[:, :-1].long())
    for t in range(S0 - 1, ys.shape[1] - 1):
        allowed = keep(logits[:, t])
        assert bool(allowed.gather(1, ys[:, t + 1 : t + 2].long()).all()), t


def test_sampling_by_support():
    _, _, pm = _lm_pair(seed=11)
    prompt = _t(_tokens((4, 4), seed=11))
    g = torch.Generator().manual_seed(3)
    ys = pm.generate(prompt, 20, temperature=1.0, top_k=3, generator=g)
    assert torch.equal(ys[:, :4], prompt.int())
    _sampled_support(pm, ys, 4, lambda lg: lg >= lg.topk(3, dim=-1).values[:, -1:])

    def nucleus(lg, p=0.5):
        srt, order = torch.softmax(lg, -1).sort(dim=-1, descending=True)
        keep_sorted = (srt.cumsum(-1) - srt) < p
        return torch.zeros_like(keep_sorted).scatter_(-1, order, keep_sorted)

    ys = pm.generate(prompt, 20, temperature=1.0, top_p=0.5, generator=g)
    _sampled_support(pm, ys, 4, nucleus)
    ys = pm.generate(prompt, 20, temperature=1.0, generator=g)
    assert ys.shape == (4, 24) and int(ys.min()) >= 0 and int(ys.max()) < V
    with pytest.raises(ValueError):
        pm.generate(prompt, 3, temperature=1.0)  # sampling needs a generator
    with pytest.raises(ValueError):
        pm.generate(prompt, MAX_LEN)


def test_normalize_truncation_matches_reference():
    for args in ((0, None, True), (5, 0.9, True), (V, 1.0, True), (3, 0.5, False), (None, 2.0, True)):
        assert models._normalize_truncation(*args[:2], V, args[2]) == \
            ref_models._normalize_truncation(*args[:2], V, args[2])
    for bad in ((-1, None), (None, 0.0)):
        with pytest.raises(ValueError):
            models._normalize_truncation(*bad, V, True)


# ---------------------------------------------------------------------- #
# conversion
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("positions,tied", [("learned", False), ("rope", True)])
def test_transformer_lm_round_trip(positions, tied):
    _, params, pm = _lm_pair(seed=12, positions=positions, tie_embeddings=tied)
    back = convert.to_reference(pm)
    assert jax.tree.structure(back) == jax.tree.structure(_np(params))
    _tree_close(back, params, atol=0)
    with pytest.raises(RuntimeError):  # a parameter name the model lacks
        convert.transformer_lm_from_reference({**_np(params), "extra": np.zeros(2, np.float32)}, **CFG,
                                              positions=positions, tie_embeddings=tied, device="cpu")


def test_multihead_attention_round_trip():
    _, p, pm = _mha_pair(seed=13)
    back = convert.to_reference(pm)
    assert jax.tree.structure(back) == jax.tree.structure(_np(p))
    _tree_close(back, p, atol=0)
    bf = convert.multihead_attention_from_reference(_np(p), embed_dim=E, num_heads=H, device="cpu",
                                                    dtype=torch.bfloat16)
    assert bf.in_proj_weight.dtype == torch.bfloat16
    _tree_close(convert.to_reference(bf), p, atol=2**-8)


def test_gqa_transformer_lm_round_trip():
    """A reference GQA pytree (in_proj_weight (E + 2·kv_dim, E)) carries over
    through utils.convert and back unchanged."""
    _, params, pm = _gqa_lm_pair(seed=20)
    assert pm.blocks[0].mha.in_proj_weight.shape == (16 + 2 * 8, 16)
    back = convert.to_reference(pm)
    assert jax.tree.structure(back) == jax.tree.structure(_np(params))
    _tree_close(back, params, atol=0)
    _, p, mha = _mha_pair(seed=21, num_kv_heads=1)
    _tree_close(convert.to_reference(mha), p, atol=0)
    with pytest.raises(RuntimeError):  # a GQA pytree into a module of other head counts
        convert.multihead_attention_from_reference(_np(p), embed_dim=E, num_heads=H, device="cpu")


def test_cpu_path_launches_no_kernel():
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        _, _, pm = _lm_pair(seed=14)
    counts = dict(fa.launch_counts)
    tok = _t(_tokens((2, 9), seed=14)).long()
    _loss(pm, tok).backward()
    pm.generate(tok[:, :3], 4)
    assert fa.launch_counts == counts
