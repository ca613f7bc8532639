"""The port's transformer decoder, Seq2SeqTransformer, remat and Pipelined against heat_tpu's, on the CPU.

The reference's parameters (its own ``init``) go into the port through
``utils.convert``; the same seeded numpy inputs go to both.  The models
are small: vocab <= 64, E 32, 4 heads, depth 1 or 2, S <= 12.

Tolerances, float32:
- model logits and gradients: atol 2e-5, as ``test_torch_transformer_lm``
  (the flash sums run in another order; the blocks add a few roundings);
- generation, greedy and beam search: tokens equal exactly (the seeds
  give top-2 logit gaps far above the float32 differences);
- remat against no remat: equal to float32 rounding (atol 1e-6): the
  recomputation runs the same kernels on the same inputs;
- Pipelined at one stage against the reference's sequential stack: atol
  2e-5.
"""

import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import heat_tpu as ref_ht
from heat_tpu.nn import models as ref_models

import heat_tpu_torch as ht
from heat_tpu_torch.nn import models
from heat_tpu_torch.utils import convert

ATOL = 2e-5
V, EMB, H = 53, 32, 4


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


@pytest.mark.parametrize("mem_len", [9, 6])
def test_transformer_decoder_matches_reference(mem_len):
    """Equal lengths take the flash cross path, unequal the dense one."""
    rd = ref_models.transformer_decoder(EMB, H, depth=2)
    p = rd.init(jax.random.key(4))
    dec = convert.transformer_decoder_from_reference(_np(p), embed_dim=EMB, num_heads=H, depth=2, device="cpu")
    x, mem = _x(2, 9, EMB), _x(2, mem_len, EMB, seed=2)
    w = _x(2, 9, EMB, seed=3)
    y_r, (g_r, dm_r) = _vjp(lambda params, m: rd.apply(params, jnp.asarray(x), m), (p, jnp.asarray(mem)), w)
    mt = _t(mem).requires_grad_(True)
    y = dec(_t(x), mt)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_r), atol=ATOL, rtol=0)
    (y * _t(w)).sum().backward()
    _grads_close(dec, g_r, ATOL)
    np.testing.assert_allclose(mt.grad.numpy(), np.asarray(dm_r), atol=ATOL, rtol=0)


S2S = dict(src_vocab=41, tgt_vocab=37, embed_dim=EMB, num_heads=H, enc_depth=2, dec_depth=2, max_len=24)


@pytest.fixture(scope="module")
def seq2seq():
    rm = ref_models.Seq2SeqTransformer(**S2S)
    p = rm.init(jax.random.key(11))
    return rm, p, convert.seq2seq_from_reference(_np(p), **S2S, device="cpu").eval()


def test_seq2seq_apply_and_gradients(seq2seq):
    rm, p, m = seq2seq
    src, tgt = _tokens((2, 10), 41), _tokens((2, 10), 37, seed=5)
    w = _x(2, 10, 37, seed=6)
    y_r, (g_r,) = _vjp(lambda params: rm.apply(params, jnp.asarray(src), jnp.asarray(tgt)), (p,), w)
    y = m(_t(src).long(), _t(tgt).long())
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_r), atol=ATOL, rtol=0)
    m.zero_grad()
    (y * _t(w)).sum().backward()
    _grads_close(m, g_r, ATOL)
    # a target shorter than the source: the dense cross path
    tgt7 = tgt[:, :7]
    np.testing.assert_allclose(m(_t(src).long(), _t(tgt7).long()).detach().numpy(),
                               np.asarray(jax.jit(rm.apply)(p, jnp.asarray(src), jnp.asarray(tgt7))), atol=ATOL,
                               rtol=0)
    assert jax.tree.map(np.shape, convert.to_reference(m)) == jax.tree.map(np.shape, _np(p))


@pytest.mark.parametrize("eos", [None, 5])
def test_seq2seq_generate_token_for_token(seq2seq, eos):
    rm, p, m = seq2seq
    src = _tokens((3, 8), 41, seed=12)
    want = np.asarray(rm.generate(p, jnp.asarray(src), 12, bos_id=1, eos_id=eos))
    got = m.generate(_t(src), 12, bos_id=1, eos_id=eos)
    assert got.dtype == torch.int32 and got.shape == (3, 13)
    np.testing.assert_array_equal(got.numpy(), want)
    if eos is not None:  # EOS pins the tail
        for row in got.numpy():
            hits = np.flatnonzero(row[1:] == eos)
            if hits.size:
                assert (row[1 + hits[0]:] == eos).all()


@pytest.mark.parametrize("width,eos,penalty", [(3, 5, 0.6), (3, None, 0.0), (1, 5, 0.0)])
def test_seq2seq_beam_search_token_for_token(seq2seq, width, eos, penalty):
    rm, p, m = seq2seq
    src = _tokens((2, 8), 41, seed=13)
    want = np.asarray(rm.beam_search(p, jnp.asarray(src), 10, beam_width=width, bos_id=1, eos_id=eos,
                                     length_penalty=penalty))
    got = m.beam_search(_t(src), 10, beam_width=width, bos_id=1, eos_id=eos, length_penalty=penalty)
    np.testing.assert_array_equal(got.numpy(), want)
    if width == 1:  # beam width 1 is greedy decoding
        np.testing.assert_array_equal(got.numpy(), m.generate(_t(src), 10, bos_id=1, eos_id=eos).numpy())
    with pytest.raises(ValueError, match="length_penalty"):
        m.beam_search(_t(src), 4, length_penalty=0.5)


def test_seq2seq_greedy_is_the_teacher_forced_argmax(seq2seq):
    """Greedy decoding equals the argmax of ``forward`` over the generated prefix."""
    _, _, m = seq2seq
    src = _tokens((2, 8), 41, seed=14)
    ys = m.generate(_t(src), 9)
    with torch.no_grad():
        logits = m(_t(src).long(), ys[:, :-1].long())
    np.testing.assert_array_equal(logits.argmax(-1).numpy(), ys[:, 1:].numpy())


@pytest.mark.parametrize("kind", ["lm", "seq2seq_moe"])
def test_remat_equals_no_remat(kind):
    """The same loss and gradients with and without checkpointing, dropout
    on (the recomputation replays the forward's masks)."""
    grads = {}
    for remat in (False, True):
        torch.manual_seed(0)
        if kind == "lm":
            m = models.TransformerLM(V, EMB, H, depth=2, max_len=16, remat=remat, dropout=0.1, device="cpu")
            tok = _t(_tokens((2, 12), V)).long()
            torch.manual_seed(1)
            out = m(tok)
        else:
            m = models.Seq2SeqTransformer(41, 37, EMB, H, 1, 1, max_len=16, remat=remat, num_experts=2,
                                          dropout=0.1, device="cpu")
            torch.manual_seed(1)
            out = m(_t(_tokens((2, 8), 41)).long(), _t(_tokens((2, 8), 37)).long())
        loss = (out.float() ** 2).mean()
        loss.backward()
        grads[remat] = (float(loss), {n: q.grad.clone() for n, q in m.named_parameters()})
    assert grads[True][0] == pytest.approx(grads[False][0], abs=1e-6)
    for n, g in grads[False][1].items():
        torch.testing.assert_close(grads[True][1][n], g, atol=1e-6, rtol=0)


class _ResBlock(torch.nn.Module):
    """The reference test's block: x + tanh(Linear(x))."""

    def __init__(self, d):
        super().__init__()
        self.lin = ht.nn.Linear(d, d, device="cpu")

    def forward(self, x):
        return x + torch.tanh(self.lin(x))


class _RefResBlock(ref_ht.nn.modules.Module):
    def __init__(self, d):
        self.lin = ref_ht.nn.Linear(d, d)

    def init(self, key):
        return {"lin": self.lin.init(key)}

    def apply(self, params, x, **kw):
        return x + jnp.tanh(self.lin.apply(params["lin"], x))


@pytest.mark.parametrize("remat", [False, True])
def test_pipelined_one_stage_matches_reference(remat):
    rp = ref_ht.nn.Pipelined(_RefResBlock(8), 4, comm=None)
    p = rp.init(jax.random.key(0))
    pm = convert.pipelined_from_reference(_np(p), _ResBlock(8), 4, remat=remat)
    assert len(pm.blocks) == 4
    x = _x(6, 8)
    w = _x(6, 8, seed=2)
    y_r, (g_r,) = _vjp(lambda params: rp.apply(params, jnp.asarray(x)), (p,), w)
    y = pm(_t(x))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_r), atol=ATOL, rtol=0)
    (y * _t(w)).sum().backward()
    _grads_close(pm, {"blocks": [jax.tree.map(lambda a: a[i], g_r) for i in range(4)]}, ATOL)
    assert jax.tree.map(np.shape, convert.to_reference(pm)) == jax.tree.map(np.shape, _np(p))
    with pytest.warns(UserWarning, match="train="):
        pm(_t(x), train=True)
    with pytest.raises(ValueError, match="batch_axis"):
        ht.nn.Pipelined(_ResBlock(8), 4, None, batch_axis="dp")
    with pytest.raises(ValueError, match="batch_axis"):
        ht.parallel.pipeline_apply(lambda s, h: h, None, _t(x), None, batch_axis="dp")
    with pytest.raises(ValueError, match="divisible"):
        ht.parallel.pipeline_apply(lambda s, h: h, None, _t(x), None, n_microbatches=4)


def test_fresh_copies_draw_their_own_weights():
    torch.manual_seed(0)
    pm = ht.nn.Pipelined(models._TransformerBlock(16, 4, device="cpu"), 3, None)
    w = [b.mha.in_proj_weight for b in pm.blocks] + [b.ff[0].weight for b in pm.blocks]
    assert not torch.equal(w[0], w[1]) and not torch.equal(w[3], w[4])
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        models.TransformerLM(V, EMB, H, depth=1, max_len=8, remat=True, device="cpu")
