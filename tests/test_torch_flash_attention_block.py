"""The port's positions block (ring attention's step) against heat_tpu's.

``flash_attention_block`` runs its plain versions here, through the same
``torch.autograd.Function`` that launches the positions kernels on the
card; the reference runs its Pallas positions kernels in interpret mode
(``impl="interpret"``), and its dense oracle ``_dense_block_pos``.  The
same numpy inputs go to both: q, k, v, the cotangent of the output w and a
nonzero cotangent of the logsumexp g, standard normal at leading axes
(2, 3) and d = 8.

Tolerances:
- float32, against the reference kernel and the reference's dense block:
  out, lse, dq, dk, dv within 1e-5 absolute.  Both sides compute in float32
  and differ by sum order (64-key tiles here, the reference's 128-key
  tiles there) over at most 200 keys of unit-scale terms: a few float32
  ulps, measured <= 1.5e-6.
- bfloat16, against the reference kernel at the reference's tile
  (``KEY_TILE`` set to 128, so P rounds at the same running maximum): each
  row within 2^-6 of its largest value, as ``test_torch_flash_attention.py``
  argues.
- merging blocks against one pass over their union, and the very negative
  scores, against a float64 numpy oracle: 2e-6 and 2e-5 absolute, the
  reference tests' own limits (``tests/test_parallel_attention.py``).
"""

import functools
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from heat_tpu_torch.ops import flash_attention as fa
from test_torch_cuda_kernels import row_err

ref = importlib.import_module("heat_tpu.ops.flash_attention")

LEAD, D = (2, 3), 8
ATOL = 1e-5

# (Sq, Sk, query offset, key offset, causal, s_valid)
# (shapes and static arguments repeat where they can: each new one costs the
# reference a compile)
BLOCKS = {
    "diagonal": (48, 48, 64, 64, True, 160),
    "past": (48, 48, 64, 0, True, 160),
    "future": (48, 48, 0, 100, True, 160),  # every key after every query: O = 0, lse = -1e30
    "rect_ragged": (50, 70, 30, 0, True, 100),  # both sides padded to the tile
    "pad_keys": (50, 70, 0, 0, False, 60),  # keys at positions >= 60 are pad
    "unmasked": (48, 48, 0, 40, False, 2**31 - 1),  # the "no pad" sentinel: masked=False
    "ragged_full": (130, 75, 0, 0, False, 2**31 - 1),
}


def _inputs(Sq, Sk, qo, ko, dtype=np.float32, seed=0):
    rng = np.random.default_rng(seed)
    q, w = (rng.standard_normal(LEAD + (Sq, D)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal(LEAD + (Sk, D)).astype(np.float32) for _ in range(2))
    g = rng.standard_normal(LEAD + (Sq,)).astype(np.float32)
    return (q, k, v, w, g), np.arange(qo, qo + Sq, dtype=np.int32), np.arange(ko, ko + Sk, dtype=np.int32)


@functools.partial(jax.jit, static_argnames=("causal", "s_valid", "impl"))
def _reference_vjp(q, k, v, qpos, kpos, w, g, causal, s_valid, impl):
    s_cap = min(int(s_valid), 2**30)

    def block(q, k, v):
        if impl == "dense":
            return ref._dense_block_pos(q, k, v, qpos, kpos, causal, 0.3, s_cap, bool(causal) or s_cap < 2**30)
        return ref.flash_attention_block(q, k, v, qpos, kpos, causal=causal, scale=0.3, s_valid=s_valid, impl=impl)

    (out, lse), vjp = jax.vjp(block, q, k, v)
    return (out, lse, *vjp((w.astype(out.dtype), g)))


def _reference(arrs, qpos, kpos, causal, s_valid, impl, jdt=jnp.float32):
    """(out, lse, dq, dk, dv) of the reference block, cotangents (w, g)."""
    q, k, v, w = (jnp.asarray(a, jdt) for a in arrs[:4])
    return _reference_vjp(q, k, v, jnp.asarray(qpos), jnp.asarray(kpos), w, jnp.asarray(arrs[4]), causal=causal,
                          s_valid=s_valid, impl=impl)


def _port(arrs, qpos, kpos, causal, s_valid, tdt=torch.float32):
    """(out, lse, dq, dk, dv) of the port's block, cotangents (w, g)."""
    q, k, v, w = (torch.from_numpy(a).to(tdt) for a in arrs[:4])
    g = torch.from_numpy(arrs[4])
    q, k, v = (t.requires_grad_(True) for t in (q, k, v))
    counts = dict(fa.launch_counts)
    out, lse = fa.flash_attention_block(q, k, v, torch.from_numpy(qpos), torch.from_numpy(kpos), causal=causal,
                                        scale=0.3, s_valid=s_valid)
    assert fa.launch_counts == counts  # CPU tensors never launch a kernel
    assert out.shape == q.shape and out.dtype == tdt and lse.shape == q.shape[:-1] and lse.dtype == torch.float32
    grads = torch.autograd.grad((out * w).sum() + (lse * g).sum(), (q, k, v))
    return (out.detach(), lse.detach(), *grads)


def _assert_close(got, want, atol=ATOL):
    for name, a, b in zip(("out", "lse", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.float().numpy(), np.asarray(jnp.asarray(b, jnp.float32)), atol=atol, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("impl", ["interpret", "dense"])
@pytest.mark.parametrize("case", list(BLOCKS))
def test_block_matches_reference(case, impl):
    """Out, lse and the gradients under a nonzero lse cotangent, against the
    reference's Pallas positions kernels (interpret mode) and its dense block."""
    Sq, Sk, qo, ko, causal, s_valid = BLOCKS[case]
    arrs, qpos, kpos = _inputs(Sq, Sk, qo, ko, seed=Sq + Sk)
    got = _port(arrs, qpos, kpos, causal, s_valid)
    _assert_close(got, _reference(arrs, qpos, kpos, causal, s_valid, impl))
    if case == "future":
        assert not got[0].any() and bool((got[1] == fa.NO_MASS).all())
        assert not any(t.any() for t in got[2:])


def test_block_bfloat16_matches_reference_at_its_tile(monkeypatch):
    """bfloat16 at the reference's 128-key tile: P rounds at the same running maximum."""
    monkeypatch.setattr(fa, "KEY_TILE", 128)
    Sq, Sk, qo, ko, causal, s_valid = BLOCKS["rect_ragged"]
    arrs, qpos, kpos = _inputs(Sq, Sk, qo, ko, seed=5)
    got = _port(arrs, qpos, kpos, causal, s_valid, tdt=torch.bfloat16)
    want = _reference(arrs, qpos, kpos, causal, s_valid, "interpret", jdt=jnp.bfloat16)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=2e-5, rtol=2e-5, err_msg="lse")
    for name, a, b in zip(("out", "dq", "dk", "dv"), got[:1] + got[2:], want[:1] + want[2:]):
        err = row_err(a, torch.from_numpy(np.asarray(jnp.asarray(b, jnp.float32))))
        assert err <= 2.0**-6, f"{name}: rows differ by {err} of their largest value"


def test_dense_block_matches_reference_dense_block():
    """The port's dense oracle against the reference's, by plain autodiff on both sides."""
    Sq, Sk, qo, ko, causal, s_valid = BLOCKS["rect_ragged"]
    arrs, qpos, kpos = _inputs(Sq, Sk, qo, ko, seed=8)
    q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in arrs[:3])
    out, lse = fa._dense_block_pos(q, k, v, torch.from_numpy(qpos), torch.from_numpy(kpos), causal, 0.3, s_valid,
                                   True)
    grads = torch.autograd.grad((out * torch.from_numpy(arrs[3])).sum() + (lse * torch.from_numpy(arrs[4])).sum(),
                                (q, k, v))
    _assert_close((out.detach(), lse.detach(), *grads), _reference(arrs, qpos, kpos, causal, s_valid, "dense"))


def _oracle(q, k, v, causal):
    """float64 softmax attention over positions 0..S-1 (top-left causal)."""
    q, k, v = (np.asarray(t, np.float64) for t in (q, k, v))
    s = q @ k.swapaxes(-1, -2) / np.sqrt(q.shape[-1])
    if causal:
        s = np.where(np.tril(np.ones(s.shape[-2:], bool)), s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    return (p / p.sum(-1, keepdims=True)) @ v


def _merged(q, k, v, causal, cuts):
    """Blocks over the key ranges between ``cuts``, merged by their logsumexps."""
    S = q.shape[-2]
    pos = torch.arange(S)
    o = torch.zeros(q.shape)
    lse = torch.full(q.shape[:-1], fa.NO_MASS)
    for a, b in zip(cuts[:-1], cuts[1:]):
        ob, lb = fa.flash_attention_block(q, k[..., a:b, :], v[..., a:b, :], pos, pos[a:b], causal=causal,
                                          scale=q.shape[-1] ** -0.5, s_valid=S)
        new = torch.logaddexp(lse, lb)
        o = o * torch.exp(lse - new)[..., None] + ob * torch.exp(lb - new)[..., None]
        lse = new
    return o


def test_block_merge_identity():
    """Two disjoint key sets merged by logsumexp equal their union (the
    reference's ``test_block_merge_identity``), and so do three."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.normal(size=(16, 8)).astype(np.float32)) for _ in range(3))
    pos = torch.arange(16)
    full, _ = fa._dense_block_pos(q, k, v, pos, pos, True, 0.5, 16, True)
    o1, l1 = fa.flash_attention_block(q, k[:8], v[:8], pos, pos[:8], causal=True, scale=0.5, s_valid=16)
    o2, l2 = fa.flash_attention_block(q, k[8:], v[8:], pos, pos[8:], causal=True, scale=0.5, s_valid=16)
    lse = torch.logaddexp(l1, l2)
    merged = o1 * torch.exp(l1 - lse)[..., None] + o2 * torch.exp(l2 - lse)[..., None]
    np.testing.assert_allclose(merged.numpy(), full.numpy(), atol=2e-6)
    np.testing.assert_allclose(_merged(q, k, v, True, [0, 5, 11, 16]).numpy(), _oracle(q, k, v, True), atol=2e-6)


def test_very_negative_scores_survive_merge():
    """Rows whose true logsumexp is far below -62 keep their output through
    the merge with fully-masked blocks (the reference's
    ``test_very_negative_scores_survive_merge``): the -1e30 sentinel of an
    empty block carries no mass."""
    rng = np.random.default_rng(11)
    S, d, a = 24, 8, 30.0
    q = torch.full((1, S, d), a / np.sqrt(d))
    k = -q  # every score is about -a^2 / sqrt(d), ~ -318
    v = torch.from_numpy(rng.normal(size=(1, S, d)).astype(np.float32))
    np.testing.assert_allclose(_merged(q, k, v, True, [0, 12, 24]).numpy(), _oracle(q, k, v, True), atol=2e-5)


def test_block_argument_checks():
    q = torch.zeros((2, 16, 8))
    with pytest.raises(ValueError):
        fa.flash_attention_block(q, q[:, :8, :4], q[:, :8, :4], torch.arange(16), torch.arange(8), causal=True,
                                 scale=1.0, s_valid=16)
    with pytest.raises(ValueError):  # positions of the wrong length
        fa.flash_pos_fwd(q, q, q, torch.arange(8, dtype=torch.int32), torch.arange(16, dtype=torch.int32), True,
                         1.0, 16, True)
    with pytest.raises(ValueError):  # positions of the wrong dtype
        fa.flash_pos_fwd(q, q, q, torch.arange(16), torch.arange(16), True, 1.0, 16, True)
