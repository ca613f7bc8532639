"""The port's sequence-parallel ring on two gloo processes, against heat_tpu.

One spawn of two processes (``torch.multiprocessing``, spawn, gloo on the
CPU) runs, each rank on its HeAT chunk of the sequence (the first S % 2
ranks hold one row more):
- ``ring_attention`` forward and the gradients of q, k, v: even and ragged
  S, causal and full, cross-attention (another key/value length), the
  ``'auto'`` block (the positions kernels' plain versions here) and
  ``'dense'``, and scores so negative that a merge against an empty
  block's -1e30 sentinel would crush them;
- ``MultiheadAttention(comm)`` with rotary positions, and with grouped-query
  heads (``num_kv_heads=2``): output, input gradient and every parameter's
  gradient summed over the ranks;
- a small ``TransformerLM(comm)`` (vocab 61, E 32, 4 heads, depth 2): logits,
  and one step's loss (the local sum, Allreduced, over the global token
  count) and every parameter's gradient summed over the ranks; the step
  makes one Allgather of the ranks' lengths, not one a block.
The parent gathers the ranks' blocks and holds them against the reference
on its 8-device CPU mesh (its own ring, parameters carried across by
``utils.convert``) and against the port at world size 1.

Tolerances, float32 throughout: 2e-5 absolute on outputs, logits and the
loss (relative 1e-6), 5e-5 on gradients.  The ring merges the blocks of
the two ranks (the reference: of eight devices) by logsumexp in another
order than a single pass, and the backward adds the blocks' gradients in
another order too; each is a few float32 ulps of unit-scale terms over at
most 30 keys, and the LM's two blocks carry them through LayerNorms and
GEMMs of 32 to 128 terms.

This module imports neither JAX nor heat_tpu at the top: the spawned
workers import it and need only torch.  The parent's functions import
both.
"""

import functools
import importlib
import pathlib

import numpy as np
import torch

LEAD, D = (2, 3), 8
# name: (S, S_kv, causal, kernel)
RING_CASES = {
    "even_causal": (24, 24, True, "auto"),
    "ragged_full": (23, 23, False, "auto"),
    "ragged_causal_dense": (23, 23, True, "dense"),
    "even_full_dense": (24, 24, False, "dense"),
    "cross_full": (20, 13, False, "auto"),
    "cross_causal": (16, 30, True, "auto"),
    "very_negative": (24, 24, True, "auto"),
}
E, H, V, DEPTH, MAX_LEN = 32, 4, 61, 2, 64
MHA_CASES = {"rope": dict(rope=True), "gqa_rope": dict(rope=True, num_kv_heads=2)}
MHA_SHAPE = (2, 19, E)  # a ragged sequence: 10 and 9 rows
LM_TOKENS = (2, 26)  # 25 input positions: 13 and 12
ATOL, GRAD_ATOL = 2e-5, 5e-5


def _ring_inputs(name):
    """q, k, v and the output cotangent w, global, as numpy float32."""
    S, S_kv = RING_CASES[name][:2]
    rng = np.random.default_rng(S * 31 + S_kv)
    q, w = (rng.standard_normal(LEAD + (S, D)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal(LEAD + (S_kv, D)).astype(np.float32) for _ in range(2))
    if name == "very_negative":  # anticorrelated q and k: every score ~ -30^2 / sqrt(8)
        q = np.full(q.shape, 30.0 / np.sqrt(D), np.float32)
        k = -q
    return q, k, v, w


def _mha_inputs():
    rng = np.random.default_rng(19)
    return tuple(rng.standard_normal(MHA_SHAPE).astype(np.float32) for _ in range(2))


def _lm_tokens():
    return np.random.default_rng(26).integers(0, V, LM_TOKENS).astype(np.int64)


def _local(comm, a, axis):
    """This rank's HeAT chunk of the global numpy array ``a`` along ``axis``."""
    return torch.from_numpy(np.ascontiguousarray(a[comm.chunk(a.shape, axis)[2]]))


def _lm_step(lm, comm, tokens):
    """Logits, the global mean loss and every parameter's gradient summed
    over the ranks, from this rank's block of the (B, S + 1) tokens."""
    from heat_tpu_torch.nn.functional import cross_entropy

    inp, tgt = _local(comm, tokens[:, :-1], 1), _local(comm, tokens[:, 1:], 1)
    logits = lm(inp)
    local = cross_entropy(logits.reshape(-1, V), tgt.reshape(-1), reduction="sum")
    count = tokens[:, 1:].size  # the global token count
    lm.zero_grad(set_to_none=True)
    (local / count).backward()
    grads = {n: comm.Allreduce(p.grad.clone()).numpy() for n, p in lm.named_parameters()}
    loss = float(comm.Allreduce(local.detach().clone())) / count
    return logits.detach().numpy(), loss, grads


def _run(comm, out_dir):
    """Every case on this rank: {name: array} of its local results."""
    from heat_tpu_torch.parallel import ring_attention
    from heat_tpu_torch.utils import convert

    ra = importlib.import_module("heat_tpu_torch.parallel.ring_attention")
    res = {}
    for name, (S, S_kv, causal, kernel) in RING_CASES.items():
        q, k, v, w = (_local(comm, a, 2) for a in _ring_inputs(name))
        q, k, v = (t.requires_grad_(True) for t in (q, k, v))
        out = ring_attention(q, k, v, comm, causal=causal, kernel=kernel)
        grads = torch.autograd.grad((out * w).sum(), (q, k, v))
        for key, t in zip(("out", "dq", "dk", "dv"), (out, *grads)):
            res[f"{name}/{key}"] = t.detach().numpy()
    x, w = _mha_inputs()
    for name, kw in MHA_CASES.items():
        params = convert._unflatten(dict(np.load(pathlib.Path(out_dir) / f"mha_{name}.npz")))
        pm = convert.multihead_attention_from_reference(params, embed_dim=E, num_heads=H, comm=comm, device="cpu",
                                                        **kw)
        xl = _local(comm, x, 1).requires_grad_(True)
        y = pm(xl, causal=True)
        (y * _local(comm, w, 1)).sum().backward()
        res[f"mha_{name}/y"], res[f"mha_{name}/dx"] = y.detach().numpy(), xl.grad.numpy()
        for n, p in pm.named_parameters():
            res[f"mha_{name}/grad/{n}"] = comm.Allreduce(p.grad.clone()).numpy()
    params = convert._unflatten(dict(np.load(pathlib.Path(out_dir) / "lm.npz")))
    lm = convert.transformer_lm_from_reference(params, vocab_size=V, embed_dim=E, num_heads=H, depth=DEPTH,
                                               max_len=MAX_LEN, comm=comm, device="cpu")
    gathers, allgather = [], comm.Allgather
    comm.Allgather = lambda *a, **kw: gathers.append(1) or allgather(*a, **kw)
    try:
        logits, loss, grads = _lm_step(lm, comm, _lm_tokens())
    finally:
        del comm.Allgather
    res["lm_allgathers"] = np.array(len(gathers))
    res["lm/logits"], res["lm/loss"] = logits, np.float64(loss)
    res.update({f"lm/grad/{n}": g for n, g in grads.items()})
    res["path_counts"] = np.array([ra.path_counts["ring"], ra.path_counts["global"]])
    return res


def _worker(rank, out_dir):
    import heat_tpu_torch as ht

    # a file store in the test's directory: no port to pick, so no race for one
    ht.core.bootstrap.init_distributed(f"file://{out_dir}/store", world_size=2, rank=rank, backend="gloo",
                                       timeout_s=60)
    try:
        ht.use_device("cpu")
        comm = ht.core.communication.get_comm()
        res = _run(comm, out_dir)
        res["send"] = comm.Send(torch.tensor([rank, 10 + rank]), shift=1).numpy()  # from the other rank
        res["transport"] = np.array(comm.transport(torch.zeros(1)))
        np.savez(pathlib.Path(out_dir) / f"rank{rank}.npz", **res)
    finally:
        ht.core.bootstrap.finalize_distributed()


def _params(tmp_path):
    """Parameters of the MHA cases and the LM, made by the port from torch
    seeds and carried to the reference by ``utils.convert``: saved for the
    workers (numpy, by dotted path) and returned as reference pytrees."""
    import heat_tpu_torch as ht
    from heat_tpu_torch.utils import convert

    mods = {}
    for i, (name, kw) in enumerate(MHA_CASES.items()):
        torch.manual_seed(40 + i)
        mods[f"mha_{name}"] = ht.nn.MultiheadAttention(E, H, device="cpu", **kw)
    torch.manual_seed(42)
    mods["lm"] = ht.nn.models.TransformerLM(V, E, H, depth=DEPTH, max_len=MAX_LEN, device="cpu")
    trees = {name: convert.to_reference(m) for name, m in mods.items()}
    for name, tree in trees.items():
        np.savez(tmp_path / f"{name}.npz", **convert._flatten(tree))
    return trees


def _reference_results(trees):
    """The reference's global results of every case, on its 8-device mesh."""
    import jax
    import jax.numpy as jnp

    import heat_tpu
    from heat_tpu.nn import attention as ref_attention
    from heat_tpu.nn import models as ref_models
    from heat_tpu.parallel.ring_attention import ring_attention

    comm = heat_tpu.communication.get_comm()

    @functools.partial(jax.jit, static_argnames=("causal", "kernel"))
    def ring_vjp(q, k, v, w, causal, kernel):
        out, vjp = jax.vjp(lambda q, k, v: ring_attention(comm.shard(q, 2), comm.shard(k, 2), comm.shard(v, 2), comm,
                                                          causal=causal, kernel=kernel), q, k, v)
        return (out, *vjp(w))

    want = {}
    for name, (S, S_kv, causal, kernel) in RING_CASES.items():
        got = ring_vjp(*(jnp.asarray(a) for a in _ring_inputs(name)), causal=causal, kernel=kernel)
        want.update({f"{name}/{key}": np.asarray(a) for key, a in zip(("out", "dq", "dk", "dv"), got)})
    x, w = (jnp.asarray(a) for a in _mha_inputs())
    for name, kw in MHA_CASES.items():
        rm = ref_attention.MultiheadAttention(E, H, comm=comm, **kw)

        @jax.jit
        def mha_vjp(p, x, w):
            y, vjp = jax.vjp(lambda p, x: rm.apply(p, x, causal=True), p, x)
            return (y, *vjp(w))

        y, gp, gx = mha_vjp(trees[f"mha_{name}"], x, w)
        want[f"mha_{name}/y"], want[f"mha_{name}/dx"] = np.asarray(y), np.asarray(gx)
        want.update({f"mha_{name}/grad/{n}": g for n, g in _flat(gp).items()})
    rm = ref_models.TransformerLM(V, E, H, depth=DEPTH, max_len=MAX_LEN, comm=comm)

    @jax.jit
    def lm_grad(p, tok):
        def loss_fn(p):
            logits = rm.apply(p, tok[:, :-1])
            return heat_tpu.nn.functional.cross_entropy(logits.reshape(-1, V), tok[:, 1:].reshape(-1)), logits

        return jax.value_and_grad(loss_fn, has_aux=True)(p)

    (loss, logits), grads = lm_grad(trees["lm"], jnp.asarray(_lm_tokens(), jnp.int32))
    want["lm/logits"], want["lm/loss"] = np.asarray(logits), float(loss)
    want.update({f"lm/grad/{n}": g for n, g in _flat(grads).items()})
    return want


def _flat(tree):
    import jax

    from heat_tpu_torch.utils import convert

    return convert._flatten(jax.tree.map(np.asarray, tree))


def _world_one(tmp_path):
    """The port's results at world size 1 (no process group), on the CPU."""
    import heat_tpu_torch as ht
    from heat_tpu_torch.parallel import ring_attention
    from heat_tpu_torch.utils import convert

    comm = ht.core.communication.Communication()
    x = torch.arange(3)
    assert comm.Send(x, shift=1) is x and comm.transport(x) == "local"  # world size 1: the identity
    one = {}
    for name, (S, S_kv, causal, kernel) in RING_CASES.items():
        q, k, v, w = (torch.from_numpy(a) for a in _ring_inputs(name))
        q, k, v = (t.requires_grad_(True) for t in (q, k, v))
        out = ring_attention(q, k, v, comm, causal=causal, kernel=kernel)
        grads = torch.autograd.grad((out * w).sum(), (q, k, v))
        for key, t in zip(("out", "dq", "dk", "dv"), (out, *grads)):
            one[f"{name}/{key}"] = t.detach().numpy()
    x, w = (torch.from_numpy(a) for a in _mha_inputs())
    for name, kw in MHA_CASES.items():
        params = convert._unflatten(dict(np.load(tmp_path / f"mha_{name}.npz")))
        pm = convert.multihead_attention_from_reference(params, embed_dim=E, num_heads=H, device="cpu", **kw)
        xg = x.clone().requires_grad_(True)
        y = pm(xg, causal=True)
        (y * w).sum().backward()
        one[f"mha_{name}/y"], one[f"mha_{name}/dx"] = y.detach().numpy(), xg.grad.numpy()
        one.update({f"mha_{name}/grad/{n}": p.grad.numpy() for n, p in pm.named_parameters()})
    params = convert._unflatten(dict(np.load(tmp_path / "lm.npz")))
    lm = convert.transformer_lm_from_reference(params, vocab_size=V, embed_dim=E, num_heads=H, depth=DEPTH,
                                               max_len=MAX_LEN, device="cpu")
    logits, loss, grads = _lm_step(lm, comm, _lm_tokens())
    one["lm/logits"], one["lm/loss"] = logits, loss
    one.update({f"lm/grad/{n}": g for n, g in grads.items()})
    return one


def _gathered(ranks, key):
    """The ranks' blocks of ``key`` joined along the sequence axis (or the
    summed gradients and the loss, the same on every rank)."""
    a, b = (r[key] for r in ranks)
    if "/grad/" in key or key == "lm/loss":
        np.testing.assert_array_equal(a, b, err_msg=f"{key} differs between the ranks")
        return a
    axis = 2 if key.split("/")[0] in RING_CASES else 1
    return np.concatenate([a, b], axis=axis)


def test_two_rank_ring_matches_reference_and_world_one(tmp_path):
    trees = _params(tmp_path)
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_worker, args=(r, str(tmp_path))) for r in range(2)]
    for p in procs:
        p.start()
    try:
        want = _reference_results(trees)  # while the workers run
        one = _world_one(tmp_path)
    finally:
        for p in procs:
            p.join(timeout=120)
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(5)
    assert [p.exitcode for p in procs] == [0, 0]
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(2)]

    # the ring shift: each rank holds the other's tensor, sent over gloo
    assert [list(r.pop("send")) for r in ranks] == [[1, 11], [0, 10]]
    assert [str(r.pop("transport")) for r in ranks] == ["gloo", "gloo"]
    # every ring_attention call and every block's attention took the ring
    n_ring = len(RING_CASES) + len(MHA_CASES) + DEPTH
    assert [list(r.pop("path_counts")) for r in ranks] == [[n_ring, 0]] * 2
    # the LM gathers the ranks' lengths once a forward, for all its blocks
    assert [int(r.pop("lm_allgathers")) for r in ranks] == [1, 1]
    # HeAT's chunk: rank 0 holds the extra row of a ragged sequence
    assert [r["ragged_full/out"].shape[2] for r in ranks] == [12, 11]
    assert [r["lm/logits"].shape[1] for r in ranks] == [13, 12]
    assert set(ranks[0]) == set(want) == set(one)
    for key in want:
        got = _gathered(ranks, key)
        if key.startswith("very_negative/d"):
            # the exact gradients cancel (every key is the same vector): both sides give float32 noise of the
            # scores' -318 scale, only required finite
            assert np.isfinite(got).all()
            continue
        atol = GRAD_ATOL if "/d" in key or "/grad/" in key else ATOL
        rtol = 1e-6 if key == "lm/loss" else 0.0
        np.testing.assert_allclose(got, want[key], atol=atol, rtol=rtol, err_msg=f"{key} vs the reference")
        np.testing.assert_allclose(got, one[key], atol=atol, rtol=rtol, err_msg=f"{key} vs world size 1")
    ref_out = want["very_negative/out"]
    assert np.abs(ref_out).max() > 0.1  # the merge kept the rows' mass
