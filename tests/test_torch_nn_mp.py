"""heat_tpu_torch's expert and pipeline parallelism and the ring models on four gloo processes.

One module-scoped spawn of 4 ranks (``torch.multiprocessing``, spawn) runs
every case of ``CASES``; each case is one test here, held against the
reference on a mesh of 4 CPU devices or against the port at world size 1.
The reference's parameters (its own ``init``) and the inputs are made here
and handed to the ranks, which never import JAX.

- ``MoE(comm=)`` over 4 ranks, n = 24 tokens (6 a rank) and capacity
  binding (factor 0.5: claims dropped), against the reference's
  ``MoE(comm=)`` on ``Mesh(devices[:4], ("ep",))``: output, input and
  parameter gradients, the dropped claims;
- ragged n = 23 (6, 6, 6, 5) at a capacity that cannot bind, against world
  size 1;
- dp x ep as 2 x 2 subgroups (``comm.Split``), the reference's
  ``test_dp_ep_composition`` setup (42 ragged tokens, capacity 64): expert
  gradients summed over dp, the router's over every rank;
- ``Pipelined`` over 4 stages (8 blocks, 2 a rank) with M = 4 and 8
  microbatches, and M = 4 under ``remat``, against the reference's
  ``Pipelined`` on 4 devices: the output on every rank and each stage's
  gradients; dp x pp as 2 x 2 against the reference's (2, 2) ('dp', 'pp')
  mesh with ``batch_axis='dp'``;
- ``TransformerLM(comm=, num_experts=4)``: the ring and expert parallelism
  together on a ragged sequence (14: 4, 4, 3, 3), capacity that cannot
  bind, against world size 1; ``transformer_decoder(comm=)`` over ragged
  target (10) and memory (7) blocks against world size 1;
- experts that do not divide the ranks warn and run the dense path.

Tolerances, float32: MoE rtol 1e-5 of each tensor's largest magnitude
(the k terms and the expert GEMMs in another order, the Alltoall exact);
the pipelines 1e-5 (the same blocks, the broadcast exact); the ring models
2e-5 (the ring's flash blocks add in another order, as in
``test_torch_ring_attention``).
"""

import pathlib
import socket
import warnings

import numpy as np
import pytest
import torch

WORLD = 4
D, HID = 8, 16
LM = dict(vocab_size=29, embed_dim=16, num_heads=4, depth=2, max_len=32, num_experts=4, moe_top_k=2,
          moe_capacity_factor=4.0)
DEC = dict(embed_dim=16, num_heads=4, depth=2)


class _ResBlock(torch.nn.Module):
    """The reference test's block: x + tanh(Linear(x))."""

    def __init__(self, d=D):
        super().__init__()
        import heat_tpu_torch as ht

        self.lin = ht.nn.Linear(d, d, device="cpu")

    def forward(self, x):
        return x + torch.tanh(self.lin(x))


def _data():
    rng = np.random.default_rng(21)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"x24": f(24, D), "w24": f(24, D), "x23": f(23, D), "w23": f(23, D), "x42": f(6, 7, D),
            "w42": f(6, 7, D), "xp": f(16, D), "wp": f(16, D), "tok": rng.integers(0, 29, (2, 15)),
            "dx": f(2, 10, 16), "dm": f(2, 7, 16), "dw": f(2, 10, 16)}


def _moe_config(cf, E=4):
    return dict(embed_dim=D, num_experts=E, hidden_dim=HID, top_k=2, capacity_factor=cf)


def _np(t):
    return t.detach().numpy().copy()


# ---------------------------------------------------------------------- #
# the cases, run on every rank (and at world size 1 here where stated)
# ---------------------------------------------------------------------- #
def _moe_run(ht, init, x, w, cf, ep=None, dp=None, E=4):
    """This rank's chunk of the tokens through ``MoE(comm=ep)``; the global
    output, input gradient and parameter gradients (expert shards summed
    over ``dp`` and gathered over ``ep``, the router summed over all)."""
    from heat_tpu_torch.utils import convert

    world = ht.get_comm()
    ep = world if ep is None else ep
    x2d, w2d = x.reshape(-1, D), w.reshape(-1, D)
    sl = world.chunk(x2d.shape, 0)[2][0]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        moe = convert.moe_from_reference(init["moe"] if E == 4 else init["moe3"], **_moe_config(cf, E), comm=ep,
                                         device="cpu")
        xl = torch.from_numpy(x2d[sl]).requires_grad_(True)
        y = moe(xl)
    (y * torch.from_numpy(w2d[sl])).sum().backward()
    grads = {"router": world.Allreduce(moe.router.grad.clone())}
    for name in ("w1", "b1", "w2", "b2"):
        g = getattr(moe, name).grad.clone()
        if moe.sharded:
            if dp is not None:
                dp.Allreduce(g)
            g = torch.cat(ep.Allgather(g))
        else:
            world.Allreduce(g)
        grads[name] = g
    stats = world.Allreduce(moe.route_stats.clone())
    return {"y": _np(world.Allgatherv(y.detach(), 0)), "dx": _np(world.Allgatherv(xl.grad, 0)),
            "grads": {k: _np(v) for k, v in grads.items()}, "dropped": int(stats[0]), "claims": int(stats[1]),
            "sharded": moe.sharded, "local_experts": moe.local_experts,
            "warnings": [str(c.message) for c in caught]}


def _dp_ep(ht, init, d):
    world = ht.get_comm()
    ep, dp = world.Split(world.rank // 2), world.Split(world.rank % 2)
    return _moe_run(ht, init, d["x42"], d["w42"], 64.0, ep=ep, dp=dp)


def _pipe_run(ht, init, d, M, remat=False):
    from heat_tpu_torch.utils import convert

    comm = ht.get_comm()
    pm = convert.pipelined_from_reference(init["pipe8"], _ResBlock(), 8, comm, n_microbatches=M, remat=remat)
    y = pm(torch.from_numpy(d["xp"]))
    (y * torch.from_numpy(d["wp"])).sum().backward()
    return {"y": _np(y), "grads": {n: _np(p.grad) for n, p in pm.named_parameters()}, "blocks": len(pm.blocks)}


def _dp_pp(ht, init, d):
    """Two pipelines of 2 stages, each on its half of the batch; the stage
    gradients summed over the data-parallel pair."""
    from heat_tpu_torch.utils import convert

    world = ht.get_comm()
    pp, dp = world.Split(world.rank // 2), world.Split(world.rank % 2)
    pm = convert.pipelined_from_reference(init["pipe4"], _ResBlock(), 4, pp, n_microbatches=2)
    half = slice(8 * (world.rank // 2), 8 * (world.rank // 2 + 1))
    y = pm(torch.from_numpy(d["xp"][half]))
    (y * torch.from_numpy(d["wp"][half])).sum().backward()
    return {"y": _np(y), "grads": {n: _np(dp.Allreduce(p.grad.clone())) for n, p in pm.named_parameters()},
            "stage": pp.rank}


def _lm_step(ht, init, d, comm):
    """One step of the MoE LM over ``comm`` (this rank's block of the
    sequence): global-mean loss, logits and full gradients."""
    from heat_tpu_torch.nn import moe as moe_mod
    from heat_tpu_torch.utils import convert

    lm = convert.transformer_lm_from_reference(init["lm"], **LM, comm=comm, device="cpu")
    tok = torch.from_numpy(d["tok"]).long()
    inp, tgt = tok[:, :-1], tok[:, 1:]
    S = inp.shape[1]
    lo, n, _ = comm.chunk((S,), 0)
    n = n[0]
    logits = lm(inp[:, lo:lo + n])
    local = ht.nn.functional.cross_entropy(logits.reshape(-1, LM["vocab_size"]), tgt[:, lo:lo + n].reshape(-1),
                                           reduction="sum")
    count = tgt.numel()
    (local / count).backward()
    rep, shards = moe_mod.split_parameters(lm)
    ht.core.collectives.bucketed_grad_allreduce(comm, [p.grad for p in rep], op="sum")
    ids = {id(p) for p in shards}
    grads = {name: _np(torch.cat(comm.Allgather(p.grad)) if id(p) in ids else p.grad)
             for name, p in lm.named_parameters()}
    return {"loss": float(comm.Allreduce(local.detach().clone())) / count,
            "logits": _np(comm.Allgatherv(logits.detach(), 1)), "grads": grads,
            "sharded": [b.ff.sharded for b in lm.blocks]}


def _decoder_step(ht, init, d, comm):
    from heat_tpu_torch.utils import convert

    dec = convert.transformer_decoder_from_reference(init["dec"], **DEC, comm=comm, device="cpu")
    (xlo, xn, _), (mlo, mn, _) = comm.chunk((10,), 0), comm.chunk((7,), 0)
    x = torch.from_numpy(d["dx"][:, xlo:xlo + xn[0]])
    mem = torch.from_numpy(d["dm"][:, mlo:mlo + mn[0]]).requires_grad_(True)
    y = dec(x, mem)
    (y * torch.from_numpy(d["dw"][:, xlo:xlo + xn[0]])).sum().backward()
    return {"y": _np(comm.Allgatherv(y.detach(), 1)), "dmem": _np(comm.Allgatherv(mem.grad, 1)),
            "grads": {n: _np(comm.Allreduce(p.grad.clone())) for n, p in dec.named_parameters()},
            "lengths": [xn[0], mn[0]]}


CASES = {
    "ep_binding_divisible": lambda ht, init, d: _moe_run(ht, init, d["x24"], d["w24"], 0.5),
    "ep_ragged_not_binding": lambda ht, init, d: _moe_run(ht, init, d["x23"], d["w23"], 4.0),
    "dp_x_ep": _dp_ep,
    "moe_indivisible_warns": lambda ht, init, d: _moe_run(ht, init, d["x23"], d["w23"], 4.0, E=3),
    "pipeline_M4": lambda ht, init, d: _pipe_run(ht, init, d, 4),
    "pipeline_M8": lambda ht, init, d: _pipe_run(ht, init, d, 8),
    "pipeline_M4_remat": lambda ht, init, d: _pipe_run(ht, init, d, 4, remat=True),
    "dp_x_pp": _dp_pp,
    "lm_ring_ep": lambda ht, init, d: _lm_step(ht, init, d, ht.get_comm()),
    "decoder_ring": lambda ht, init, d: _decoder_step(ht, init, d, ht.get_comm()),
}


def _worker(rank, port, out_dir):
    import heat_tpu_torch as ht

    torch.set_num_threads(1)  # four ranks share the host's cores: one intra-op thread each

    ht.core.bootstrap.init_distributed(f"tcp://localhost:{port}", world_size=WORLD, rank=rank, backend="gloo",
                                       timeout_s=120)
    warnings.simplefilter("ignore")
    try:
        ht.use_device("cpu")
        init = torch.load(pathlib.Path(out_dir) / "init.pt", weights_only=False)
        d, res = _data(), {}
        for name, fn in CASES.items():
            try:
                res[name] = fn(ht, init, d)
            except Exception as e:  # recorded per case, so one fault fails one test
                import traceback

                res[name] = {"error": f"{type(e).__name__}: {e}\n{traceback.format_exc()}"}
        torch.save(res, pathlib.Path(out_dir) / f"rank{rank}.pt")
    finally:
        ht.core.bootstrap.finalize_distributed()


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


# ---------------------------------------------------------------------- #
# the reference (parent process)
# ---------------------------------------------------------------------- #
class _Ref:
    """The reference's parameters, and its results on meshes of 4 CPU devices."""

    def __init__(self):
        import jax
        import jax.numpy as jnp
        from jax.sharding import Mesh

        import heat_tpu as R
        from heat_tpu.nn import models as ref_models

        self.jax, self.jnp, self.R = jax, jnp, R
        np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731

        class RefBlock(R.nn.modules.Module):
            def __init__(self):
                self.lin = R.nn.Linear(D, D)

            def init(self, key):
                return {"lin": self.lin.init(key)}

            def apply(self, params, x, **kw):
                return x + jnp.tanh(self.lin.apply(params["lin"], x))

        self.block = RefBlock()
        self.ep_comm = R.communication.Communication(Mesh(np.asarray(jax.devices()[:4]), ("ep",)), axis="ep")
        self.pp_comm = R.communication.Communication(Mesh(np.asarray(jax.devices()[:4]), ("pp",)), axis="pp")
        self.dp_pp_comm = R.communication.Communication(
            Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("dp", "pp")), axis="pp")
        self.lm = ref_models.TransformerLM(**LM)
        self.dec = ref_models.transformer_decoder(**DEC)
        self.init = {
            "moe": np_tree(R.nn.MoE(**_moe_config(1.0)).init(jax.random.key(0))),
            "moe3": np_tree(R.nn.MoE(D, 3, hidden_dim=HID).init(jax.random.key(1))),
            "pipe8": np_tree(R.nn.Pipelined(self.block, 8, comm=None).init(jax.random.key(2))),
            "pipe4": np_tree(R.nn.Pipelined(self.block, 4, comm=None).init(jax.random.key(3))),
            "lm": np_tree(self.lm.init(jax.random.key(4))),
            "dec": np_tree(self.dec.init(jax.random.key(5))),
        }

    def vjp(self, fn, params, x, w):
        """fn(params, x) and its vjp of w, as one compiled program."""
        jax, jnp = self.jax, self.jnp

        def both(p, xs, c):
            y, vjp = jax.vjp(fn, p, xs)
            return y, vjp(c)

        y, (g, dx) = jax.jit(both)(params, jnp.asarray(x), jnp.asarray(w))
        return np.asarray(y), jax.tree.map(np.asarray, g), np.asarray(dx)

    def moe_ep(self, x, w, cf):
        m = self.R.nn.MoE(**_moe_config(cf), comm=self.ep_comm)
        return self.vjp(lambda p, xs: m.apply(p, xs), self.init["moe"], x, w)

    def moe_dense(self, x, w, cf, E=4):
        m = self.R.nn.MoE(**_moe_config(cf, E))
        return self.vjp(lambda p, xs: m.apply(p, xs), self.init["moe" if E == 4 else "moe3"], x, w)

    def pipeline(self, x, w, depth, comm, **kw):
        m = self.R.nn.Pipelined(self.block, depth, comm, **kw)
        return self.vjp(lambda p, xs: m.apply(p, xs), self.init[f"pipe{depth}"], x, w)


@pytest.fixture(scope="module")
def ref():
    return _Ref()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, ref):
    out = tmp_path_factory.mktemp("nn_mp")
    torch.save(ref.init, out / "init.pt")
    ctx = torch.multiprocessing.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_worker, args=(r, port, str(out))) for r in range(WORLD)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=300)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(5)
    assert [p.exitcode for p in procs] == [0] * WORLD
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]


@pytest.fixture(scope="module")
def world_one(ref):
    """The ring models at world size 1 (the port, on the CPU)."""
    import heat_tpu_torch as ht

    prev = ht.get_device()
    ht.use_device("cpu")
    try:
        d, one = _data(), ht.core.communication.Communication()
        return {"lm": _lm_step(ht, ref.init, d, one), "dec": _decoder_step(ht, ref.init, d, one),
                "moe23": _moe_run(ht, ref.init, d["x23"], d["w23"], 4.0)}
    finally:
        ht.use_device(prev)


def _ok(res, name):
    assert "error" not in res, f"{name}: {res.get('error')}"
    return res


def _close(got, want, rtol, msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol, atol=rtol * max(float(np.abs(want).max()), 1e-30),
                               err_msg=msg)


def _moe_close(res, y, g, dx, msg):
    _close(res["y"], y.reshape(res["y"].shape), 1e-5, msg)
    _close(res["dx"], dx.reshape(res["dx"].shape), 1e-5, msg)
    for k in ("router", "w1", "b1", "w2", "b2"):
        _close(res["grads"][k], g[k], 1e-5, f"{msg} {k}")


def test_ep_binding_capacity_matches_reference_ep(ranks, ref):
    d = _data()
    y, g, dx = ref.moe_ep(d["x24"], d["w24"], 0.5)
    for rank, res in enumerate(ranks):
        res = _ok(res["ep_binding_divisible"], "ep")
        assert res["sharded"] and res["local_experts"] == 1
        assert res["dropped"] > 0 and res["claims"] == 48
        _moe_close(res, y, g, dx, f"rank {rank}")


def test_ep_ragged_matches_world_one(ranks, world_one, ref):
    one = world_one["moe23"]
    d = _data()
    y, g, dx = ref.moe_dense(d["x23"], d["w23"], 4.0)
    _moe_close(one, y, g, dx, "world 1 vs reference")
    for rank, res in enumerate(ranks):
        res = _ok(res["ep_ragged_not_binding"], "ep ragged")
        assert res["dropped"] == 0 and res["claims"] == 46
        _moe_close(res, one["y"], one["grads"], one["dx"], f"rank {rank}")


def test_dp_x_ep_matches_reference(ranks, ref):
    """The reference's test_dp_ep_composition: dense and dp x ep agree."""
    d = _data()
    y, g, dx = ref.moe_dense(d["x42"], d["w42"], 64.0)
    for rank, res in enumerate(ranks):
        res = _ok(res["dp_x_ep"], "dp x ep")
        assert res["sharded"] and res["local_experts"] == 2
        _moe_close(res, y, g, dx, f"rank {rank}")


def test_indivisible_experts_warn_and_run_dense(ranks, ref):
    d = _data()
    y, g, dx = ref.moe_dense(d["x23"], d["w23"], 4.0, E=3)
    for res in ranks:
        res = _ok(res["moe_indivisible_warns"], "indivisible")
        assert not res["sharded"] and res["local_experts"] == 3
        assert any("not divisible by mesh size 4" in w and "ROUTING NUMERICS" in w for w in res["warnings"])
        # capacity 4.0 does not bind: the ranks' dense paths give the reference's dense result
        _moe_close(res, y, g, dx, "indivisible")


@pytest.mark.parametrize("case,M,remat", [("pipeline_M4", 4, False), ("pipeline_M8", 8, False),
                                          ("pipeline_M4_remat", 4, True)])
def test_pipeline_matches_reference(ranks, ref, case, M, remat):
    d = _data()
    y, g, _ = ref.pipeline(d["xp"], d["wp"], 8, ref.pp_comm, n_microbatches=M, remat=remat)
    for rank, res in enumerate(ranks):
        res = _ok(res[case], case)
        assert res["blocks"] == 2
        _close(res["y"], y, 1e-5, f"{case} rank {rank} output")
        for i in range(2):
            for k in ("weight", "bias"):
                _close(res["grads"][f"blocks.{i}.lin.{k}"], g["lin"][k][2 * rank + i], 1e-5,
                       f"{case} rank {rank} block {2 * rank + i} {k}")


def test_dp_x_pp_matches_reference(ranks, ref):
    d = _data()
    y, g, _ = ref.pipeline(d["xp"], d["wp"], 4, ref.dp_pp_comm, n_microbatches=2, batch_axis="dp")
    for rank, res in enumerate(ranks):
        res = _ok(res["dp_x_pp"], "dp x pp")
        half = slice(8 * (rank // 2), 8 * (rank // 2 + 1))
        _close(res["y"], y[half], 1e-5, f"rank {rank} output")
        s = res["stage"]
        assert s == rank % 2
        for i in range(2):
            for k in ("weight", "bias"):
                _close(res["grads"][f"blocks.{i}.lin.{k}"], g["lin"][k][2 * s + i], 1e-5, f"rank {rank} {k}")


def test_lm_ring_and_ep_match_world_one(ranks, world_one, ref):
    one = world_one["lm"]
    jax = ref.jax
    lm_r = ref.lm
    tok = ref.jnp.asarray(_data()["tok"])
    _close(one["logits"], jax.jit(lm_r.apply)(ref.init["lm"], tok[:, :-1]), 2e-5, "world 1 vs reference")
    for rank, res in enumerate(ranks):
        res = _ok(res["lm_ring_ep"], "lm")
        assert res["sharded"] == [True, True]
        assert res["loss"] == pytest.approx(one["loss"], rel=1e-6)
        _close(res["logits"], one["logits"], 2e-5, f"rank {rank} logits")
        assert res["grads"].keys() == one["grads"].keys()
        for k in one["grads"]:
            _close(res["grads"][k], one["grads"][k], 2e-5, f"rank {rank} {k}")


def test_decoder_ring_matches_world_one(ranks, world_one):
    one = world_one["dec"]
    assert [r["decoder_ring"].get("lengths") for r in ranks] == [[3, 2], [3, 2], [2, 2], [2, 1]]
    for rank, res in enumerate(ranks):
        res = _ok(res["decoder_ring"], "decoder")
        _close(res["y"], one["y"], 2e-5, f"rank {rank} output")
        _close(res["dmem"], one["dmem"], 2e-5, f"rank {rank} memory gradient")
        for k in one["grads"]:
            _close(res["grads"][k], one["grads"][k], 2e-5, f"rank {rank} {k}")
