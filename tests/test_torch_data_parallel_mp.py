"""heat_tpu_torch's data-parallel training on four gloo processes.

One module-scoped spawn of 4 ranks (``torch.multiprocessing``, spawn) runs
every case of ``CASES`` and writes what each gives; each case is one test
here, held against the reference on the CPU mesh and against the port at
world size 1.  The reference's initial parameters (its own ``init``) are
made here and handed to the ranks, which never import JAX.

- ``DataParallel`` over 4 ranks: the MLP on a ragged global batch (23 rows:
  6, 6, 6, 5), the small ResNet with the global batch's BatchNorm (10 rows:
  3, 3, 2, 2), the ResNet under ``overlap_sync`` (BatchNorm per rank: the
  reference's per-shard step on a mesh of 4 devices), torch's own loop,
  4 buckets with ``blocking`` (accepted for the reference's signature, and
  as there it changes nothing: the same hooked buckets) and the two-level
  sync (``sync_domains=2``); parameters after 3 SGD steps against the
  reference's ``make_train_step`` and the port at world size 1.
- ``bucketed_grad_allreduce`` with 1 and 3 buckets, flat and two-level
  (``domains=2``), against the mean of the ranks' tensors; the traffic is
  the same to the byte.
- ``DASO`` as 2 groups x 2 against the reference's ``DASO`` on a mesh of 4
  devices reshaped (2, 2), ('dcn', 'ici'), 12 steps (warmup 3,
  ``global_skip`` 4, ``stale_steps`` 2), plain and with ``overlap_sync``:
  each rank's parameters against its group's replica; a cooldown that
  drops the pending average; ``consolidated_params``.
- ``Iallreduce``, ``Ireduce_scatter`` and ``Iallgather``: results and
  ``traffic()``, and nothing counted with ``account=False``.
- the DataLoader's shuffle at world size 4 and 2 (two 2-rank subgroups
  made by ``Split``) against world size 1.

Tolerances, float32, against each tensor's largest magnitude: parameters
rtol 1e-5 (sums over the ranks in another order), the bucketed mean rtol
1e-6, batches exactly.
"""

import pathlib
import socket
import warnings

import numpy as np
import pytest
import torch

WORLD = 4
MLP = (20, 16, 12, 5)
LR = dict(lr=0.05, momentum=0.9)
DASO_CFG = dict(global_skip=4, stale_steps=2, warmup_steps=3)
DASO_STEPS = 12


def _batches(shape, steps, seed):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(shape).astype(np.float32), rng.integers(0, 5, shape[0]).astype(np.int32))
            for _ in range(steps)]


def _loader_data(n=37):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((n, 3)).astype(np.float32)
    x[:, 0] = np.arange(n)
    return x, (np.arange(n) % 7).astype(np.int32)


def _state(module):
    return {n: t.detach().numpy().copy() for n, t in module.state_dict().items()}


# ---------------------------------------------------------------------- #
# the cases, run on every rank (and at world size 1 here)
# ---------------------------------------------------------------------- #
def _model(ht, init, kind):
    from heat_tpu_torch.utils import convert

    if kind == "mlp":
        return convert.mlp_from_reference(init["mlp"], MLP)
    return convert.resnet_from_reference(init["resnet"], "resnet", stage_sizes=(1, 1), width=4, num_classes=5)


def _dp_run(ht, init, kind, rows, own_loop=False, **dp_kw):
    """3 SGD steps of DataParallel on this rank's chunk of each global batch."""
    comm = ht.get_comm()
    shape = (rows, 20) if kind == "mlp" else (rows, 3, 8, 8)
    model = _model(ht, init, kind)
    opt = ht.optim.DataParallelOptimizer("sgd", blocking=dp_kw.get("blocking", False), **LR)
    dp = ht.nn.DataParallel(model, optimizer=opt, **dp_kw)
    step = dp.make_train_step(ht.nn.functional.cross_entropy)
    out = {"losses": []}
    for x, y in _batches(shape, 3, seed=rows):
        sl = comm.chunk(x.shape, 0)[2][0]
        xl, yl = torch.from_numpy(x[sl]), torch.from_numpy(y[sl])
        if own_loop:
            opt.zero_grad()
            loss = ht.nn.functional.cross_entropy(dp(xl), yl)
            loss.backward()
            opt.step()
        else:
            loss = step(xl, yl)
        out["losses"].append(float(loss))
    out["state"] = _state(model)
    out["buckets"] = dp._plan.n_buckets
    out["sync_left_open"] = dp._state is not None
    return out


def _allreduce_case(ht, init, budget, domains):
    comm = ht.get_comm()
    rng = np.random.default_rng(100 + comm.rank)
    tensors = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for s in ((7, 5), (13,), (3, 4, 2), (9,))]
    comm.reset_traffic()
    ht.core.collectives.bucketed_grad_allreduce(comm, tensors, budget=budget, domains=domains)
    plan = ht.core.collectives.plan_grad_buckets([t.numel() * 4 for t in tensors], budget)
    return {"tensors": [t.numpy() for t in tensors], "buckets": plan.n_buckets, "traffic": comm.traffic()}


def _icollectives_case(ht, init):
    """The asynchronous collectives, accounted and not."""
    comm = ht.get_comm()
    base = torch.arange(8, dtype=torch.float32) + 10 * comm.rank
    comm.reset_traffic()
    reqs = [comm.Iallreduce(base.clone()), comm.Ireduce_scatter(base.clone()), comm.Iallgather(base[:3].clone())]
    quiet = [comm.Iallreduce(base.clone(), op="max", account=False),
             comm.Ireduce_scatter(base.clone(), account=False), comm.Iallgather(base[:3].clone(), account=False)]
    return {"results": [r.wait().numpy() for r in reqs], "quiet": [r.wait().numpy() for r in quiet],
            "traffic": comm.traffic()}


def _daso_run(ht, init, overlap, cooldown=False):
    comm = ht.get_comm()
    model = _model(ht, init, "mlp")
    kw = dict(DASO_CFG, cooldown_epochs=1, total_epochs=2) if cooldown else DASO_CFG
    daso = ht.optim.DASO(ht.optim.DataParallelOptimizer("sgd", **LR), total_local_comm_size=2,
                         overlap_sync=overlap, grad_bucket_bytes=600 if overlap else None, **kw)
    daso.init(model)
    out = {"states": [], "losses": [], "pending": []}
    for t, (x, y) in enumerate(_batches((16, 20), DASO_STEPS, seed=5)):
        if cooldown and t == 8:
            out["pending_before_cooldown"] = daso._pending is not None
            out["skip_after"] = daso.epoch_loss_logic(1.0)
            out["pending_after_cooldown"] = daso._pending is not None
        sl = comm.chunk(x.shape, 0)[2][0]
        out["losses"].append(float(daso.step(ht.nn.functional.cross_entropy, torch.from_numpy(x[sl]),
                                             torch.from_numpy(y[sl]))))
        out["states"].append(_state(model))
        out["pending"].append(daso._pending is not None)
    out["consolidated"] = {k: v.numpy() for k, v in daso.consolidated_params().items()}
    out["skip_stats"] = daso.skip_stats()
    out["groups"] = [daso.ici.ranks, daso.dcn.ranks]
    return out


def _loader_batches(ht, comm):
    x, y = _loader_data()
    ds = ht.utils.data.Dataset(ht.array(x, split=0, comm=comm), labels=ht.array(y, split=0, comm=comm))
    loader = ht.utils.data.DataLoader(ds, batch_size=6, shuffle=True)
    out = []
    for _ in range(2):
        for bx, by in loader:
            out.append([bx.numpy(), by.numpy(), list(bx.lshape)])
    return out


def _shuffle_case(ht, init):
    comm = ht.get_comm()
    pair = comm.Split(comm.rank // 2)
    return {"world": _loader_batches(ht, comm), "pair": _loader_batches(ht, pair), "pair_ranks": pair.ranks}


CASES = {
    "dp_mlp_ragged": lambda ht, init: _dp_run(ht, init, "mlp", 23),
    "dp_resnet_global_bn": lambda ht, init: _dp_run(ht, init, "resnet", 8),
    "dp_resnet_ragged_global_bn": lambda ht, init: _dp_run(ht, init, "resnet", 10),
    "dp_resnet_overlap_sync": lambda ht, init: _dp_run(ht, init, "resnet", 8, overlap_sync=True,
                                                       grad_bucket_bytes=2048),
    "dp_resnet_own_loop": lambda ht, init: _dp_run(ht, init, "resnet", 10, own_loop=True),
    "dp_mlp_blocking_buckets": lambda ht, init: _dp_run(ht, init, "mlp", 23, blocking=True, grad_bucket_bytes=700),
    "dp_mlp_two_level": lambda ht, init: _dp_run(ht, init, "mlp", 23, sync_domains=2, grad_bucket_bytes=700),
    "allreduce_k1": lambda ht, init: _allreduce_case(ht, init, 0, 1),
    "allreduce_k3": lambda ht, init: _allreduce_case(ht, init, 150, 1),
    "allreduce_k1_two_level": lambda ht, init: _allreduce_case(ht, init, 0, 2),
    "allreduce_k3_two_level": lambda ht, init: _allreduce_case(ht, init, 150, 2),
    "icollectives": _icollectives_case,
    "daso_plain": lambda ht, init: _daso_run(ht, init, False),
    "daso_overlap_sync": lambda ht, init: _daso_run(ht, init, True),
    "daso_cooldown": lambda ht, init: _daso_run(ht, init, False, cooldown=True),
    "shuffle": _shuffle_case,
}


def _worker(rank, port, out_dir):
    import heat_tpu_torch as ht

    ht.core.bootstrap.init_distributed(f"tcp://localhost:{port}", world_size=WORLD, rank=rank, backend="gloo",
                                       timeout_s=120)
    warnings.simplefilter("ignore")
    try:
        ht.use_device("cpu")
        init = torch.load(pathlib.Path(out_dir) / "init.pt", weights_only=False)
        res = {}
        for name, fn in CASES.items():
            try:
                res[name] = fn(ht, init)
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


@pytest.fixture(scope="module")
def init_params():
    import jax

    from heat_tpu.nn import models as ref_models

    def np_tree(t):
        return jax.tree.map(lambda a: np.asarray(a), t)

    return {"mlp": np_tree(ref_models.mlp(MLP).init(jax.random.key(1))),
            "resnet": np_tree(ref_models.resnet((1, 1), width=4, num_classes=5).init(jax.random.key(2)))}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, init_params):
    out = tmp_path_factory.mktemp("data_parallel_mp")
    torch.save(init_params, out / "init.pt")
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


def _ok(res, name):
    assert "error" not in res, f"{name}: {res.get('error')}"
    return res


def _close(got, want, rtol, msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol, atol=rtol * float(np.abs(want).max()), err_msg=msg)


def _state_close(got, want, rtol=1e-5, msg=""):
    assert got.keys() == want.keys()
    for key in want:
        _close(got[key], want[key], rtol, f"{msg} {key}")


def _world_one(name, init):
    """The case at world size 1, in this process."""
    import heat_tpu_torch as ht

    prev = ht.get_device()
    ht.use_device("cpu")
    try:
        return CASES[name](ht, init)
    finally:
        ht.use_device(prev)


def _reference_dp(init, kind, rows, overlap=False, mesh_devices=WORLD):
    """The reference's make_train_step over the global batches: the state after 3 steps."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    import heat_tpu as ref_ht
    from heat_tpu.core.communication import Communication as RefComm
    from heat_tpu.nn import models as ref_models
    from heat_tpu_torch.utils import convert

    rm = ref_models.mlp(MLP) if kind == "mlp" else ref_models.resnet((1, 1), width=4, num_classes=5)
    params = jax.tree.map(jnp.asarray, init[kind])
    comm = RefComm(Mesh(np.asarray(jax.devices()[:mesh_devices]), ("x",)))
    opt = ref_ht.optim.DataParallelOptimizer("sgd", **LR)
    dp = ref_ht.nn.DataParallel(rm, comm=comm, optimizer=opt)
    state = opt.init_state(params)
    step = dp.make_train_step(ref_ht.nn.functional.cross_entropy, donate=False, overlap_sync=overlap)
    shape = (rows, 20) if kind == "mlp" else (rows, 3, 8, 8)
    losses = []
    for x, y in _batches(shape, 3, seed=rows):
        params, state, loss = step(params, state, jnp.asarray(x), jnp.asarray(y))
        losses.append(float(loss))
    return convert._flatten(jax.tree.map(np.asarray, params)), losses


DP_REFERENCE = {
    "dp_mlp_ragged": ("mlp", 23, False),
    "dp_resnet_global_bn": ("resnet", 8, False),
    "dp_resnet_ragged_global_bn": ("resnet", 10, False),
    "dp_resnet_overlap_sync": ("resnet", 8, True),
    "dp_resnet_own_loop": ("resnet", 10, False),
    "dp_mlp_blocking_buckets": ("mlp", 23, False),
    "dp_mlp_two_level": ("mlp", 23, False),
}


@pytest.mark.parametrize("name", list(DP_REFERENCE))
def test_data_parallel_on_four_ranks_matches_reference_and_world_one(name, ranks, init_params):
    kind, rows, overlap = DP_REFERENCE[name]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want, losses = _reference_dp(init_params, kind, rows, overlap)
    one = None if overlap else _world_one(name, init_params)
    for rank, res in enumerate(ranks):
        got = _ok(res[name], name)
        assert not got["sync_left_open"]  # every backward's buckets were awaited and unpacked
        if name in ("dp_mlp_blocking_buckets", "dp_mlp_two_level"):
            assert got["buckets"] == 4
        _state_close(got["state"], want, msg=f"rank {rank} vs reference")
        if name != "dp_resnet_own_loop":  # torch's own loop returns the local loss
            _close(got["losses"], losses, 1e-5, f"rank {rank} losses")
        if one is not None:
            _state_close(got["state"], one["state"], msg=f"rank {rank} vs world 1")
    for res in ranks[1:]:  # every replica the same bits
        assert all(np.array_equal(res[name]["state"][k], ranks[0][name]["state"][k]) for k in want)


@pytest.mark.parametrize("name", ["allreduce_k1", "allreduce_k3", "allreduce_k1_two_level", "allreduce_k3_two_level"])
def test_bucketed_grad_allreduce_is_the_mean(name, ranks):
    shapes = ((7, 5), (13,), (3, 4, 2), (9,))
    inputs = []
    for r in range(WORLD):
        rng = np.random.default_rng(100 + r)
        inputs.append([rng.standard_normal(s).astype(np.float32) for s in shapes])
    want = [np.mean([inputs[r][j] for r in range(WORLD)], axis=0) for j in range(len(shapes))]
    for res in ranks:
        got = _ok(res[name], name)
        assert got["buckets"] == (3 if "k3" in name else 1)
        for g, w in zip(got["tensors"], want):
            _close(g, w, 1e-6)
    # every split into buckets and stages accounts the flat ring's bytes, to the byte
    flat = 2 * (WORLD - 1) / WORLD * sum(int(np.prod(s)) * 4 for s in shapes)
    assert ranks[0][name]["traffic"]["Allreduce"]["bytes"] == round(flat)


def test_asynchronous_collectives_on_four_ranks(ranks):
    bases = [np.arange(8, dtype=np.float32) + 10 * r for r in range(WORLD)]
    total = np.sum(bases, axis=0)
    gathered = np.concatenate([b[:3] for b in bases])
    for rank, res in enumerate(ranks):
        got = _ok(res["icollectives"], "icollectives")
        np.testing.assert_array_equal(got["results"][0], total)
        np.testing.assert_array_equal(got["results"][1], total[2 * rank: 2 * rank + 2])
        np.testing.assert_array_equal(got["results"][2], gathered)
        np.testing.assert_array_equal(got["quiet"][0], bases[-1])
        np.testing.assert_array_equal(got["quiet"][1], got["results"][1])
        np.testing.assert_array_equal(got["quiet"][2], gathered)
        # 32 bytes a rank: Allreduce 2(p-1)/p, ReduceScatter (p-1)/p, Allgather of 12 bytes p-1;
        # the unaccounted calls add nothing
        assert got["traffic"] == {"Allreduce": {"calls": 1, "bytes": 48}, "ReduceScatter": {"calls": 1, "bytes": 24},
                                  "Allgather": {"calls": 1, "bytes": 36}}


def _reference_daso(init, overlap, cooldown=False):
    """The reference's DASO on a (2, 2) mesh: each step's stacked (2, ...) parameters."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    import heat_tpu as ref_ht
    from heat_tpu.nn import models as ref_models
    from heat_tpu_torch.utils import convert

    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("dcn", "ici"))
    kw = dict(DASO_CFG, cooldown_epochs=1, total_epochs=2) if cooldown else DASO_CFG
    daso = ref_ht.optim.DASO(ref_ht.optim.DataParallelOptimizer("sgd", **LR), mesh=mesh, overlap_sync=overlap,
                             grad_bucket_bytes=600 if overlap else None, **kw)
    rm = ref_models.mlp(MLP)
    daso.init(rm, key=jax.random.key(1))
    stacked = []
    for t, (x, y) in enumerate(_batches((16, 20), DASO_STEPS, seed=5)):
        if cooldown and t == 8:
            daso.epoch_loss_logic(1.0)
        daso.step(ref_ht.nn.functional.cross_entropy, jnp.asarray(x), jnp.asarray(y))
        stacked.append(convert._flatten(jax.tree.map(np.asarray, daso.parameters)))
    return stacked, convert._flatten(jax.tree.map(np.asarray, daso.consolidated_params()))


@pytest.mark.parametrize("name", ["daso_plain", "daso_overlap_sync", "daso_cooldown"])
def test_daso_two_groups_of_two_match_reference(name, ranks, init_params):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        stacked, consolidated = _reference_daso(init_params, name == "daso_overlap_sync", name == "daso_cooldown")
    for rank, res in enumerate(ranks):
        got = _ok(res[name], name)
        assert [list(g) for g in got["groups"]] == [[rank // 2 * 2, rank // 2 * 2 + 1], [rank % 2, rank % 2 + 2]]
        for t, (state, want) in enumerate(zip(got["states"], stacked)):
            _state_close(state, {k: v[rank // 2] for k, v in want.items()}, msg=f"rank {rank} step {t + 1}")
        _state_close(got["consolidated"], consolidated, msg=f"rank {rank} consolidated")
        assert got["skip_stats"] == {"steps": DASO_STEPS, "skipped": 0}
    # the replicas within a group are the same bits, and the groups differ between syncs
    for a, b in ((0, 1), (2, 3)):
        for sa, sb in zip(ranks[a][name]["states"], ranks[b][name]["states"]):
            assert all(np.array_equal(sa[k], sb[k]) for k in sa)
    mean = {k: (ranks[0][name]["states"][-1][k] + ranks[2][name]["states"][-1][k]) / 2
            for k in ranks[0][name]["consolidated"]}
    _state_close(ranks[0][name]["consolidated"], mean, 1e-6, "consolidated is the groups' mean")
    pending = ranks[0][name]["pending"]
    if name == "daso_cooldown":
        res = ranks[0][name]
        assert res["pending_before_cooldown"] and not res["pending_after_cooldown"] and res["skip_after"] == 1
        assert not any(pending[8:])
        for k in res["states"][-1]:  # fully synchronous after the cooldown: every rank the same
            assert all(np.allclose(r[name]["states"][-1][k], res["states"][-1][k], rtol=0, atol=1e-7) for r in ranks)
    else:
        # dispatched at steps 4, 8, 12 (after warmup), consumed 2 steps later
        assert pending == [False, False, False, True, True, False, False, True, True, False, False, True]


def test_shuffle_is_the_same_at_world_sizes_one_two_and_four(ranks):
    import heat_tpu_torch as ht

    prev = ht.get_device()
    ht.use_device("cpu")
    try:
        one = _loader_batches(ht, ht.get_comm())
    finally:
        ht.use_device(prev)
    for rank, res in enumerate(ranks):
        got = _ok(res["shuffle"], "shuffle")
        assert got["pair_ranks"] == ((0, 1) if rank < 2 else (2, 3))
        for key, p in (("world", WORLD), ("pair", 2)):
            assert len(got[key]) == len(one)
            for (gx, gy, lshape), (wx, wy, _) in zip(got[key], one):
                np.testing.assert_array_equal(gx, wx)
                np.testing.assert_array_equal(gy, wy)
                assert lshape[0] in (len(wx) // p, len(wx) // p + 1)
    x, y = _loader_data()
    rows = np.concatenate([b[0] for b in one[:7]])
    assert sorted(rows[:, 0].astype(int)) == list(range(len(x)))
