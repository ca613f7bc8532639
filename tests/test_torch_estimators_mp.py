"""The tiled resplit and the slice's estimators on three gloo processes.

One module-scoped spawn of 3 ranks (``torch.multiprocessing``, spawn) runs
every case, and each case is one test here:

- ``RESPLITS``: every transition of a (6, 9, 36) float32 array (split to
  split, to None and from None; each tileable) under a 1500-byte budget
  (K = 6 or 9 tiles), the copy and the in-place ``resplit_``, each bit for bit the
  monolithic resplit's (budget 0), the plan's reason ``tiled``, and each
  rank's ``comm.traffic()`` bytes equal to the monolithic path's under the
  same collective's name;
- ``FITS``: every estimator of the slice on HeAT's uneven chunks (401
  rows: 134, 134, 133) at split 0 (the batch-parallel fits) or at splits 0
  and None, from the same explicit initial centers where a fit draws them,
  held against the port at world size 1 (which the other ``test_torch_*``
  files hold against the reference): labels and iteration counts exactly,
  values within 1e-4 of their largest entry (float32 sums over other
  chunks), KMedians' medians exactly, Spectral's labels up to a
  permutation.  The batch-parallel fits cluster each rank's rows, so they
  are held against their emulation at world size 1: each chunk clustered
  from its rank's seed, the candidates merged in rank order.

This module imports neither JAX nor heat_tpu: the spawned workers import it
and need only torch.
"""

import json
import pathlib
import socket
import warnings

import numpy as np
import pytest
import torch

SHAPE = (6, 9, 36)
BUDGET = 1500
TRANSITIONS = [(0, 1), (1, 0), (0, 2), (2, 0), (1, 2), (2, 1), (0, None), (1, None), (2, None), (None, 0),
               (None, 1), (None, 2)]
RESPLITS = [f"{s}->{d}" for s, d in TRANSITIONS]


def _data():
    rng = np.random.default_rng(7)
    k, dim, n = 4, 5, 401
    means = rng.uniform(-10, 10, (k, dim))
    lab = rng.integers(0, k, n)
    X = (means[lab] + rng.standard_normal((n, dim))).astype(np.float32)
    theta = np.zeros(dim)
    theta[[0, 3]] = [1.5, -2.0]
    small = X[:90]
    return {"cube": rng.standard_normal(SHAPE).astype(np.float32), "X": X, "means": means, "lab": lab,
            "init": X[[0, 1, 2, 3]], "small": small,
            "low": (rng.standard_normal((401, 3)) @ rng.standard_normal((3, 8)) + 2.0).astype(np.float32),
            "y": (X @ theta + 0.3 + 0.05 * rng.standard_normal(n)).astype(np.float32),
            "cls": (lab * 2 + 1).astype(np.int32), "Q": rng.uniform(-10, 10, (50, dim)).astype(np.float32),
            "snaps": _snapshots(rng)}


def _snapshots(rng, n=120, m=20, r=4):
    basis, _ = np.linalg.qr(rng.standard_normal((n, r)))
    a = np.diag([0.95, 0.9, 0.8, 0.7])
    z, out = rng.standard_normal(r), []
    for _ in range(m):
        out.append(basis @ z)
        z = a @ z
    return np.stack(out, 1).astype(np.float32)


def _resplit(ht, d, src, dst):
    comm = ht.get_comm()
    a = d["cube"]
    comm.reset_traffic()
    mono = ht.array(a, split=src).resplit(dst, memory_budget=0)
    mono_traffic = comm.traffic()
    x = ht.array(a, split=src)
    comm.reset_traffic()
    tiled = x.resplit(dst, memory_budget=BUDGET)
    tiled_traffic = comm.traffic()
    inplace = ht.array(a, split=src).resplit_(dst, memory_budget=BUDGET)
    plan = ht.core.redistribution.plan_resplit(SHAPE, 4, src, dst, comm.size, BUDGET)
    return {"tiled_equal": bool(torch.equal(tiled.larray, mono.larray)),
            "inplace_equal": bool(torch.equal(inplace.larray, mono.larray)),
            "source_kept": bool(torch.equal(x.larray, ht.array(a, split=src).larray)),
            "global_equal": bool(np.array_equal(tiled.numpy(), a)), "split": [tiled.split, inplace.split],
            "reason": plan.reason, "tiles": plan.n_tiles,
            "bytes": [{k: v["bytes"] for k, v in mono_traffic.items()}, {k: v["bytes"] for k, v in
                                                                         tiled_traffic.items()}],
            "calls": [{k: v["calls"] for k, v in mono_traffic.items()}, {k: v["calls"] for k, v in
                                                                         tiled_traffic.items()}]}


def _kfit(ht, d, name, split):
    est = getattr(ht.cluster, name)(n_clusters=4, init=d["init"], max_iter=30).fit(ht.array(d["X"], split=split))
    return [est.cluster_centers_, est.labels_, est.n_iter_, est.inertia_]


def _batch(ht, d, name):
    est = getattr(ht.cluster, name)(n_clusters=4, random_state=3).fit(ht.array(d["X"], split=0))
    return {"centers": est.cluster_centers_.numpy().tolist(), "labels": est.labels_.numpy().tolist(),
            "n_iter": est.n_iter_}


def _batch_emulated(ht, d, name, world=3):
    """The 3-rank batch-parallel fit at world size 1: each rank's HeAT chunk
    clustered from its own seeded init, the candidates in rank order merged
    from the init seeded ``random_state + 1``, labels by the merged centers."""
    from heat_tpu_torch.cluster.batchparallelclustering import local_lloyd

    est = getattr(ht.cluster, name)(n_clusters=4, random_state=3)
    X = torch.from_numpy(d["X"])
    bounds = np.cumsum([0] + [len(c) for c in np.array_split(np.arange(len(X)), world)])
    cands, used = [], 0
    for r in range(world):
        xl = X[bounds[r]:bounds[r + 1]]
        c, it = local_lloyd(xl, est._init(xl, 3, r), est.max_iter, est._median, est.tol)
        cands.append(c)
        used = max(used, it)
    cands = torch.cat(cands)
    merged, _ = local_lloyd(cands, est._init(cands, 4, 0), est.max_iter, est._median, est.tol)
    est._set_centers(merged, ht.array(d["X"]))
    return {"centers": merged.numpy().tolist(), "labels": est.predict(ht.array(d["X"], split=0)).numpy().tolist(),
            "n_iter": used}


def _spectral(ht, d, split):
    x = ht.array(d["small"], split=split)
    est = ht.cluster.Spectral(n_clusters=4, gamma=0.02, n_lanczos=90)
    evals = est._spectral_embedding(x)[0]
    est.fit(x)
    lap = ht.graph.Laplacian(lambda t: ht.spatial.rbf(t, sigma=5.0, quadratic_expansion=True)).construct(x)
    return {"evals": sorted(evals.tolist()), "labels": est.labels_.numpy().tolist(), "laplacian": lap}


def _pca(ht, d, solver, split):
    p = ht.decomposition.PCA(n_components=3, svd_solver=solver).fit(ht.array(d["low"], split=split))
    return [p.singular_values_, p.explained_variance_ratio_, ht.abs(p.components_), ht.abs(
        p.transform(ht.array(d["low"], split=split)))]


def _ipca(ht, d, split):
    p = ht.decomposition.IncrementalPCA(n_components=3, batch_size=100).fit(ht.array(d["low"], split=split))
    return [p.singular_values_, ht.abs(p.components_), p.mean_]


def _dmd(ht, d, split):
    x = ht.array(d["snaps"], split=split)
    m = ht.decomposition.DMD(svd_rank=4).fit(x)
    ev = m.rom_eigenvalues_.numpy()
    return {"evals": sorted(np.round(ev.real, 5).tolist()), "predict": m.predict(ht.array(d["snaps"][:, 0],
                                                                                           split=split), 3),
            "next": m.predict_next(ht.array(d["snaps"][:, :2], split=split), 2)}


def _lasso(ht, d, split):
    m = ht.regression.Lasso(lam=0.05, max_iter=300, tol=1e-5).fit(ht.array(d["X"], split=split),
                                                                   ht.array(d["y"], split=split))
    return [m.theta, m.n_iter_, m.predict(ht.array(d["X"], split=split))]


def _nb(ht, d, split):
    x, y = ht.array(d["X"], split=split), ht.array(d["cls"], split=split)
    nb = ht.naive_bayes.GaussianNB().fit(x, y)
    part = ht.naive_bayes.GaussianNB()
    for lo, hi in ((0, 150), (150, 401)):
        part.partial_fit(ht.array(d["X"][lo:hi], split=split), ht.array(d["cls"][lo:hi], split=split),
                         classes=np.array([1, 3, 5, 7], np.int32))
    return [nb.theta_, nb.var_, nb.class_count_, nb.predict(x), nb.predict_proba(x), part.theta_, part.var_]


def _knn(ht, d, split, qsplit):
    knn = ht.classification.KNeighborsClassifier(3).fit(ht.array(d["X"], split=split), ht.array(d["cls"],
                                                                                                   split=split))
    return knn.predict(ht.array(d["Q"], split=qsplit))


def _scalers(ht, d, split):
    x = ht.array(d["X"], split=split)
    out = []
    for kind in ("StandardScaler", "MinMaxScaler", "MaxAbsScaler", "RobustScaler", "Normalizer"):
        s = getattr(ht.preprocessing, kind)().fit(x)
        t = s.transform(x)
        out += [t] + ([s.inverse_transform(t)] if kind != "Normalizer" else [])
    return out


FITS = {
    **{f"{n}_{s}": (lambda ht, d, n=n, s=s: _kfit(ht, d, n, s))
       for n in ("KMeans", "KMedians", "KMedoids") for s in (0, 1, None)},
    **{f"spectral_{s}": (lambda ht, d, s=s: _spectral(ht, d, s)) for s in (0, None)},
    **{f"pca_{v}_{s}": (lambda ht, d, v=v, s=s: _pca(ht, d, v, s))
       for v in ("full", "hierarchical", "randomized") for s in (0, None)},
    **{f"ipca_{s}": (lambda ht, d, s=s: _ipca(ht, d, s)) for s in (0, None)},
    **{f"dmd_{s}": (lambda ht, d, s=s: _dmd(ht, d, s)) for s in (0, None)},
    **{f"lasso_{s}": (lambda ht, d, s=s: _lasso(ht, d, s)) for s in (0, None)},
    **{f"gaussian_nb_{s}": (lambda ht, d, s=s: _nb(ht, d, s)) for s in (0, None)},
    **{f"knn_{s}_{q}": (lambda ht, d, s=s, q=q: _knn(ht, d, s, q)) for s in (0, None) for q in (0, None)},
    **{f"scalers_{s}": (lambda ht, d, s=s: _scalers(ht, d, s)) for s in (0, 1, None)},
}
BATCH = {n: (lambda ht, d, n=n: _batch(ht, d, n)) for n in ("BatchParallelKMeans", "BatchParallelKMedians")}
EXACT = ("KMedians", "KMedoids")  # medians and member rows: the same values at every world size


def _encode(r):
    if isinstance(r, dict):
        return {k: _encode(v) for k, v in r.items()}
    if isinstance(r, (list, tuple)):
        return [_encode(v) for v in r]
    if isinstance(r, (int, float, bool, str)) or r is None:
        return r
    a = r.numpy()
    if np.iscomplexobj(a):
        a = np.stack([a.real, a.imag], -1)
    return {"value": a.tolist(), "shape": list(r.shape), "split": r.split, "dtype": r.dtype.__name__}


def _run(ht, d, table):
    res = {}
    for name, fn in table.items():
        try:
            res[name] = _encode(fn(ht, d))
        except Exception as e:  # recorded per case, so one fault fails one test
            res[name] = {"error": f"{type(e).__name__}: {e}"}
    return res


def _worker(rank, port, out_dir):
    import heat_tpu_torch as ht

    torch.set_num_threads(1)  # three ranks share the host's cores: one intra-op thread each

    ht.core.bootstrap.init_distributed(f"tcp://localhost:{port}", world_size=3, rank=rank, backend="gloo",
                                       timeout_s=60)
    warnings.simplefilter("ignore")
    try:
        ht.use_device("cpu")
        d = _data()
        res = {"resplit": {f"{s}->{t}": _resplit(ht, d, s, t) for s, t in TRANSITIONS}}
        res.update(_run(ht, d, {**FITS, **BATCH}))
        (pathlib.Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(res))
    finally:
        ht.core.bootstrap.finalize_distributed()


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def three_ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("estimators_mp")
    ctx = torch.multiprocessing.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_worker, args=(r, port, str(out))) for r in range(3)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=300)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(5)
    assert [p.exitcode for p in procs] == [0, 0, 0]
    return [json.loads((out / f"rank{r}.json").read_text()) for r in range(3)]


@pytest.fixture(scope="module")
def world_one():
    import heat_tpu_torch as ht

    prev = ht.get_device()
    ht.use_device("cpu")
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            d = _data()
            return {**_run(ht, d, FITS), **_run(ht, d, {n: (lambda ht, d, n=n: _batch_emulated(ht, d, n))
                                                         for n in BATCH})}
    finally:
        ht.use_device(prev)


@pytest.mark.parametrize("name", RESPLITS)
def test_tiled_resplit_is_the_monolithic_one(name, three_ranks):
    for rank, res in enumerate(three_ranks):
        r = res["resplit"][name]
        assert r["reason"] == "tiled" and r["tiles"] > 1, (rank, r)
        assert r["tiled_equal"] and r["inplace_equal"] and r["global_equal"] and r["source_kept"], (rank, r)
        mono, tiled = r["bytes"]
        assert mono == tiled, (rank, name, r["bytes"])  # the same bytes under the same collective's name
        if mono:
            (op, calls), = r["calls"][1].items()
            assert calls == r["tiles"] and r["calls"][0][op] == 1, (rank, r["calls"])


def _hold(got, want, name, exact):
    if isinstance(want, dict) and "value" not in want and "error" not in want:
        assert isinstance(got, dict) and set(got) == set(want), name
        for k in want:
            _hold(got[k], want[k], f"{name}.{k}", exact)
        return
    if isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), name
        for i, (g, w) in enumerate(zip(got, want)):
            _hold(g, w, f"{name}[{i}]", exact)
        return
    if isinstance(want, dict):
        assert "error" not in want, f"{name} at world size 1: {want.get('error')}"
        assert "error" not in got, f"{name}: {got.get('error')}"
        assert (got["shape"], got["split"], got["dtype"]) == (want["shape"], want["split"], want["dtype"]), name
        g, w = np.asarray(got["value"]), np.asarray(want["value"])
        if exact or g.dtype.kind in "iub":
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            scale = max(float(np.abs(w).max()), 1.0) if w.size else 1.0
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4 * scale, err_msg=name)
        return
    if isinstance(want, float) and not exact:
        assert abs(got - want) <= 1e-4 * max(abs(want), 1.0), (name, got, want)
    else:
        assert got == want or (isinstance(want, float) and abs(got - want) <= 1e-6 * max(abs(want), 1.0)), \
            (name, got, want)


@pytest.mark.parametrize("name", list(FITS))
def test_three_ranks_match_world_one(name, three_ranks, world_one):
    for rank, res in enumerate(three_ranks):
        got, want = res[name], world_one[name]
        if name.startswith("spectral"):
            assert "error" not in got, got.get("error")
            _hold(got["evals"], want["evals"], f"{name} (rank {rank})", False)
            _hold(got["laplacian"], want["laplacian"], f"{name} (rank {rank})", False)
            assert _same_partition(got["labels"], want["labels"]), (rank, name)
        elif name.startswith(EXACT):
            _hold(got[:3], want[:3], f"{name} (rank {rank})", True)
            _hold(got[3:], want[3:], f"{name} (rank {rank})", False)
        else:
            _hold(got, want, f"{name} (rank {rank})", False)


def _same_partition(a, b):
    pairs = set(zip(a, b))
    return len(pairs) == len(set(a)) == len(set(b))


@pytest.mark.parametrize("name", list(BATCH))
def test_batch_parallel_matches_its_emulation_at_world_one(name, three_ranks, world_one):
    """Each rank clusters its own chunk and every rank merges the same
    candidates: the fit equals the per-chunk emulation at world size 1."""
    want = world_one[name]
    for rank, res in enumerate(three_ranks):
        got = res[name]
        assert "error" not in got, got.get("error")
        np.testing.assert_allclose(got["centers"], want["centers"], rtol=1e-6, atol=1e-6)
        assert got["labels"] == want["labels"] and got["n_iter"] == want["n_iter"], (rank, name)
