"""The slice's distributed paths on three gloo processes, against world size 1.

One module-scoped spawn of 3 ranks (``torch.multiprocessing``, spawn) runs
every case of ``CASES`` on HeAT's uneven chunks (23 elements: 8, 8, 7; 10
rows: 4, 3, 3; 7: 3, 2, 2) at every split and writes the gathered global
result of each.  Each case is one test here, held against the port at world
size 1 (which the other ``test_torch_*`` files of this slice hold against
the reference): exactly, with NaN equal, but the float reductions (``MOMENT``
cases), within rtol 1e-5, atol 1e-6.  The cases: ``sort``, ``argsort``,
``unique`` (with the inverse), ``topk``, ``searchsorted``, the percentiles
and ``argmax``; ``reshape``, ``concatenate``, ``roll``, ``pad`` and the rest
of the manipulations with a distributed path; the moments, histograms and
``cov``; the contractions; the random draws, which must be identical to
world size 1.  Then the traffic: ``sort`` sends at most each rank's chunk
(values and their int64 indices) and under 64 KiB besides; ``percentile``
and ``unique`` gather no array.

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


def _data():
    rng = np.random.default_rng(41)
    v = rng.standard_normal(23).astype(np.float32)
    v[[2, 15]] = np.nan
    v[[5, 20]] = v[7]  # ties across ranks
    d = {"v": v, "w": rng.standard_normal(23).astype(np.float32),
         "i": rng.integers(0, 5, size=23).astype(np.int32),
         "a": rng.standard_normal((10, 7)).astype(np.float32),
         "ai": rng.integers(-4, 4, size=(10, 7)).astype(np.int32),
         "t": rng.standard_normal((7, 6, 5)).astype(np.float32),
         "m": (rng.standard_normal((6, 6)) + 4 * np.eye(6)).astype(np.float32),
         "b": rng.standard_normal((7, 4)).astype(np.float32)}
    d["s"] = np.sort(d["w"])
    d["tiny"] = np.array([3.0, 1.0], np.float32)  # a rank holds nothing
    d["empty"] = np.zeros(0, np.float32)
    return d


def _on(key, fn):
    nd = _data()[key].ndim
    return {f"{s}": (lambda ht, d, s=s: fn(ht, ht.array(d[key], split=s), d)) for s in [None, *range(nd)]}


def _cases(table):
    return {f"{name}_{s}": fn for name, per in table.items() for s, fn in per.items()}


ORDER = {
    "sort": _on("v", lambda ht, x, d: [ht.sort(x), ht.sort(x, descending=True), ht.argsort(x)]),
    "sort_ints": _on("i", lambda ht, x, d: [ht.sort(x), ht.sort(x, descending=True), ht.sort(x, method="global")]),
    "sort_2d": _on("a", lambda ht, x, d: [ht.sort(x, 0), ht.sort(x, 1, True), ht.argsort(x, 0)]),
    "unique": _on("i", lambda ht, x, d: [*ht.unique(x, return_inverse=True), ht.unique_all(x), ht.unique_counts(x)]),
    "unique_nan": _on("v", lambda ht, x, d: [*ht.unique(x, return_inverse=True), ht.unique_values(x)]),
    "unique_2d": _on("ai", lambda ht, x, d: [*ht.unique(x, return_inverse=True), ht.unique(x, axis=0)]),
    "set_ops": _on("i", lambda ht, x, d: [ht.union1d(x, ht.array(d["i"][:6] + 3)),
                                          ht.intersect1d(x, ht.array(d["i"][::2] + 1, split=0)),
                                          ht.setdiff1d(x, ht.array(np.array([1, 2], np.int32))),
                                          ht.setxor1d(x, ht.array(d["i"][:4] + 2, split=0))]),
    "topk": _on("w", lambda ht, x, d: [ht.topk(x, 3), ht.topk(x, 4, largest=False), ht.topk(x, 12)]),
    "topk_2d": _on("a", lambda ht, x, d: [ht.topk(x, 2, dim=0), ht.topk(x, 3, dim=1, largest=False)]),
    "searchsorted": _on("s", lambda ht, x, d: [ht.searchsorted(x, ht.array(d["w"][:9])),
                                               ht.searchsorted(x, ht.array(d["w"], split=0), "right"),
                                               ht.searchsorted(x, d["s"][[0, 5, 22]])]),
    "percentile": _on("w", lambda ht, x, d: [ht.percentile(x, [0, 5, 50, 95, 100], interpolation=m)
                                             for m in ("linear", "lower", "higher", "midpoint", "nearest")]
                      + [ht.median(x), ht.quantile(x, 0.3)]),
    "percentile_nan": _on("v", lambda ht, x, d: [ht.percentile(x, 40), ht.nanpercentile(x, [10, 60]),
                                                 ht.nanmedian(x)]),
    "percentile_2d": _on("a", lambda ht, x, d: [ht.percentile(x, [20, 70], axis=0), ht.median(x, axis=1),
                                                ht.percentile(x, 35, interpolation="nearest")]),
    "argmax": _on("v", lambda ht, x, d: [ht.argmax(x), ht.argmin(x), ht.nanargmax(x), ht.nanargmin(x)]),
    "argmax_2d": _on("ai", lambda ht, x, d: [ht.argmax(x), ht.argmax(x, 0), ht.argmin(x, 1, keepdims=True)]),
    "sort_tiny": _on("tiny", lambda ht, x, d: [*ht.sort(x), ht.unique(x), ht.percentile(x, 50), ht.argmax(x),
                                               ht.topk(x, 1)[0], ht.reshape(x, (2, 1))]),
    "sort_empty": _on("empty", lambda ht, x, d: [*ht.sort(x), ht.unique(x), ht.flatten(x), ht.reshape(x, (0, 3))]),
    "lexsort": _on("i", lambda ht, x, d: ht.lexsort([ht.array(np.arange(23)[::-1].copy(), split=0), x])),
    "partition": _on("a", lambda ht, x, d: [ht.partition(x, 2, 0), ht.argpartition(x, 3, 1)]),
}

MANIP = {
    "reshape": _on("t", lambda ht, x, d: [ht.reshape(x, (42, 5)), ht.reshape(x, (5, 42)), ht.reshape(x, (6, 7, 5)),
                                          ht.flatten(x), ht.reshape(x, (210,), new_split=0),
                                          ht.reshape(x, (7, 30), new_split=1)]),
    "concatenate": _on("a", lambda ht, x, d: [ht.concatenate([x, x]), ht.concatenate([x, ht.array(d["a"], split=1)], 1),
                                              ht.concatenate([ht.array(d["a"][:3]), x, x[5:]]),
                                              ht.stack([x, x], 1), ht.vstack([x, x]), ht.hstack([x, x])]),
    "roll": _on("a", lambda ht, x, d: [ht.roll(x, 3, 0), ht.roll(x, -2, 1), ht.roll(x, 5), ht.roll(x, 11, 0)]),
    "pad": _on("a", lambda ht, x, d: [ht.pad(x, 2), ht.pad(x, ((3, 1), (0, 2)), constant_values=9),
                                      ht.pad(x, ((1, 2), (2, 1)), mode="reflect"), ht.pad(x, 2, mode="wrap")]),
    "flip_take": _on("a", lambda ht, x, d: [ht.flip(x), ht.flip(x, 0), ht.take(x, [9, 0, 4, 4], axis=0),
                                            ht.take(x, [6, 1], axis=1), ht.take(x, [5, 69, 0]), ht.rot90(x)]),
    "repeat_tile": _on("a", lambda ht, x, d: [ht.repeat(x, 2, 0), ht.repeat(x, 3), ht.tile(x, (2, 3)),
                                              ht.repeat(x, np.arange(10) % 3, 0)]),
    "insert_delete": _on("a", lambda ht, x, d: [ht.insert(x, 3, 1.0, axis=0), ht.delete(x, [0, 8], axis=0),
                                                ht.append(x, x, axis=0), ht.delete(x, [1, 40])]),
    "diag": _on("a", lambda ht, x, d: [ht.diagonal(x), ht.diag(x, -1), ht.diagonal(x, 2)]),
    "diag_1d": _on("w", lambda ht, x, d: [ht.diag(x), ht.diag(x, 3)]),
    "unfold": _on("a", lambda ht, x, d: [ht.unfold(x, 0, 3), ht.unfold(x, 0, 4, 3), ht.unfold(x, 1, 2)]),
    "split_squeeze": _on("t", lambda ht, x, d: [*ht.split(x, [2, 5]), ht.squeeze(x[:, :1]),
                                                ht.broadcast_to(x[:1], (3, 7, 6, 5)), ht.expand_dims(x, 1)]),
    "selection": _on("a", lambda ht, x, d: [ht.take_along_axis(x, ht.array(np.argsort(d["a"], 0)), 0),
                                            ht.compress([1, 0, 1, 1], x, axis=0), ht.extract(x > 0, x),
                                            ht.trim_zeros(ht.flatten(ht.where(x > 1, x, 0)))]),
    "inplace": _on("a", lambda ht, x, d: _inplace(ht, x)),
    "shuffle": _on("a", lambda ht, x, d: [ht.sort(ht.shuffle(x), 0)[0]]),
}


def _inplace(ht, x):
    y = ht.array(x.numpy(), split=x.split)
    ht.put(y, [0, 33, 69, 33], [5.0, 6.0])
    z = ht.array(x.numpy(), split=x.split)
    ht.putmask(z, z < 0, [1.0, 2.0, 3.0])
    f = ht.array(x.numpy(), split=x.split)
    ht.fill_diagonal(f, -7.0)
    p = ht.array(x.numpy(), split=x.split)
    ht.place(p, p > 1, np.array([8.0], np.float32))
    return [y, z, f, p]


MOMENT = {
    "moments": _on("a", lambda ht, x, d: [ht.mean(x), ht.mean(x, 0), ht.var(x, 1, ddof=1), ht.std(x, 0),
                                          ht.skew(x, 0), ht.kurtosis(x), ht.ptp(x, 1),
                                          ht.average(x, 1, weights=ht.array(np.arange(1, 8, dtype=np.float32)))]),
    "nan_moments": _on("v", lambda ht, x, d: [ht.nanmean(x), ht.nanvar(x), ht.nanmax(x), ht.nanmin(x)]),
    "cov": _on("a", lambda ht, x, d: [ht.cov(x), ht.cov(x, rowvar=False), ht.corrcoef(x, rowvar=False)]),
    "histograms": _on("a", lambda ht, x, d: [*ht.histogram(x, 5), ht.histc(x, 4), ht.bincount(ht.flatten(abs(x) * 3)
                                                                                             .astype(ht.int32)),
                                             *ht.histogramdd(x[:, :2], 3)[:1], ht.digitize(x, np.array([0.0, 1.0]))]),
    "einsum": _on("a", lambda ht, x, d: [ht.einsum("ij,ik->jk", x, x), ht.einsum("ij->j", x),
                                         ht.einsum("ij,jk->ik", x, ht.array(d["a"].T.copy(), split=0)),
                                         ht.tensordot(x, x, ([0], [0])), ht.inner(x, x)]),
    "unwrap": _on("a", lambda ht, x, d: [ht.unwrap(ht.cumsum(abs(x) * 2, 0), axis=0), ht.unwrap(x * 4, axis=1)]),
    "kron_det": _on("m", lambda ht, x, d: [ht.kron(x[:3], ht.array(d["m"][:2, :2])), ht.linalg.det(x),
                                           ht.linalg.inv(x), ht.linalg.cross(x[:, :3], x[:, 3:])]),
}

RANDOM = {
    "rand": {f"{s}": (lambda ht, d, s=s: _draws(ht, s)) for s in (None, 0, 1)},
}


def _draws(ht, split):
    ht.random.seed(1234)
    out = [ht.random.rand(10, 7, split=split), ht.random.randn(10, 7, split=split),
           ht.random.randint(0, 50, (10, 7), split=split), ht.random.uniform(-1, 1, (10, 7), split=split)]
    if split in (None, 0):
        out += [ht.random.permutation(23, split=split), ht.random.randperm(1700, split=split)]
    return out


CASES = {**_cases(ORDER), **_cases(MANIP), **_cases(RANDOM)}
MOMENTS = _cases(MOMENT)


def _encode(r):
    if isinstance(r, (list, tuple)):
        return [_encode(v) for v in r]
    a = r.numpy()
    return {"value": a.tolist(), "nan": np.isnan(a).tolist() if a.dtype.kind == "f" else None,
            "dtype": r.dtype.__name__, "shape": list(r.shape), "split": r.split}


def _run_all(ht, d, table):
    res = {}
    for name, fn in table.items():
        try:
            res[name] = _encode(fn(ht, d))
        except Exception as e:  # recorded per case, so one fault fails one test
            res[name] = {"error": f"{type(e).__name__}: {e}"}
    return res


def _traffic(ht, d):
    """sort, percentile and unique of 3000 float32 split 0 (1000 a rank)."""
    comm = ht.get_comm()
    x = ht.random.randn(3000, split=0)
    out = {}
    for name, fn in (("sort", lambda: ht.sort(x)), ("percentile", lambda: ht.percentile(x, [5, 50, 95])),
                     ("unique", lambda: ht.unique(x)), ("sort_values", lambda: ht.sort(x, method="sample")[0])):
        comm.reset_traffic()
        fn()
        out[name] = comm.traffic()
    out["lshape"] = x.lshape[0]
    return out


def _worker(rank, port, out_dir):
    import heat_tpu_torch as ht

    ht.core.bootstrap.init_distributed(f"tcp://localhost:{port}", world_size=3, rank=rank, backend="gloo",
                                       timeout_s=60)
    warnings.simplefilter("ignore")
    try:
        ht.use_device("cpu")
        d = _data()
        res = {**_run_all(ht, d, CASES), **_run_all(ht, d, MOMENTS)}
        res["_traffic"] = _traffic(ht, d)
        (pathlib.Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(res))
    finally:
        ht.core.bootstrap.finalize_distributed()


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def three_ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("sort_mp")
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
        d = _data()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return {**_run_all(ht, d, CASES), **_run_all(ht, d, MOMENTS)}
    finally:
        ht.use_device(prev)


def _hold(got, want, name, close=False):
    if isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), name
        for g, w in zip(got, want):
            _hold(g, w, name, close)
        return
    assert "error" not in want, f"{name} at world size 1: {want.get('error')}"
    assert "error" not in got, f"{name}: {got.get('error')}"
    assert (got["dtype"], got["shape"], got["split"]) == (want["dtype"], want["shape"], want["split"]), name
    g = np.asarray(got["value"], dtype=np.float64 if got["nan"] is not None else None)
    w = np.asarray(want["value"], dtype=np.float64 if want["nan"] is not None else None)
    if close:
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6, equal_nan=True, err_msg=name)
    else:
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert got["nan"] == want["nan"], name


@pytest.mark.parametrize("name", list(CASES))
def test_three_ranks_match_world_one(name, three_ranks, world_one):
    for rank, res in enumerate(three_ranks):
        _hold(res[name], world_one[name], f"{name} (rank {rank})")


@pytest.mark.parametrize("name", list(MOMENTS))
def test_three_ranks_reductions_match_world_one(name, three_ranks, world_one):
    for rank, res in enumerate(three_ranks):
        _hold(res[name], world_one[name], f"{name} (rank {rank})", close=True)


def test_sort_sends_at_most_each_ranks_chunk(three_ranks):
    """Each element crosses the wire at most once: a rank's Alltoall bytes
    stay within its chunk of values and their int64 indices (values alone
    where no index is asked for); the splitter selection's Allreduces and
    Allgathers stay under 64 KiB."""
    for rank, res in enumerate(three_ranks):
        t = res["_traffic"]
        n = t["lshape"]
        for name, per in (("sort", 4 + 8), ("sort_values", 4 + 8)):
            tr = t[name]
            assert tr["Alltoall"]["bytes"] <= n * per, (rank, name, tr)
            rest = sum(v["bytes"] for k, v in tr.items() if k != "Alltoall")
            assert rest < 64 * 1024, (rank, name, tr)


def test_percentile_and_unique_gather_no_array(three_ranks):
    for rank, res in enumerate(three_ranks):
        t = res["_traffic"]
        pct = t["percentile"]
        assert "Alltoall" not in pct and sum(v["bytes"] for v in pct.values()) < 64 * 1024, (rank, pct)
        uni = t["unique"]
        assert uni["Alltoall"]["bytes"] <= t["lshape"] * 4, (rank, uni)
        # the uniques of random floats are the array itself: their one Allgatherv is the result, replicated
        assert sum(v["bytes"] for k, v in uni.items() if k not in ("Alltoall", "Allgather")) < 64 * 1024


def test_the_slice_imports_no_jax():
    """``import heat_tpu_torch`` and this slice's modules leave ``jax`` and
    ``heat_tpu`` out of ``sys.modules`` in a fresh process."""
    import subprocess
    import sys

    code = ("import sys, heat_tpu_torch, heat_tpu_torch.core.statistics, heat_tpu_torch.core.manipulations, "
            "heat_tpu_torch.core.random, heat_tpu_torch.linalg.basics, heat_tpu_torch.parallel.sample_sort; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'heat_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True,
                         cwd=str(pathlib.Path(__file__).resolve().parents[1]))
    assert out.stdout.strip() == "[]", out.stdout
