"""heat_tpu_torch KMeans on two gloo processes against world size 1 and heat_tpu.

Two processes (``torch.multiprocessing``, spawn) hold 1001 rows at split=0:
rank 0 holds 501 rows and rank 1 holds 500 (HeAT's uneven chunk).  Each
runs the fit with the reference's two Allreduces per step; the gathered
centers and labels must equal the world-1 port's and the reference's
sharded fit on its 8-device CPU mesh (centers rtol/atol 1e-4: float32
sums of the same rows in another order; labels and n_iter exactly).

This module imports neither JAX nor heat_tpu at the top: the spawned
workers import it and need only torch.
"""

import json
import pathlib
import socket

import numpy as np
import pytest
import torch

N, D, K = 1001, 6, 4


def _data():
    rng = np.random.default_rng(21)
    means = rng.uniform(-8, 8, (K, D))
    X = (means[rng.integers(0, K, N)] + rng.standard_normal((N, D))).astype(np.float32)
    init = X[rng.choice(N, K, replace=False)]
    return X, init


def _worker(rank, port, out_dir):
    import heat_tpu_torch as ht

    ht.core.bootstrap.init_distributed(f"tcp://localhost:{port}", world_size=2, rank=rank, backend="gloo",
                                       timeout_s=60)
    try:
        ht.use_device("cpu")
        X, init = _data()
        x = ht.array(X, split=0)
        comm = x.comm
        result = {
            "size": comm.size,
            "lshape": list(x.lshape),
            "counts_displs": [list(v) for v in comm.counts_displs_shape(x.shape, 0)],
            "lshape_map": x.lshape_map.tolist(),
            "round_trip": bool(np.array_equal(x.numpy(), X)),
            "rows": x[[0, 500, 501, 1000]].numpy().tolist(),
            "slice": x[499:503].numpy().tolist(),
        }
        for kernel in ("pallas", "jnp"):
            km = ht.cluster.KMeans(n_clusters=K, init=init, assign_kernel=kernel).fit(x)
            result[kernel] = {
                "centers": km.cluster_centers_.numpy().tolist(),
                "labels": km.labels_.numpy().tolist(),
                "local_labels": km.labels_.lshape[0],
                "predict": km.predict(x).numpy().tolist(),
                "n_iter": km.n_iter_,
                "inertia": km.inertia_,
            }
        pp = ht.cluster.KMeans(n_clusters=K, init="kmeans++", random_state=3).fit(x)
        result["plusplus_centers"] = pp.cluster_centers_.numpy().tolist()
        (pathlib.Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(result))
    finally:
        ht.core.bootstrap.finalize_distributed()


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_rank_fit_matches_world_one_and_reference(tmp_path):
    import heat_tpu
    import heat_tpu_torch as ht

    ctx = torch.multiprocessing.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_worker, args=(r, port, str(tmp_path))) for r in range(2)]
    for p in procs:
        p.start()
    try:
        # the world-1 port and the reference fit while the workers run
        X, init = _data()
        hx = heat_tpu.array(X, split=0)
        want = {}
        prev = ht.get_device()
        ht.use_device("cpu")
        try:
            x1 = ht.array(X, split=0)
            for kernel in ("pallas", "jnp"):
                one = ht.cluster.KMeans(n_clusters=K, init=init, assign_kernel=kernel).fit(x1)
                ref = heat_tpu.cluster.KMeans(n_clusters=K, init=init, assign_kernel=kernel).fit(hx)
                want[kernel] = (one, ref, ref.predict(hx).numpy())
        finally:
            ht.use_device(prev)
    finally:
        for p in procs:
            p.join(timeout=90)
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(5)
    assert [p.exitcode for p in procs] == [0, 0]
    res = [json.loads((tmp_path / f"rank{r}.json").read_text()) for r in range(2)]

    assert [r["lshape"] for r in res] == [[501, D], [500, D]]
    for r in res:
        assert r["size"] == 2
        assert r["counts_displs"] == [[501, 500], [0, 501]]
        assert r["lshape_map"] == [[501, D], [500, D]]
        assert r["round_trip"]
        np.testing.assert_array_equal(r["rows"], X[[0, 500, 501, 1000]])
        np.testing.assert_array_equal(r["slice"], X[499:503])
    for kernel, (one, ref, ref_pred) in want.items():
        assert [r[kernel]["local_labels"] for r in res] == [501, 500]
        for r in res:
            two = r[kernel]
            np.testing.assert_allclose(two["centers"], one.cluster_centers_.numpy(), rtol=1e-4, atol=1e-4)
            np.testing.assert_allclose(two["centers"], ref.cluster_centers_.numpy(), rtol=1e-4, atol=1e-4)
            np.testing.assert_array_equal(two["labels"], one.labels_.numpy())
            np.testing.assert_array_equal(two["labels"], ref.labels_.numpy())
            np.testing.assert_array_equal(two["predict"], ref_pred)
            assert two["n_iter"] == one.n_iter_ == ref.n_iter_
            np.testing.assert_allclose(two["inertia"], ref.inertia_, rtol=1e-4)
    # kmeans++ draws agree across ranks (one shared CPU generator, Allreduce'd candidates)
    np.testing.assert_array_equal(res[0]["plusplus_centers"], res[1]["plusplus_centers"])
    assert np.isfinite(res[0]["plusplus_centers"]).all()


@pytest.mark.parametrize("n,size", [(1001, 2), (7, 3), (5, 8)])
def test_uneven_chunk_counts(n, size):
    from heat_tpu_torch.core.communication import Communication

    class Fixed(Communication):
        size = property(lambda self: size)
        rank = property(lambda self: 0)

    counts, displs = Fixed().counts_displs_shape((n, 2), 0)
    assert sum(counts) == n and max(counts) - min(counts) <= 1
    assert list(counts) == sorted(counts, reverse=True)  # the first n % size ranks hold one more
    assert displs[0] == 0 and all(displs[i + 1] == displs[i] + counts[i] for i in range(size - 1))
