"""heat_tpu_torch's KMedians, KMedoids, batch-parallel and spectral
clustering and the graph Laplacian against heat_tpu.

The same numpy blobs (``np.random.default_rng``) and explicit initial
centers go to both packages: the reference on its 8-device CPU mesh, the
port at world size 1 on the CPU.  Tolerances (float32): KMedians' centers
and KMedoids' medoids within 1e-6 (the same medians and the same rows of the
same labels), KMeans centers and batch-parallel Lloyd within 1e-4 (float32
sums in another order), labels and iteration counts exactly (no row near a
tie in these blobs); the Laplacian within 1e-5; Spectral's eigenvalues
within 1e-4 of the reference's (Lanczos to the full dimension, so both
give L's eigenvalues) and its labels up to a permutation.

Seeded draws of the reference that the port's streams do not reproduce
(``jax.random.choice`` of the batch-parallel inits, D² sampling) are held
from explicit centers: the reference's ``_local_lloyd`` from its own
``choice`` of rows against the port's ``local_lloyd`` from those rows, and
the port's full batch-parallel fit by the blobs it recovers.
"""

import warnings

import numpy as np
import pytest
import torch

import heat_tpu
import heat_tpu_torch as htt
from heat_tpu_torch.cluster.batchparallelclustering import local_lloyd
from heat_tpu_torch.utils import convert

K = 4


@pytest.fixture(autouse=True)
def on_cpu():
    prev = htt.get_device()
    htt.use_device("cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        yield
    htt.use_device(prev)


def _blobs(n=480, d=5, k=K, seed=0, spread=10.0):
    rng = np.random.default_rng(seed)
    means = rng.uniform(-spread, spread, (k, d))
    lab = rng.integers(0, k, n)
    X = (means[lab] + rng.standard_normal((n, d))).astype(np.float32)
    init = X[rng.choice(n, k, replace=False)]
    return X, init, means, lab


X, INIT, MEANS, LAB = _blobs()


def _reference(name, **kw):
    """A reference estimator with the explicit ``INIT`` (its KMedians
    compares ``init`` to a string in ``__init__``, so it is set after)."""
    est = getattr(heat_tpu.cluster, name)(n_clusters=K, **kw)
    est.init = INIT
    return est


def _same_partition(a, b):
    """Labels ``a`` and ``b`` name the same clusters up to a permutation."""
    pairs = set(zip(a.tolist(), b.tolist()))
    return len(pairs) == len(set(a.tolist())) == len(set(b.tolist()))


@pytest.fixture(scope="module")
def reference_fits():
    fits = {}
    for name in ("KMedians", "KMedoids"):
        for split in (0, None):
            est = _reference(name, max_iter=30)
            hx = heat_tpu.array(X, split=split)
            est.fit(hx)
            fits[name, split] = dict(centers=est.cluster_centers_.numpy(), labels=est.labels_.numpy(),
                                     predict=est.predict(hx).numpy(), n_iter=est.n_iter_, inertia=est.inertia_)
    return fits


@pytest.mark.parametrize("ref_split", [0, None])
@pytest.mark.parametrize("split", [0, None])
@pytest.mark.parametrize("name", ["KMedians", "KMedoids"])
def test_kmedians_and_kmedoids_match_reference(name, split, ref_split, reference_fits):
    ref = reference_fits[name, ref_split]
    x = htt.array(X, split=split)
    est = getattr(htt.cluster, name)(n_clusters=K, init=INIT, max_iter=30).fit(x)
    assert est.n_iter_ > 1
    np.testing.assert_allclose(est.cluster_centers_.numpy(), ref["centers"], rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(est.labels_.numpy(), ref["labels"])
    np.testing.assert_array_equal(est.predict(x).numpy(), ref["predict"])
    assert est.n_iter_ == ref["n_iter"]
    np.testing.assert_allclose(est.inertia_, ref["inertia"], rtol=1e-4)
    assert est.labels_.split == split and est.labels_.dtype is htt.int32
    assert est.cluster_centers_.split is None


def test_kmedoids_are_member_rows_nearest_their_medians():
    est = htt.cluster.KMedoids(n_clusters=K, init=INIT, max_iter=30).fit(htt.array(X, split=0))
    centers, labels = est.cluster_centers_.numpy(), est.labels_.numpy()
    for c in range(K):
        assert any(np.array_equal(centers[c], row) for row in X)
        members = X[labels == c]
        assert len(members)


def test_kmedians_medians_are_per_cluster_medians_with_an_even_count():
    """An even cluster's median is the mean of its two middle values; an
    empty cluster keeps its center."""
    from heat_tpu_torch.cluster.kmedians import cluster_medians
    from heat_tpu_torch.parallel.sample_sort import ALONE

    rng = np.random.default_rng(5)
    xs = rng.standard_normal((40, 3)).astype(np.float32)
    lab = rng.integers(0, 3, 40).astype(np.int32)
    lab[lab == 2] = 1  # cluster 2 empty
    old = torch.full((3, 3), 7.0)
    got, counts = cluster_medians(ALONE, torch.from_numpy(xs), torch.from_numpy(lab), old)
    for c in (0, 1):
        np.testing.assert_array_equal(got[c].numpy(), np.median(xs[lab == c], axis=0).astype(np.float32))
    np.testing.assert_array_equal(got[2].numpy(), old[2].numpy())
    assert counts.tolist() == [int((lab == 0).sum()), int((lab == 1).sum()), 0]


@pytest.mark.parametrize("median", [False, True])
def test_batch_parallel_lloyd_matches_reference_from_its_rows(median):
    import jax
    import jax.numpy as jnp
    from heat_tpu.cluster import batchparallelclustering as ref

    key = jax.random.key(3)
    idx = np.asarray(jax.random.choice(key, X.shape[0], (K,), replace=False))
    want, want_it = ref._local_lloyd(jnp.asarray(X), K, 40, key, median, tol=1e-4, plusplus=False)
    got, got_it = local_lloyd(torch.from_numpy(X), torch.from_numpy(X[idx]).float(), 40, median, 1e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    assert got_it == int(want_it)


@pytest.mark.parametrize("name", ["BatchParallelKMeans", "BatchParallelKMedians"])
def test_batch_parallel_fit_recovers_the_blobs(name):
    x = htt.array(X, split=0)
    est = getattr(htt.cluster, name)(n_clusters=K, random_state=4).fit(x)
    centers = est.cluster_centers_.numpy()
    for m in MEANS:
        assert np.linalg.norm(centers - m, axis=1).min() < 0.5
    assert _same_partition(est.labels_.numpy(), LAB)
    np.testing.assert_array_equal(est.predict(x).numpy(), est.labels_.numpy())
    assert est.labels_.split == 0 and 1 <= est.n_iter_ <= 300
    with pytest.raises(ValueError):
        getattr(htt.cluster, name)(n_clusters=K).fit(htt.array(X))  # split=None, as the reference


def test_batch_parallel_predict_matches_reference_on_the_same_centers():
    ref = heat_tpu.cluster.BatchParallelKMeans(n_clusters=K, random_state=1).fit(heat_tpu.array(X, split=0))
    state = {"cluster_centers_": ref.cluster_centers_.numpy(), "labels_": ref.labels_.numpy(), "n_iter_": ref.n_iter_}
    port = convert.batchparallel_from_reference(state, median=False)
    np.testing.assert_array_equal(port.predict(htt.array(X, split=0)).numpy(), ref.predict(heat_tpu.array(X)).numpy())


def _rbf(pkg, sigma):
    return lambda x: pkg.spatial.rbf(x, sigma=sigma, quadratic_expansion=True)


SMALL, _, _, SMALL_LAB = _blobs(n=60, d=3, k=3, seed=8, spread=6.0)


@pytest.mark.parametrize("split", [0, None])
@pytest.mark.parametrize("definition", ["norm_sym", "simple"])
def test_laplacian_fully_connected_matches_reference(definition, split):
    got = htt.graph.Laplacian(_rbf(htt, 2.0), definition=definition).construct(htt.array(SMALL, split=split))
    want = heat_tpu.graph.Laplacian(_rbf(heat_tpu, 2.0), definition=definition).construct(
        heat_tpu.array(SMALL, split=split))
    assert got.split == want.split and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("key", ["upper", "lower"])
def test_laplacian_eneighbour_matches_reference(key):
    a = np.exp(-((SMALL[:, None] - SMALL[None]) ** 2).sum(-1) / 8.0)
    vals = np.sort(a[np.triu_indices(60, 1)])
    gap = np.argmax(np.diff(vals[len(vals) // 4: 3 * len(vals) // 4])) + len(vals) // 4
    thr = float((vals[gap] + vals[gap + 1]) / 2)  # a threshold in the widest gap: no value near it
    got = htt.graph.Laplacian(_rbf(htt, 2.0), mode="eNeighbour", threshold_key=key,
                              threshold_value=thr).construct(htt.array(SMALL, split=0))
    want = heat_tpu.graph.Laplacian(_rbf(heat_tpu, 2.0), mode="eNeighbour", threshold_key=key,
                                    threshold_value=thr).construct(heat_tpu.array(SMALL, split=0))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


def test_spectral_matches_reference():
    hx = heat_tpu.array(SMALL, split=0)
    ref = heat_tpu.cluster.Spectral(n_clusters=3, gamma=0.125, n_lanczos=60)
    ref_evals = np.sort(np.asarray(ref._spectral_embedding(hx)[0]))
    ref.fit(hx)
    x = htt.array(SMALL, split=0)
    est = htt.cluster.Spectral(n_clusters=3, gamma=0.125, n_lanczos=60)
    evals = np.sort(est._spectral_embedding(x)[0].numpy())
    np.testing.assert_allclose(evals, ref_evals, atol=1e-4)
    est.fit(x)
    assert _same_partition(est.labels_.numpy(), ref.labels_.numpy())
    assert _same_partition(est.labels_.numpy(), SMALL_LAB)
    assert est.predict(x) is est.labels_ and est.labels_.split == 0
    with pytest.raises(NotImplementedError):
        est.predict(htt.array(SMALL[:10]))
    auto = htt.cluster.Spectral(gamma=0.125, n_lanczos=60).fit(x)  # k from the largest eigengap
    assert auto._cluster.n_clusters == 3


@pytest.mark.parametrize("name", ["KMeans", "KMedians", "KMedoids"])
def test_a_feature_split_array_fits_on_its_rows(name):
    """An array split along its features is resplit to its rows (one
    Alltoall), fitted as the reference fits it, its labels split 0."""
    hx = heat_tpu.array(X, split=1)
    ref = _reference(name, max_iter=30).fit(hx)
    x = htt.array(X, split=1)
    est = getattr(htt.cluster, name)(n_clusters=K, init=INIT, max_iter=30).fit(x)
    np.testing.assert_allclose(est.cluster_centers_.numpy(), ref.cluster_centers_.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(est.labels_.numpy(), ref.labels_.numpy())
    assert est.n_iter_ == ref.n_iter_
    assert est.labels_.split == 0
    np.testing.assert_array_equal(est.predict(x).numpy(), ref.predict(hx).numpy())


@pytest.mark.parametrize("name", ["KMedians", "KMedoids"])
def test_from_reference_predicts_the_references_labels(name):
    ref = _reference(name, max_iter=30).fit(heat_tpu.array(X, split=0))
    state = {"cluster_centers_": ref.cluster_centers_.numpy(), "labels_": ref.labels_.numpy(),
             "inertia_": ref.inertia_, "n_iter_": ref.n_iter_}
    port = getattr(convert, f"{name.lower()}_from_reference")(state)
    assert isinstance(port, getattr(htt.cluster, name))
    np.testing.assert_array_equal(port.predict(htt.array(X, split=0)).numpy(),
                                  ref.predict(heat_tpu.array(X, split=0)).numpy())
    assert port.n_iter_ == ref.n_iter_
