"""heat_tpu_torch KMeans against heat_tpu KMeans, and the slice's data/convert helpers.

The same numpy blobs and explicit initial centers go to both packages: the
reference fits on its 8-device CPU mesh at split=0 and split=None, the port
at world size 1 on the CPU.  Tolerances: centers rtol/atol 1e-4 and inertia
rtol 1e-4 (float32 sums of the same rows in another order); labels,
predictions and n_iter exactly (no row sits near a tie in these blobs).
"""

import numpy as np
import pytest
import torch

import heat_tpu
import heat_tpu_torch as htt
from heat_tpu_torch.utils.convert import array_from_numpy, kmeans_from_reference


@pytest.fixture
def on_cpu():
    prev = htt.get_device()
    htt.use_device("cpu")
    yield
    htt.use_device(prev)


def _blobs(n=1500, d=8, k=5, seed=0):
    rng = np.random.default_rng(seed)
    means = rng.uniform(-10, 10, (k, d))
    lab = rng.integers(0, k, n)
    X = (means[lab] + rng.standard_normal((n, d))).astype(np.float32)
    init = X[rng.choice(n, k, replace=False)]
    return X, init


@pytest.fixture(scope="module")
def reference_fits():
    X, init = _blobs()
    fits = {}
    for kernel in ("pallas", "jnp"):
        for split in (0, None):
            hx = heat_tpu.array(X, split=split)
            km = heat_tpu.cluster.KMeans(n_clusters=5, init=init, assign_kernel=kernel).fit(hx)
            fits[kernel, split] = dict(
                centers=km.cluster_centers_.numpy(), labels=km.labels_.numpy(),
                predict=km.predict(hx).numpy(), n_iter=km.n_iter_, inertia=km.inertia_,
            )
    return X, init, fits


@pytest.mark.parametrize("ref_split", [0, None])
@pytest.mark.parametrize("kernel", ["pallas", "jnp"])
def test_fit_predict_match_reference(kernel, ref_split, reference_fits, on_cpu):
    X, init, fits = reference_fits
    ref = fits[kernel, ref_split]
    x = htt.array(X, split=0)
    km = htt.cluster.KMeans(n_clusters=5, init=init, assign_kernel=kernel).fit(x)
    assert km.n_iter_ > 1  # the loop ran, not just the init
    np.testing.assert_allclose(km.cluster_centers_.numpy(), ref["centers"], rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(km.labels_.numpy(), ref["labels"])
    np.testing.assert_array_equal(km.predict(x).numpy(), ref["predict"])
    assert km.n_iter_ == ref["n_iter"]
    np.testing.assert_allclose(km.inertia_, ref["inertia"], rtol=1e-4)
    assert km.labels_.split == 0 and km.labels_.dtype is htt.int32
    assert km.cluster_centers_.split is None and km.cluster_centers_.dtype is htt.float32


def test_kernel_and_torch_paths_agree(on_cpu):
    X, init = _blobs(n=1200, d=6, k=4, seed=3)
    x = htt.array(X, split=None)
    a = htt.cluster.KMeans(n_clusters=4, init=init, assign_kernel="pallas").fit(x)
    b = htt.cluster.KMeans(n_clusters=4, init=init, assign_kernel="jnp").fit(x)
    np.testing.assert_allclose(a.cluster_centers_.numpy(), b.cluster_centers_.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(a.fit_predict(x).numpy(), b.labels_.numpy())
    assert a.functional_value_ == a.inertia_


def test_assign_kernel_resolution_and_validation(on_cpu):
    with pytest.raises(ValueError):
        htt.cluster.KMeans(assign_kernel="bogus")
    x = htt.array(_blobs(n=50)[0], split=0)
    assert not htt.cluster.KMeans(assign_kernel="auto")._use_kernel(x)  # CPU: the torch path
    assert htt.cluster.KMeans(assign_kernel="pallas")._use_kernel(x)
    assert not htt.cluster.KMeans(assign_kernel="jnp")._use_kernel(x)
    with pytest.raises(ValueError):
        htt.cluster.KMeans(n_clusters=3, init=np.zeros((2, 8), np.float32)).fit(x)
    with pytest.raises(ValueError):
        htt.cluster.KMeans(n_clusters=3, init="nope").fit(x)
    with pytest.raises(RuntimeError):
        htt.cluster.KMeans(n_clusters=3).predict(x)
    with pytest.raises(TypeError):
        htt.cluster.KMeans(n_clusters=3).fit(np.zeros((5, 2)))
    assert htt.cluster.KMeans(n_clusters=7).get_params()["n_clusters"] == 7


@pytest.mark.parametrize("init", ["random", "kmeans++"])
def test_random_inits(init, on_cpu):
    X, _ = _blobs(n=900, d=4, k=3, seed=5)
    x = htt.array(X, split=0)
    km = htt.cluster.KMeans(n_clusters=3, init=init, random_state=11, assign_kernel="pallas").fit(x)
    again = htt.cluster.KMeans(n_clusters=3, init=init, random_state=11, assign_kernel="pallas").fit(x)
    np.testing.assert_array_equal(km.cluster_centers_.numpy(), again.cluster_centers_.numpy())
    assert np.isfinite(km.inertia_) and np.isfinite(km.cluster_centers_.numpy()).all()
    c0, _ = km._initialize_cluster_centers(x)
    rows = {tuple(r) for r in X}
    assert len({tuple(r) for r in c0.numpy()}) == 3  # three distinct rows of X
    assert all(tuple(r) in rows for r in c0.numpy())


def test_kmeans_plusplus_recovers_separated_blobs(on_cpu):
    rng = np.random.default_rng(2)
    means = np.array([[0.0] * 5, [30.0] * 5, [-30.0] * 5, [30.0, -30.0, 0.0, 0.0, 0.0]])
    X = (np.repeat(means, 400, axis=0) + rng.standard_normal((1600, 5))).astype(np.float32)
    km = htt.cluster.KMeans(n_clusters=4, init="kmeans++", random_state=0).fit(htt.array(X, split=0))
    got = km.cluster_centers_.numpy()
    dist = np.sqrt(((means[:, None] - got[None]) ** 2).sum(-1)).min(1)
    assert dist.max() < 0.2  # ~sqrt(5/400) sampling error of each blob mean


def test_bfloat16_fit_keeps_bfloat16_centers(on_cpu):
    X, init = _blobs(n=600, d=8, k=5, seed=6)
    xb = htt.array(X, split=0, dtype=htt.bfloat16)
    km = htt.cluster.KMeans(n_clusters=5, init=X[:5].astype(np.float32), assign_kernel="pallas")
    km.init = xb[[0, 1, 2, 3, 4]]
    km.fit(xb)
    assert km.cluster_centers_.dtype is htt.bfloat16
    assert np.isfinite(km.cluster_centers_.numpy()).all()
    assert km.predict(xb).shape == (600,)


def test_create_clusters_and_spherical(on_cpu):
    means = np.array([[0.0, 0.0, 0.0], [10.0, 10.0, 10.0], [-10.0, 5.0, 0.0]], np.float32)
    x = htt.utils.data.create_clusters(3001, 3, 3, means, cluster_std=0.5, random_state=4)
    assert x.shape == (3001, 3) and x.split == 0 and x.dtype is htt.float32
    X = x.numpy()
    np.testing.assert_allclose(X[:1000].mean(0), means[0], atol=0.1)
    np.testing.assert_allclose(X[2000:].mean(0), means[2], atol=0.1)  # the last cluster takes the remainder
    np.testing.assert_allclose(X[:1000].std(0), 0.5, atol=0.05)
    np.testing.assert_array_equal(
        htt.utils.data.create_clusters(3001, 3, 3, means, cluster_std=0.5, random_state=4).numpy(), X)
    w = htt.utils.data.create_clusters(100, 2, 2, [0.0, 5.0], cluster_weight=[0.3, 0.7], dtype=htt.bfloat16)
    assert w.dtype is htt.bfloat16 and abs(w.numpy()[30:].mean() - 5.0) < 0.5
    s = htt.utils.data.create_spherical_dataset(50)
    assert s.shape == (200, 3) and s.split == 0
    with pytest.raises(ValueError):
        htt.utils.data.create_clusters(10, 2, 3, np.zeros((2, 2)))


def test_kmeans_from_reference_predicts_like_reference(on_cpu):
    X, init = _blobs(n=700, d=8, k=5, seed=8)
    hx = heat_tpu.array(X, split=0)
    ref = heat_tpu.cluster.KMeans(n_clusters=5, init=init).fit(hx)
    state = {
        "cluster_centers_": ref.cluster_centers_.numpy(), "labels_": ref.labels_.numpy(),
        "inertia_": ref.inertia_, "n_iter_": ref.n_iter_,
    }
    km = kmeans_from_reference(state)
    Y = _blobs(n=300, d=8, k=5, seed=9)[0]
    np.testing.assert_array_equal(km.predict(array_from_numpy(Y, 0)).numpy(),
                                  ref.predict(heat_tpu.array(Y, split=0)).numpy())
    np.testing.assert_array_equal(km.labels_.numpy(), state["labels_"])
    assert km.n_iter_ == ref.n_iter_ and km.inertia_ == pytest.approx(ref.inertia_)
    np.testing.assert_array_equal(km.cluster_centers_.numpy(), state["cluster_centers_"])
    assert isinstance(km.cluster_centers_.larray, torch.Tensor)


def test_pallas_fit_of_float64_numpy_data_matches_reference(on_cpu):
    """numpy's default float64 data and init narrow to float32 on ingest, as
    in the reference, so the kernel path takes them (it refuses float64):
    the same 20 Lloyd steps, centres float32 to rtol/atol 1e-5 (float32 sums
    of the same 2000 rows in another order)."""
    X = np.random.default_rng(0).random((2000, 4))
    km = htt.cluster.KMeans(3, init=X[:3], assign_kernel="pallas", max_iter=20).fit(htt.array(X))
    ref = heat_tpu.cluster.KMeans(3, init=X[:3], assign_kernel="pallas", max_iter=20).fit(heat_tpu.array(X))
    assert km.cluster_centers_.dtype is htt.float32 and ref.cluster_centers_.dtype.__name__ == "float32"
    assert km.n_iter_ == ref.n_iter_
    np.testing.assert_allclose(km.cluster_centers_.numpy(), ref.cluster_centers_.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(km.inertia_, ref.inertia_, rtol=1e-5)
