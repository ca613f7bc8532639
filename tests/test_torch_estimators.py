"""heat_tpu_torch's Lasso, GaussianNB, KNeighborsClassifier and the five
scalers against heat_tpu.

At world size 1 on the CPU, on the same numpy inputs as the reference on
its 8-device CPU mesh.  Tolerances: Lasso's θ within 1e-4 of its largest
entry (the port sweeps in covariance form, in float64, where the
reference recomputes Aθ in float32 for every coordinate) and ``n_iter_``
exactly; GaussianNB's θ, σ² and priors within 1e-4 relative (per-class sums
in float64 across blocks), predictions exactly, log-probabilities within
1e-3 of their magnitude (two GEMMs a block against the reference's direct
sum); KNN's predictions exactly, on tie-free data; the scalers' statistics
and transforms within 1e-5 relative (RobustScaler's medians and quartiles
exactly: order statistics of the same values), their inverses within 1e-5
of the input.
"""

import warnings

import numpy as np
import pytest

import heat_tpu
import heat_tpu_torch as htt
from heat_tpu_torch.utils import convert

RNG = np.random.default_rng(29)


@pytest.fixture(autouse=True)
def on_cpu():
    prev = htt.get_device()
    htt.use_device("cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        yield
    htt.use_device(prev)


def close(got, want, tol):
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


def _regression(n=400, d=12, seed=1):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)).astype(np.float32)
    theta = np.zeros(d)
    theta[[1, 4, 7]] = [2.0, -1.5, 0.8]
    y = (X @ theta + 0.5 + 0.1 * rng.standard_normal(n)).astype(np.float32)
    return X, y


LX, LY = _regression()


@pytest.mark.parametrize("split", [0, None])
@pytest.mark.parametrize("lam,tol", [(0.1, 1e-4), (0.01, 1e-5), (0.5, 1e-3)])
def test_lasso_matches_reference(lam, tol, split):
    ref = heat_tpu.regression.Lasso(lam=lam, max_iter=200, tol=tol)
    ref.fit(heat_tpu.array(LX, split=split), heat_tpu.array(LY, split=split))
    est = htt.regression.Lasso(lam=lam, max_iter=200, tol=tol)
    x = htt.array(LX, split=split)
    est.fit(x, htt.array(LY, split=split))
    close(est.theta.numpy(), ref.theta.numpy(), 1e-4)
    assert est.n_iter_ == ref.n_iter_
    assert est.theta.shape == (LX.shape[1] + 1, 1) and est.theta.split is None
    close(est.coef_.numpy(), ref.coef_.numpy(), 1e-4)
    close(np.asarray(est.intercept_.numpy()), np.asarray(ref.intercept_.numpy()), 1e-4)
    p, q = est.predict(x), ref.predict(heat_tpu.array(LX, split=split))
    assert p.shape == q.shape and p.split == q.split
    close(p.numpy(), q.numpy(), 1e-4)


def test_lasso_on_identical_state_predicts_as_reference():
    ref = heat_tpu.regression.Lasso(lam=0.1).fit(heat_tpu.array(LX, split=0), heat_tpu.array(LY, split=0))
    est = convert.lasso_from_reference({"theta": ref.theta.numpy(), "n_iter_": ref.n_iter_})
    close(est.predict(htt.array(LX, split=0)).numpy(), ref.predict(heat_tpu.array(LX, split=0)).numpy(), 1e-6)


def _classes(n=500, d=6, c=4, seed=2, offset=50.0):
    rng = np.random.default_rng(seed)
    means = rng.uniform(-3, 3, (c, d)) + offset
    y = rng.integers(0, c, n).astype(np.int32) * 3 + 1  # labels 1, 4, 7, 10
    X = (means[(y - 1) // 3] + rng.standard_normal((n, d)) * rng.uniform(0.5, 2.0, d)).astype(np.float32)
    return X, y


GX, GY = _classes()


def _nb_state(nb):
    return {k: getattr(nb, k).numpy() for k in ("classes_", "class_count_", "class_prior_", "theta_", "var_")}


@pytest.mark.parametrize("split", [0, None])
def test_gaussian_nb_fit_and_predict_match_reference(split):
    ref = heat_tpu.naive_bayes.GaussianNB().fit(heat_tpu.array(GX, split=split), heat_tpu.array(GY, split=split))
    x = htt.array(GX, split=split)
    nb = htt.naive_bayes.GaussianNB().fit(x, htt.array(GY, split=split))
    got, want = _nb_state(nb), _nb_state(ref)
    np.testing.assert_array_equal(got["classes_"], want["classes_"])
    np.testing.assert_array_equal(got["class_count_"], want["class_count_"])
    assert nb.class_count_.dtype is htt.int32
    for key in ("class_prior_", "theta_", "var_"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4)
    assert abs(nb.epsilon_ - ref.epsilon_) <= 1e-4 * ref.epsilon_
    hx = heat_tpu.array(GX, split=split)
    p = nb.predict(x)
    assert p.split == ref.predict(hx).split
    np.testing.assert_array_equal(p.numpy(), ref.predict(hx).numpy())
    lp, rlp = nb.predict_log_proba(x).numpy(), ref.predict_log_proba(hx).numpy()
    np.testing.assert_allclose(lp, rlp, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(nb.predict_proba(x).numpy(), ref.predict_proba(hx).numpy(), atol=1e-4)


def test_gaussian_nb_partial_fit_matches_reference():
    ref, nb = heat_tpu.naive_bayes.GaussianNB(), htt.naive_bayes.GaussianNB()
    classes = np.array([1, 4, 7, 10], np.int32)
    for lo, hi in ((0, 180), (180, 330), (330, 500)):
        ref.partial_fit(heat_tpu.array(GX[lo:hi], split=0), heat_tpu.array(GY[lo:hi], split=0), classes=classes)
        nb.partial_fit(htt.array(GX[lo:hi], split=0), htt.array(GY[lo:hi], split=0), classes=classes)
    got, want = _nb_state(nb), _nb_state(ref)
    np.testing.assert_array_equal(got["class_count_"], want["class_count_"])
    for key in ("class_prior_", "theta_", "var_"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4)
    whole = htt.naive_bayes.GaussianNB().fit(htt.array(GX, split=0), htt.array(GY, split=0))
    np.testing.assert_allclose(nb.theta_.numpy(), whole.theta_.numpy(), rtol=1e-5)
    np.testing.assert_allclose(nb.var_.numpy(), whole.var_.numpy(), rtol=1e-4)
    with pytest.raises(ValueError):
        nb.partial_fit(htt.array(GX[:5]), htt.array(np.array([1, 4, 2, 7, 1], np.int32)))
    with pytest.raises(ValueError):
        htt.naive_bayes.GaussianNB().partial_fit(htt.array(GX[:5]), htt.array(GY[:5]))


def test_gaussian_nb_priors_and_identical_state():
    ref = heat_tpu.naive_bayes.GaussianNB(priors=[0.1, 0.2, 0.3, 0.4]).fit(heat_tpu.array(GX, split=0),
                                                                           heat_tpu.array(GY, split=0))
    nb = htt.naive_bayes.GaussianNB(priors=[0.1, 0.2, 0.3, 0.4]).fit(htt.array(GX, split=0), htt.array(GY, split=0))
    np.testing.assert_allclose(nb.class_prior_.numpy(), ref.class_prior_.numpy(), rtol=1e-6)
    with pytest.raises(ValueError):
        htt.naive_bayes.GaussianNB(priors=[0.5, 0.6, 0.1, 0.1]).fit(htt.array(GX), htt.array(GY))
    same = convert.gaussiannb_from_reference({**_nb_state(ref), "epsilon_": ref.epsilon_})
    np.testing.assert_array_equal(same.predict(htt.array(GX, split=0)).numpy(),
                                  ref.predict(heat_tpu.array(GX, split=0)).numpy())


def _knn_data(n=300, q=80, d=4, seed=4):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)).astype(np.float32) * 3
    y = (rng.integers(0, 5, n) * 2).astype(np.int32)
    Q = rng.standard_normal((q, d)).astype(np.float32) * 3
    return X, y, Q


KX, KY, KQ = _knn_data()


@pytest.mark.parametrize("k", [1, 3, 5])
@pytest.mark.parametrize("qsplit", [0, None])
@pytest.mark.parametrize("split", [0, None])
def test_knn_matches_reference(split, qsplit, k):
    ref = heat_tpu.classification.KNeighborsClassifier(k).fit(heat_tpu.array(KX, split=split),
                                                               heat_tpu.array(KY, split=split))
    knn = htt.classification.KNeighborsClassifier(k).fit(htt.array(KX, split=split), htt.array(KY, split=split))
    got = knn.predict(htt.array(KQ, split=qsplit))
    want = ref.predict(heat_tpu.array(KQ, split=qsplit))
    assert got.split == want.split and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    d2 = ((KQ[:, None] - KX[None]) ** 2).sum(-1)
    votes = KY[np.argsort(d2, 1, kind="stable")[:, :k]]
    brute = np.array([np.bincount(v, minlength=10).argmax() for v in votes])
    np.testing.assert_array_equal(got.numpy(), brute)
    same = convert.knn_from_reference(KX, KY, k)
    np.testing.assert_array_equal(same.predict(htt.array(KQ)).numpy(), want.numpy())


def test_knn_blocks_the_queries(monkeypatch):
    from heat_tpu_torch.classification import kneighborsclassifier as mod

    monkeypatch.setattr(mod, "_DISTANCES", 7 * KX.shape[0])  # blocks of 7 queries
    knn = htt.classification.KNeighborsClassifier(5).fit(htt.array(KX, split=0), htt.array(KY, split=0))
    ref = heat_tpu.classification.KNeighborsClassifier(5).fit(heat_tpu.array(KX, split=0), heat_tpu.array(KY, split=0))
    np.testing.assert_array_equal(knn.predict(htt.array(KQ)).numpy(), ref.predict(heat_tpu.array(KQ)).numpy())


SX = (RNG.standard_normal((120, 7)) * np.linspace(0.5, 30, 7) + np.linspace(-40, 40, 7)).astype(np.float32)

SCALERS = [("StandardScaler", {}), ("StandardScaler", {"with_mean": False}), ("MinMaxScaler", {}),
           ("MinMaxScaler", {"feature_range": (-2.0, 3.0), "clip": True}), ("MaxAbsScaler", {}),
           ("RobustScaler", {}), ("RobustScaler", {"quantile_range": (10.0, 90.0), "with_centering": False}),
           ("Normalizer", {}), ("Normalizer", {"norm": "l1"}), ("Normalizer", {"norm": "max"})]
_STATS = ("mean_", "var_", "scale_", "data_min_", "data_max_", "min_", "max_abs_", "center_")


@pytest.mark.parametrize("split", [0, 1, None])
@pytest.mark.parametrize("kind,kw", SCALERS, ids=[f"{k}-{i}" for i, (k, _) in enumerate(SCALERS)])
def test_scalers_match_reference(kind, kw, split):
    ref = getattr(heat_tpu.preprocessing, kind)(**kw).fit(heat_tpu.array(SX, split=split))
    x = htt.array(SX, split=split)
    est = getattr(htt.preprocessing, kind)(**kw).fit(x)
    for key in _STATS:
        want = getattr(ref, key, None)
        if want is not None:
            close(getattr(est, key).numpy(), want.numpy(), 1e-5)
    t, rt = est.transform(x), ref.transform(heat_tpu.array(SX, split=split))
    assert t.split == rt.split and t.shape == rt.shape
    close(t.numpy(), rt.numpy(), 1e-5)
    if kind != "Normalizer" and not kw.get("clip"):
        close(est.inverse_transform(t).numpy(), SX, 1e-5)
        close(est.inverse_transform(t).numpy(), ref.inverse_transform(rt).numpy(), 1e-5)
    state = {key: getattr(ref, key).numpy() if getattr(ref, key, None) is not None else None for key in
             ("mean_", "var_", "scale_", "data_min_", "data_max_", "data_range_", "min_", "max_abs_", "center_")}
    same = convert.scaler_from_reference(kind, state, **kw)
    close(same.transform(x).numpy(), rt.numpy(), 1e-6)


def test_scalers_refuse_as_the_reference():
    with pytest.raises(NotImplementedError):
        htt.preprocessing.RobustScaler(unit_variance=True)
    with pytest.raises(ValueError):
        htt.preprocessing.RobustScaler(quantile_range=(80.0, 20.0))
    with pytest.raises(ValueError):
        htt.preprocessing.MinMaxScaler(feature_range=(1.0, 0.0))
    with pytest.raises(NotImplementedError):
        htt.preprocessing.Normalizer(norm="l3")
