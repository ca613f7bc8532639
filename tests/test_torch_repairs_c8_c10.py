"""Repairs of three faults of the port against heat_tpu (ROADMAP C8-C10).

At world size 1 on the CPU, on the same numpy inputs as the reference on
its 8-device CPU mesh.  X is 40 x 6 standard normal (seed 7) with column
3 set to 2.0.

- C9: the hierarchical SVD of a rank-deficient input.  Every output of
  ``PCA`` and ``hsvd_rank`` is finite; S carries no -0.0; the leading
  components (all but the null one) match the reference's within 1e-4 of
  their largest entry, up to sign, the transform's leading columns too.
- C8: GaussianNB's 1-D labels are split 0 for an input split along its
  features (the reference's split), and can be indexed.
- C10: KNeighborsClassifier's labels are split 0 for queries split along
  their features, as the reference's; the labels are equal.
"""

import warnings

import numpy as np
import pytest

import heat_tpu
import heat_tpu_torch as htt

TOL = 1e-4


@pytest.fixture(autouse=True)
def on_cpu():
    prev = htt.get_device()
    htt.use_device("cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        yield
    htt.use_device(prev)


def _x():
    x = np.random.default_rng(7).standard_normal((40, 6)).astype(np.float32)
    x[:, 3] = 2.0
    return x


X = _x()
X5 = np.delete(X, 3, axis=1)
Y = (X5[:, 0] + 0.3 * X5[:, 1] > 0).astype(np.int32)


def close_up_to_sign(got, want, axis):
    """Rows (axis 0) or columns (axis 1) of got and want equal up to sign."""
    g = got if axis == 0 else got.T
    w = want if axis == 0 else want.T
    signs = np.sign(np.sum(g * w, axis=1, keepdims=True))
    scale = max(float(np.abs(w).max()), 1e-30)
    np.testing.assert_allclose(g * signs, w, rtol=TOL, atol=TOL * scale)


@pytest.mark.parametrize("split", [None, 0, 1])
def test_pca_of_a_constant_column_is_finite_and_matches_the_leading_components(split):
    pca = htt.decomposition.PCA().fit(htt.array(X, split=split))
    ref = heat_tpu.decomposition.PCA().fit(heat_tpu.array(X, split=split))
    comp = pca.components_.numpy()
    assert np.isfinite(comp).all()
    close_up_to_sign(comp[:5], ref.components_.numpy()[:5], axis=0)
    z = htt.decomposition.PCA().fit_transform(htt.array(X, split=split))
    zr = heat_tpu.decomposition.PCA().fit_transform(heat_tpu.array(X, split=split))
    assert np.isfinite(z.numpy()).all()
    assert z.shape == zr.shape
    close_up_to_sign(z.numpy()[:, :5], zr.numpy()[:, :5], axis=1)


@pytest.mark.parametrize("split", [None, 0, 1])
def test_hsvd_rank_of_a_rank_deficient_input_is_finite_without_negative_zero(split):
    xc = X - X.mean(0)
    u, s, v, err = htt.linalg.hsvd_rank(htt.array(xc, split=split), maxrank=6, compute_sv=True)
    ur, sr, vr, _ = heat_tpu.linalg.hsvd_rank(heat_tpu.array(xc, split=split), maxrank=6, compute_sv=True)
    sv = s.numpy()
    assert not np.signbit(sv).any()
    assert np.isfinite(u.numpy()).all() and np.isfinite(v.numpy()).all() and np.isfinite(err)
    assert err < 1e-5
    np.testing.assert_allclose(sv[:5], sr.numpy()[:5], rtol=TOL)
    assert sv[5] <= np.finfo(np.float32).eps * sv[0] * 10
    close_up_to_sign(v.numpy()[:, :5], vr.numpy()[:, :5], axis=1)
    close_up_to_sign(u.numpy()[:, :5], ur.numpy()[:, :5], axis=1)


@pytest.mark.parametrize("split", [None, 0, 1])
def test_gaussian_nb_labels_take_the_references_split(split):
    ysplit = None if split is None else 0
    nb = htt.naive_bayes.GaussianNB().fit(htt.array(X5, split=split), htt.array(Y, split=ysplit))
    ref = heat_tpu.naive_bayes.GaussianNB().fit(heat_tpu.array(X5, split=split), heat_tpu.array(Y, split=ysplit))
    p = nb.predict(htt.array(X5, split=split))
    pr = ref.predict(heat_tpu.array(X5, split=split))
    assert p.split == pr.split
    np.testing.assert_array_equal(p.numpy(), pr.numpy())
    hit = (p == 1).numpy()
    np.testing.assert_array_equal(hit, pr.numpy() == 1)
    proba = nb.predict_proba(htt.array(X5, split=split))
    assert proba.split == (None if split is None else 0)
    assert proba.shape == (40, 2)


@pytest.mark.parametrize("k", [1, 5, 40])
@pytest.mark.parametrize("split", [None, 0, 1])
def test_knn_labels_of_split_queries_take_the_references_split(k, split):
    q = X5[:13]
    knn = htt.classification.KNeighborsClassifier(k).fit(htt.array(X5, split=0), htt.array(Y, split=0))
    ref = heat_tpu.classification.KNeighborsClassifier(k).fit(heat_tpu.array(X5, split=0),
                                                              heat_tpu.array(Y, split=0))
    p = knn.predict(htt.array(q, split=split))
    pr = ref.predict(heat_tpu.array(q, split=split))
    assert p.split == pr.split
    np.testing.assert_array_equal(p.numpy(), pr.numpy())
