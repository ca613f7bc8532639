"""heat_tpu_torch's PCA, IncrementalPCA and DMD against heat_tpu.

At world size 1 on the CPU, on the same numpy inputs as the reference on
its 8-device CPU mesh.  Singular values within 1e-4 of the largest, the
components (and SVD-based factors) column by column up to sign within
1e-4, the explained-variance ratios within 1e-4.  ``hsvd`` is held on
exact-rank inputs (its block count depends on the world size, so only
there do both packages truncate alike), as ``tests/test_torch_qr_svd.py``
does; ``'randomized'`` draws its sketch from the port's own stream and is
held on an exact-rank input too.  DMD's eigenvalues are held as a set
(sorted by real, then imaginary part) within 1e-4, its forecasts within
1e-4 of their largest entry; with ``'hierarchical'`` the leaves (4 blocks
at world size 1, 8 on the reference's mesh) approximate alike only to
``HSVD_TOL``, within which both hold the system's known eigenvalues.
"""

import warnings

import numpy as np
import pytest

import heat_tpu
import heat_tpu_torch as htt
from heat_tpu_torch.utils import convert

TOL = 1e-4
HSVD_TOL = 2e-2
RNG = np.random.default_rng(17)


def _low_rank(n, d, r, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, r)) @ np.diag(np.linspace(8, 1, r)) @ rng.standard_normal((r, d))
    return (a + rng.standard_normal(d) * 3).astype(np.float32)


FULL = RNG.standard_normal((300, 12)).astype(np.float32) * np.linspace(4, 0.5, 12).astype(np.float32)
RANK5 = _low_rank(300, 12, 5, 3)


@pytest.fixture(autouse=True)
def on_cpu():
    prev = htt.get_device()
    htt.use_device("cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        yield
    htt.use_device(prev)


def close(got, want, tol=TOL):
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


def close_up_to_sign(got, want, tol=TOL, axis=0):
    """Rows (axis 0) or columns (axis 1) equal up to each one's sign."""
    g, w = (got, want) if axis == 0 else (got.T, want.T)
    signs = np.sign(np.sum(g * w, axis=1, keepdims=True))
    close(g * signs, w, tol)


CASES = [("full", 5, FULL), ("full", 0.9, FULL), ("hierarchical", 5, RANK5), ("randomized", 5, RANK5)]


@pytest.mark.parametrize("split", [0, None])
@pytest.mark.parametrize("solver,k,data", CASES, ids=[f"{c[0]}-{c[1]}" for c in CASES])
def test_pca_matches_reference(solver, k, data, split):
    ref = heat_tpu.decomposition.PCA(n_components=k, svd_solver=solver).fit(heat_tpu.array(data, split=split))
    x = htt.array(data, split=split)
    pca = htt.decomposition.PCA(n_components=k, svd_solver=solver).fit(x)
    assert pca.n_components_ == ref.n_components_
    close(pca.singular_values_.numpy(), ref.singular_values_.numpy())
    close(pca.explained_variance_ratio_.numpy(), ref.explained_variance_ratio_.numpy())
    close(pca.explained_variance_.numpy(), ref.explained_variance_.numpy())
    close(pca.mean_.numpy(), ref.mean_.numpy())
    close_up_to_sign(pca.components_.numpy(), ref.components_.numpy())
    assert abs(pca.total_explained_variance_ratio_ - ref.total_explained_variance_ratio_) < TOL
    t = pca.transform(x)
    want = ref.transform(heat_tpu.array(data, split=split))
    assert t.split == want.split and t.shape == want.shape
    close_up_to_sign(t.numpy(), want.numpy(), axis=1)
    back = pca.inverse_transform(t)
    close(back.numpy(), ref.inverse_transform(want).numpy(), tol=1e-3)


def test_pca_on_identical_state_transforms_as_reference():
    ref = heat_tpu.decomposition.PCA(n_components=4, svd_solver="full").fit(heat_tpu.array(FULL, split=0))
    state = {key: getattr(ref, key).numpy() for key in ("components_", "mean_", "singular_values_",
                                                        "explained_variance_", "explained_variance_ratio_")}
    pca = convert.pca_from_reference(state)
    for split in (0, 1, None):
        got = pca.transform(htt.array(FULL, split=split))
        want = ref.transform(heat_tpu.array(FULL, split=split))
        assert got.split == want.split
        close(got.numpy(), want.numpy())
        close(pca.inverse_transform(got).numpy(), ref.inverse_transform(want).numpy())


def test_pca_refuses_whiten_and_unknown_solvers():
    with pytest.raises(NotImplementedError):
        htt.decomposition.PCA(whiten=True)
    with pytest.raises(ValueError):
        htt.decomposition.PCA(svd_solver="bogus").fit(htt.array(FULL))


@pytest.mark.parametrize("split", [0, None])
def test_hsvd_on_exact_rank_inputs(split):
    got = htt.linalg.svdtools.hsvd_rank(htt.array(RANK5 - RANK5.mean(0), split=split), 5, compute_sv=True)
    want = heat_tpu.linalg.hsvd_rank(heat_tpu.array(RANK5 - RANK5.mean(0), split=split), 5, compute_sv=True)
    close(got[1].numpy(), want[1].numpy())
    close_up_to_sign(got[2].numpy(), want[2].numpy(), axis=1)


@pytest.mark.parametrize("split", [0, None])
def test_incremental_pca_matches_reference(split):
    ref = heat_tpu.decomposition.IncrementalPCA(n_components=4, batch_size=70).fit(heat_tpu.array(FULL, split=split))
    x = htt.array(FULL, split=split)
    ipca = htt.decomposition.IncrementalPCA(n_components=4, batch_size=70).fit(x)
    assert ipca.n_samples_seen_ == ref.n_samples_seen_ == FULL.shape[0]
    close(ipca.singular_values_.numpy(), ref.singular_values_.numpy())
    close(ipca.mean_.numpy(), ref.mean_.numpy())
    close_up_to_sign(ipca.components_.numpy(), ref.components_.numpy())
    close_up_to_sign(ipca.transform(x).numpy(), ref.transform(heat_tpu.array(FULL, split=split)).numpy(), axis=1)
    state = {"components_": ref.components_.numpy(), "singular_values_": ref.singular_values_.numpy(),
             "mean_": ref.mean_.numpy(), "n_samples_seen_": ref.n_samples_seen_}
    same = convert.incremental_pca_from_reference(state)
    close(same.transform(x).numpy(), ref.transform(heat_tpu.array(FULL, split=split)).numpy())


def _linear_system(n=200, m=30, r=6, seed=9):
    """Snapshots x_{t+1} = A x_t of a rank-r linear system with known
    eigenvalues (a damped rotation pair and real decays)."""
    rng = np.random.default_rng(seed)
    lam = np.array([0.95, 0.9, 0.8, 0.7], np.float64)
    theta = 0.3
    block = np.zeros((r, r))
    block[:2, :2] = 0.97 * np.array([[np.cos(theta), -np.sin(theta)], [np.sin(theta), np.cos(theta)]])
    block[2:, 2:] = np.diag(lam)
    basis, _ = np.linalg.qr(rng.standard_normal((n, r)))
    z = rng.standard_normal(r)
    snaps = []
    for _ in range(m):
        snaps.append(basis @ z)
        z = block @ z
    eig = np.concatenate([0.97 * np.exp([1j * theta, -1j * theta]), lam])
    return np.stack(snaps, 1).astype(np.float32), eig


SNAPS, EIGS = _linear_system()


def _sorted(ev):
    ev = np.asarray(ev)
    return ev[np.lexsort((ev.imag, np.round(ev.real, 2)))]  # a conjugate pair's real parts may differ by ulps


@pytest.mark.parametrize("split", [0, None])
@pytest.mark.parametrize("solver,kw", [("full", {"svd_rank": 6}), ("full", {"svd_tol": 1e-5}),
                                       ("hierarchical", {"svd_rank": 6}), ("randomized", {"svd_rank": 6})])
def test_dmd_matches_reference(solver, kw, split):
    ref = heat_tpu.decomposition.DMD(svd_solver=solver, **kw).fit(heat_tpu.array(SNAPS, split=split))
    x = htt.array(SNAPS, split=split)
    dmd = htt.decomposition.DMD(svd_solver=solver, **kw).fit(x)
    assert dmd.n_modes_ == ref.n_modes_ == 6
    got, want = _sorted(dmd.rom_eigenvalues_.numpy()), _sorted(ref.rom_eigenvalues_.numpy())
    tol = HSVD_TOL if solver == "hierarchical" else TOL
    np.testing.assert_allclose(got, want, atol=tol)
    np.testing.assert_allclose(got, _sorted(EIGS), atol=tol if solver == "hierarchical" else 1e-3)
    assert dmd.rom_basis_.split == ref.rom_basis_.split
    x0 = SNAPS[:, 0]
    p = dmd.predict(htt.array(x0, split=split), 5)
    q = ref.predict(heat_tpu.array(x0, split=split), 5)
    assert p.shape == q.shape and p.split == q.split
    close(p.numpy(), q.numpy(), tol)
    close(p.numpy(), SNAPS[:, 1:6].T, max(tol, 1e-3))
    n1 = dmd.predict_next(htt.array(SNAPS[:, :3], split=split), 2)
    m1 = ref.predict_next(heat_tpu.array(SNAPS[:, :3], split=split), 2)
    assert n1.shape == m1.shape and n1.split == m1.split
    close(n1.numpy(), m1.numpy(), tol)


def test_dmd_on_identical_state_predicts_as_reference():
    ref = heat_tpu.decomposition.DMD(svd_rank=6).fit(heat_tpu.array(SNAPS, split=0))
    state = {key: getattr(ref, key).numpy() for key in ("rom_basis_", "rom_transfer_matrix_", "rom_eigenvalues_",
                                                        "rom_eigenmodes_", "dmdmodes_")}
    dmd = convert.dmd_from_reference(state)
    x0 = SNAPS[:, 0]
    close(dmd.predict(htt.array(x0, split=0), [1, 4, 7]).numpy(), ref.predict(heat_tpu.array(x0, split=0),
                                                                               [1, 4, 7]).numpy())
    close(dmd.predict_next(htt.array(x0, split=0), 3).numpy(), ref.predict_next(heat_tpu.array(x0, split=0),
                                                                                 3).numpy())
