"""heat_tpu_torch's QR and SVD (``linalg/qr.py``, ``linalg/svdtools.py``)
against heat_tpu.

At world size 1 on the CPU, on the same numpy inputs (``np.random.
default_rng``) as the reference on its 8-device CPU mesh: shapes, splits
and values.  QR is unique only up to the signs of R's diagonal, and the SVD
up to the signs of its singular vectors: Q.D and D.R are held against the
reference's Q and R, with D = sign(diag R) sign(diag R_ref), and U and V
column by column up to sign.  ``rsvd`` draws its sketch from the port's own
random stream, so it is held by its property: a rank-r input recovered.

Tolerances (float32): factors and singular values atol 1e-4 times the
largest entry, rtol 1e-4; A = QR and Q^T Q = I within 1e-4, the limits of
the reference's own tests (``tests/test_linalg.py``); the ill-conditioned
case (kappa ~ 1e7) as the reference holds it, QR within 1e-5 and Q^T Q
within 1e-3.
"""

import importlib
import warnings

import numpy as np
import pytest
import torch

import heat_tpu
import heat_tpu_torch as htt

qr_mod = importlib.import_module("heat_tpu_torch.linalg.qr")  # the package's ``qr`` is the function

RNG = np.random.default_rng(21)
TALL = RNG.standard_normal((200, 16)).astype(np.float32)
RAGGED = RNG.standard_normal((203, 17)).astype(np.float32)
WIDE = RNG.standard_normal((10, 16)).astype(np.float32)
SQUARE = RNG.standard_normal((24, 24)).astype(np.float32)
INTS = RNG.integers(-9, 10, (60, 6)).astype(np.int32)
TOL = 1e-4


@pytest.fixture(autouse=True)
def on_cpu():
    prev = htt.get_device()
    htt.use_device("cpu")
    yield
    htt.use_device(prev)


def both(fn, a, split):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn(htt, htt.array(a, split=split)), fn(heat_tpu, heat_tpu.array(a, split=split))


def close(got, want, tol=TOL):
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


def meta(got, want):
    assert tuple(got.shape) == tuple(want.shape) and got.split == want.split, (got.shape, got.split, want.shape,
                                                                                want.split)
    assert got.dtype.__name__ == want.dtype.__name__


def hold_qr(got, want, a):
    """Q.D and D.R against the reference's, and the factorization's own properties."""
    meta(got.R, want.R)
    r, r_ref = got.R.numpy(), np.asarray(want.R.numpy())
    k = min(r.shape)
    d = np.sign(np.diag(r)[:k]) * np.sign(np.diag(r_ref)[:k])
    close(d[:, None] * r[:k], r_ref[:k])
    assert np.all(np.tril(r, -1) == 0)
    if want.Q is None:
        assert got.Q is None
        return
    meta(got.Q, want.Q)
    q = got.Q.numpy()
    close(q[:, :k] * d, np.asarray(want.Q.numpy())[:, :k])
    close(q @ r, a.astype(np.float32))
    close(q.T @ q, np.eye(q.shape[1]))


def hold_columns(got, want):
    """Column by column up to sign."""
    g, w = got.numpy(), np.asarray(want.numpy())
    assert g.shape == w.shape
    signs = np.sign(np.sum(g * w, axis=0))
    close(g * signs, w)


@pytest.mark.parametrize("method", ["auto", "cholqr2", "householder"])
@pytest.mark.parametrize("split", [None, 0, 1])
def test_qr_matches_reference(split, method):
    for a in (TALL, RAGGED, SQUARE):
        hold_qr(*both(lambda ht, x: ht.linalg.qr(x, method=method), a, split), a)


@pytest.mark.parametrize("split", [None, 0, 1])
def test_qr_mode_r_forms_no_q(split):
    got, want = both(lambda ht, x: ht.linalg.qr(x, mode="r"), TALL, split)
    assert got.Q is None and want.Q is None
    hold_qr(got, want, TALL)


@pytest.mark.parametrize("split", [0, 1])
def test_tsqr_matches_reference(split):
    for mode in ("reduced", "r"):
        got, want = both(lambda ht, x: ht.linalg.tsqr(x, mode=mode), RAGGED, split)
        hold_qr(got, want, RAGGED)


@pytest.mark.parametrize("split", [None, 0, 1])
def test_qr_of_a_wide_matrix_matches_reference(split):
    """Split 0 with fewer rows than columns takes the replicated path (the
    reference's too: its shards are shorter than n); split 1 gathers and
    keeps R's column split."""
    hold_qr(*both(lambda ht, x: ht.linalg.qr(x), WIDE, split), WIDE)


def test_qr_of_integers_is_householder_in_float32():
    hold_qr(*both(lambda ht, x: ht.linalg.qr(x), INTS, 0), INTS)


def test_qr_cholqr2_ill_conditioned_takes_householder():
    """kappa ~ 1e7 breaks the Gram's Cholesky (kappa^2 >> 1/eps in float32):
    the block takes Householder, as the reference's ``lax.cond`` does, and
    the factors are the Householder ones to the bit."""
    rng = np.random.default_rng(12)
    u, _ = np.linalg.qr(rng.normal(size=(1024, 16)))
    v, _ = np.linalg.qr(rng.normal(size=(16, 16)))
    bad = ((u * np.logspace(0, -7, 16)) @ v).astype(np.float32)
    for pkg in (htt, heat_tpu):
        q, r = pkg.linalg.qr(pkg.array(bad, split=0), method="cholqr2")
        np.testing.assert_allclose(q.numpy() @ r.numpy(), bad, atol=1e-5)
        np.testing.assert_allclose(q.numpy().T @ q.numpy(), np.eye(16), atol=1e-3)
    t = torch.from_numpy(bad)
    q, r = qr_mod._tall_qr(t, "cholqr2")
    hq, hr = qr_mod._householder(t)
    assert torch.equal(q, hq) and torch.equal(r, hr)


def test_qr_products_run_in_full_float32_and_restore_the_callers_precision():
    flags = torch.backends.cuda.matmul
    old = flags.fp32_precision
    flags.fp32_precision = "tf32"
    try:
        q, r = htt.linalg.qr(htt.array(TALL, split=0))
        assert flags.fp32_precision == "tf32"
        close(q.numpy().T @ q.numpy(), np.eye(16))
    finally:
        flags.fp32_precision = old


def test_qr_validates_and_binds_the_method():
    a = htt.array(np.eye(8, 4, dtype=np.float32), split=0)
    for kwargs in ({"method": "bogus"}, {"mode": "complete"}):
        with pytest.raises(ValueError):
            htt.linalg.qr(a, **kwargs)
    with pytest.raises(ValueError):
        htt.linalg.qr(htt.array(np.ones((2, 2, 2), dtype=np.float32)))
    q, r = a.qr()
    close(q.numpy() @ r.numpy(), np.eye(8, 4))


def hold_svd(got, want):
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        meta(g, w)
    close(got.S.numpy(), np.asarray(want.S.numpy()))
    hold_columns(got.U, want.U)
    hold_columns(got.V, want.V)


@pytest.mark.parametrize("split", [None, 0, 1])
def test_svd_matches_reference(split):
    for a in (TALL, RAGGED, WIDE.T.copy(), WIDE, SQUARE):
        got, want = both(lambda ht, x: ht.linalg.svd(x), a, split)
        hold_svd(got, want)
        u, s, v = got
        close(u.numpy() @ np.diag(s.numpy()) @ v.numpy().T, a)


@pytest.mark.parametrize("split", [None, 0, 1])
def test_svd_values_only_match_reference(split):
    for a in (TALL, WIDE):
        got, want = both(lambda ht, x: ht.linalg.svd(x, compute_uv=False), a, split)
        meta(got, want)
        close(got.numpy(), np.asarray(want.numpy()))


def known_rank(m, n, r, seed):
    rng = np.random.default_rng(seed)
    u, _ = np.linalg.qr(rng.standard_normal((m, r)))
    v, _ = np.linalg.qr(rng.standard_normal((n, r)))
    s = np.linspace(10.0, 1.0, r)
    return ((u * s) @ v.T).astype(np.float32), s


@pytest.mark.parametrize("split", [None, 0, 1])
def test_hsvd_rank_on_an_exact_rank_input_matches_reference(split):
    """Rank 5 <= maxrank: the result does not depend on the column blocks
    (4 here at world size 1, 8 on the reference's mesh)."""
    a, s = known_rank(64, 32, 5, 31)
    got, want = both(lambda ht, x: ht.linalg.hsvd_rank(x, 5, compute_sv=True), a, split)
    for g, w in zip(got[:3], want[:3]):
        meta(g, w)
    close(got[1].numpy(), np.asarray(want[1].numpy()))
    close(got[1].numpy(), s)
    hold_columns(got[0], want[0])
    hold_columns(got[2], want[2])
    assert got[3] < 1e-5 and want[3] < 1e-5
    u = both(lambda ht, x: ht.linalg.hsvd_rank(x, 5), a, split)
    meta(*u)
    hold_columns(*u)


@pytest.mark.parametrize("split", [None, 0])
def test_hsvd_rank_at_full_rank_is_the_svd(split):
    got, want = both(lambda ht, x: ht.linalg.hsvd_rank(x, 16, compute_sv=True, safetyshift=0), TALL[:64], split)
    close(got[1].numpy(), np.asarray(want[1].numpy()))
    close(got[1].numpy(), np.linalg.svd(TALL[:64], compute_uv=False))
    hold_columns(got[0], want[0])
    assert got[3] < TOL


@pytest.mark.parametrize("split", [None, 0, 1])
def test_hsvd_rtol_matches_reference(split):
    a, s = known_rank(64, 32, 5, 32)
    got, want = both(lambda ht, x: ht.linalg.hsvd_rtol(x, 1e-3, compute_sv=True), a, split)
    close(got[1].numpy()[:5], np.asarray(want[1].numpy())[:5])
    close(got[1].numpy()[:5], s)
    assert got[0].split == want[0].split and got[2].split == want[2].split
    assert got[3] < 1e-5 and want[3] < 1e-5
    hold_columns(got[0][:, :5], want[0][:, :5])


@pytest.mark.parametrize("split", [None, 0, 1])
def test_rsvd_recovers_a_rank_r_input(split):
    a, s = known_rank(120, 40, 6, 33)
    htt.random.seed(3)
    u, sv, v = htt.linalg.rsvd(htt.array(a, split=split), 6)
    ru, rs, rv = heat_tpu.linalg.rsvd(heat_tpu.array(a, split=split), 6)
    for g, w in ((u, ru), (sv, rs), (v, rv)):
        meta(g, w)
    close(sv.numpy(), s)
    un, vn = u.numpy(), v.numpy()
    close(un.T @ un, np.eye(6))
    close((un * sv.numpy()) @ vn.T, a)


@pytest.mark.parametrize("kappa,householder", [(10.0, False), (1e3, False), (1e4, False), (1e8, True)])
def test_cholqr2_keeps_q_orthogonal_until_its_gram_fails_cholesky(kappa, householder):
    """CholeskyQR2 keeps Q orthogonal to float32 rounding over kappa(A) up
    to 1e4 (past the 1/sqrt(eps) ~ 2.9e3 the reference's docstring names);
    where the Gram fails Cholesky (kappa 1e8), the block is Householder's
    to the bit, as the reference's ``lax.cond`` chooses."""
    rng = np.random.default_rng(13)
    u, _ = np.linalg.qr(rng.normal(size=(2000, 12)))
    v, _ = np.linalg.qr(rng.normal(size=(12, 12)))
    a = torch.from_numpy(((u * np.logspace(0, -np.log10(kappa), 12)) @ v).astype(np.float32))
    q, r = qr_mod._tall_qr(a, "cholqr2")
    hq, hr = qr_mod._householder(a)
    assert (torch.equal(q, hq) and torch.equal(r, hr)) is householder
    np.testing.assert_allclose((q @ r).numpy(), a.numpy(), atol=1e-5)
    np.testing.assert_allclose((q.T @ q).numpy(), np.eye(12), atol=1e-5)
