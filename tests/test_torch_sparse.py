"""heat_tpu_torch.sparse against heat_tpu.sparse.

At world size 1 on the CPU, on the same inputs as the reference on its
8-device CPU mesh: the factories (numpy, torch dense and sparse, scipy CSR,
CSC and COO, dense DNDarrays), the attributes, the arithmetic,
``todense``/``to_sparse``/``transpose`` and ``matmul`` (sparse @ dense
vector and matrix; sparse @ sparse against scipy).  Float32 products within 1e-5 of the
largest entry (another order of the same sums); integer products, the
patterns, ``gnnz``, shapes, dtypes and splits exactly.
"""

import warnings

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import heat_tpu
import heat_tpu_torch as htt

TOL = 1e-5
RNG = np.random.default_rng(31)


def _sparse(n, m, density, seed, dtype=np.float32):
    r = np.random.default_rng(seed)
    d = r.standard_normal((n, m)) if dtype != np.int32 else r.integers(-9, 10, (n, m))
    return (d * (r.random((n, m)) < density)).astype(dtype)


S = _sparse(13, 9, 0.3, 1)
T = _sparse(13, 9, 0.3, 2)
SI = _sparse(13, 9, 0.3, 3, np.int32)
D = RNG.standard_normal((9, 4)).astype(np.float32)
DI = RNG.integers(-9, 10, (9, 4)).astype(np.int32)
W = RNG.standard_normal(9).astype(np.float32)


@pytest.fixture(autouse=True)
def on_cpu():
    prev = htt.get_device()
    htt.use_device("cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        yield
    htt.use_device(prev)


def hold_sparse(got, want):
    assert got.shape == want.shape and got.gnnz == want.gnnz and got.split == want.split
    assert got.dtype.__name__ == want.dtype.__name__
    np.testing.assert_allclose(got.todense().numpy(), want.todense().numpy(), rtol=TOL, atol=TOL)


def hold_dense(got, want, exact=False):
    w, g = want.numpy(), got.numpy()
    assert got.shape == want.shape and got.split == want.split
    assert got.dtype.__name__ == want.dtype.__name__
    if exact:
        np.testing.assert_array_equal(g, w)
    else:
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL * max(float(np.abs(w).max()), 1e-30))


SOURCES = {
    "numpy": lambda a: a,
    "scipy_csr": sp.csr_matrix,
    "scipy_csc": sp.csc_matrix,
    "scipy_coo": sp.coo_matrix,
}


@pytest.mark.parametrize("source", list(SOURCES))
@pytest.mark.parametrize("a", [S, SI], ids=["f", "i"])
def test_factories(a, source):
    want = heat_tpu.sparse.sparse_csr_matrix(SOURCES[source](a))
    for split in (None, 0):  # the reference's split is its argument
        got = htt.sparse.sparse_csr_matrix(SOURCES[source](a), split=split)
        assert got.split == split
        hold_sparse(htt.sparse.sparse_csr_matrix(SOURCES[source](a)), want)
        np.testing.assert_array_equal(got.todense().numpy(), a)
        assert got.gnnz == want.gnnz and got.dtype.__name__ == want.dtype.__name__


@pytest.mark.parametrize("split", [None, 0])
def test_factories_from_torch_and_dndarrays(split):
    want = heat_tpu.sparse.sparse_csr_matrix(S, split=split)
    for obj in (torch.from_numpy(S), torch.from_numpy(S).to_sparse_csr(), torch.from_numpy(S).to_sparse()):
        hold_sparse(htt.sparse.sparse_csr_matrix(obj, split=split), want)
    hold_sparse(htt.sparse.sparse_csr_matrix(htt.array(S, split=split)),
                heat_tpu.sparse.sparse_csr_matrix(heat_tpu.array(S, split=split)))
    wide = htt.sparse.sparse_csr_matrix(S, dtype=htt.float64, split=split)  # 64 bits kept where asked for
    assert wide.dtype is htt.float64 and wide.gnnz == want.gnnz
    np.testing.assert_array_equal(wide.todense().numpy(), S.astype(np.float64))
    with pytest.raises(NotImplementedError):
        htt.sparse.sparse_csc_matrix(S)
    with pytest.raises(ValueError):
        htt.sparse.sparse_csr_matrix(htt.array(S, split=0), split=1)


def test_attributes():
    got = htt.sparse.sparse_csr_matrix(S, split=0)
    ref = sp.csr_matrix(S)
    np.testing.assert_array_equal(got.indptr.numpy(), ref.indptr)
    np.testing.assert_array_equal(got.indices.numpy(), ref.indices)
    np.testing.assert_array_equal(got.data.numpy(), ref.data)
    np.testing.assert_array_equal(got.lindptr.numpy(), ref.indptr)
    assert got.nnz == got.gnnz == got.lnnz == ref.nnz
    assert got.lshape == (13, 9) and got.ndim == 2
    assert "DCSR_matrix(shape=(13, 9)" in repr(got)
    assert got.astype(htt.float64).dtype is htt.float64 and got.copy().gnnz == got.gnnz


@pytest.mark.parametrize("split", [None, 0])
@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_sparse_arithmetic(op, split):
    a, b = htt.sparse.sparse_csr_matrix(S, split=split), htt.sparse.sparse_csr_matrix(T, split=split)
    ra, rb = heat_tpu.sparse.sparse_csr_matrix(S, split=split), heat_tpu.sparse.sparse_csr_matrix(T, split=split)
    hold_sparse(getattr(htt.sparse, op)(a, b), getattr(heat_tpu.sparse, op)(ra, rb))


@pytest.mark.parametrize("split", [None, 0])
def test_scalar_arithmetic_and_operators(split):
    a = htt.sparse.sparse_csr_matrix(S, split=split)
    ra = heat_tpu.sparse.sparse_csr_matrix(S, split=split)
    hold_sparse(a * 2.5, ra * 2.5)
    hold_sparse(-a, -ra)
    hold_sparse(a / 2.0, ra / 2.0)
    hold_sparse(a + a, ra + ra)
    hold_sparse(a - a, ra - ra)  # cancelled entries stay stored, as the reference's
    with pytest.raises(TypeError):
        htt.sparse.mul(a, np.ones(3))


@pytest.mark.parametrize("split", [None, 0])
def test_dense_round_trips_and_transpose(split):
    x = htt.array(S, split=split)
    s = htt.sparse.to_sparse(x)
    rs = heat_tpu.sparse.to_sparse(heat_tpu.array(S, split=split))
    hold_sparse(s, rs)
    hold_dense(htt.sparse.todense(s), heat_tpu.sparse.todense(rs), exact=True)
    hold_dense(htt.sparse.to_dense(s), heat_tpu.sparse.to_dense(rs), exact=True)
    hold_sparse(htt.sparse.transpose(s), heat_tpu.sparse.transpose(rs))
    with pytest.raises(ValueError):
        htt.sparse.to_sparse(htt.array(S, split=1))


@pytest.mark.parametrize("ss", [None, 0])
@pytest.mark.parametrize("sd", [None, 1])
@pytest.mark.parametrize("a,d", [(S, D), (SI, DI), (S, DI)], ids=["f", "i", "fi"])
def test_matmul_with_a_dense_matrix(a, d, ss, sd):
    got = htt.sparse.matmul(htt.sparse.sparse_csr_matrix(a, split=ss), htt.array(d, split=sd))
    want = heat_tpu.sparse.matmul(heat_tpu.sparse.sparse_csr_matrix(a, split=ss), heat_tpu.array(d, split=sd))
    hold_dense(got, want, exact=a.dtype == d.dtype == np.int32)


@pytest.mark.parametrize("ss", [None, 0])
def test_matmul_with_a_vector(ss):
    s = htt.sparse.sparse_csr_matrix(S, split=ss)
    rs = heat_tpu.sparse.sparse_csr_matrix(S, split=ss)
    hold_dense(s @ htt.array(W, split=0), rs @ heat_tpu.array(W, split=0))


def test_matmul_with_a_sparse_matrix():
    """Against scipy's product (the reference's BCOO product compiles for
    seconds on the CPU): its nonzeros and values, split 0 as the left operand."""
    b = _sparse(9, 6, 0.4, 5)
    got = htt.sparse.sparse_csr_matrix(S, split=0) @ htt.sparse.sparse_csr_matrix(b)
    want = sp.csr_matrix(S) @ sp.csr_matrix(b)
    assert got.shape == (13, 6) and got.split == 0 and got.dtype is htt.float32
    np.testing.assert_allclose(got.todense().numpy(), want.toarray(), rtol=TOL, atol=TOL)
    assert got.gnnz == want.nnz


def test_integer_matmul_past_its_exact_range_raises():
    s = htt.sparse.sparse_csr_matrix(torch.full((2, 3), 2**30, dtype=torch.int64))
    with pytest.raises(ValueError, match="2\\^53"):
        htt.sparse.matmul(s, htt.array(torch.full((3, 2), 2**22, dtype=torch.int64)))
