"""heat_tpu_torch's solvers (``linalg/solver.py``) and tile views
(``core/tiling.py``) against heat_tpu.

At world size 1 on the CPU, on the same numpy inputs (``np.random.
default_rng``) as the reference on its 8-device CPU mesh: ``cg`` on a
symmetric positive definite system, ``lanczos`` from an explicit ``v0`` (the
packages' random streams differ), ``solve_triangular`` blocked and native,
upper and lower, one and several right-hand sides, at every split of A and
b.  The tile views are index algebra that depends on the world size, so
they are held against the reference on a communicator of one device
(``MPI_SELF``) at world size 1.

Tolerances (float32): solutions rtol 1e-4, atol 1e-5 (another order of the
same sums; cg stops at its own residual); Lanczos' basis and tridiagonal
atol 1e-4; the tiles exactly.
"""

import warnings

import numpy as np
import pytest

import heat_tpu
import heat_tpu_torch as htt

RNG = np.random.default_rng(51)
N = 40
M = RNG.standard_normal((N, N)).astype(np.float32)
SPD = (M @ M.T / N + np.eye(N)).astype(np.float32)
B = RNG.standard_normal(N).astype(np.float32)
B2 = RNG.standard_normal((N, 3)).astype(np.float32)
UPPER = (np.triu(RNG.standard_normal((N, N))) + 4 * np.eye(N)).astype(np.float32)
V0 = RNG.standard_normal(N).astype(np.float32)
V0 /= np.linalg.norm(V0)
SPLITS = [None, 0, 1]


@pytest.fixture(autouse=True)
def on_cpu():
    prev = htt.get_device()
    htt.use_device("cpu")
    yield
    htt.use_device(prev)


def both(fn, *arrays_splits):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return tuple(fn(pkg, *[pkg.array(a, split=s) for a, s in arrays_splits]) for pkg in (htt, heat_tpu))


def meta(got, want):
    assert tuple(got.shape) == tuple(want.shape) and got.split == want.split, (got.split, want.split)
    assert got.dtype.__name__ == want.dtype.__name__


@pytest.mark.parametrize("sb", [None, 0])
@pytest.mark.parametrize("sa", SPLITS)
def test_cg_matches_reference(sa, sb):
    got, want = both(lambda ht, a, b: ht.linalg.cg(a, b, tol=1e-6), (SPD, sa), (B, sb))
    meta(got, want)
    np.testing.assert_allclose(got.numpy(), np.asarray(want.numpy()), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.linalg.solve(SPD.astype(np.float64), B), rtol=1e-4, atol=1e-5)


def test_cg_stops_at_maxit_and_writes_out():
    got, want = both(lambda ht, a, b, o: ht.linalg.cg(a, b, maxit=3, out=o), (SPD, 0), (B, 0), (np.zeros(N, np.float32), 0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want.numpy()), rtol=1e-4, atol=1e-5)
    x0 = htt.array(np.linalg.solve(SPD.astype(np.float64), B).astype(np.float32), split=0)
    np.testing.assert_allclose(htt.linalg.cg(htt.array(SPD, split=0), htt.array(B, split=0), x0=x0,
                                             tol=1e-3).numpy(), x0.numpy())


@pytest.mark.parametrize("sa", SPLITS)
def test_lanczos_from_v0_matches_reference(sa):
    got, want = both(lambda ht, a, v: ht.linalg.lanczos(a, 12, v0=v), (SPD, sa), (V0, None))
    for g, w in zip(got, want):
        meta(g, w)
        np.testing.assert_allclose(g.numpy(), np.asarray(w.numpy()), atol=1e-4)
    v, t = got[0].numpy(), got[1].numpy()
    np.testing.assert_allclose(v.T @ v, np.eye(12), atol=1e-4)
    np.testing.assert_allclose(v.T @ SPD @ v, t, atol=1e-4)


@pytest.mark.parametrize("rhs", ["vector", "matrix"])
@pytest.mark.parametrize("blocked", [True, False])
@pytest.mark.parametrize("lower", [False, True])
@pytest.mark.parametrize("sa", SPLITS)
def test_solve_triangular_matches_reference(sa, lower, blocked, rhs):
    a = UPPER.T.copy() if lower else UPPER
    b = B if rhs == "vector" else B2
    for sb in (None, 0):
        got, want = both(lambda ht, x, y: ht.linalg.solve_triangular(x, y, lower=lower, blocked=blocked), (a, sa),
                         (b, sb))
        meta(got, want)
        np.testing.assert_allclose(got.numpy(), np.asarray(want.numpy()), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(a @ got.numpy(), b, rtol=1e-4, atol=1e-4)


def test_solve_triangular_rejects_a_non_square_matrix():
    with pytest.raises(ValueError):
        htt.linalg.solve_triangular(htt.array(UPPER[:, :5]), htt.array(B))


def _self_comm():
    return heat_tpu.core.communication.MPI_SELF


@pytest.mark.parametrize("shape", [(10, 7), (7, 10), (9, 9)])
@pytest.mark.parametrize("tiles", [1, 2, 3])
def test_square_diag_tiles_match_reference(shape, tiles):
    a = RNG.standard_normal(shape).astype(np.float32)
    got = htt.tiling.SquareDiagTiles(htt.array(a, split=0), tiles_per_proc=tiles)
    want = heat_tpu.core.tiling.SquareDiagTiles(heat_tpu.array(a, split=0, comm=_self_comm()), tiles_per_proc=tiles)
    assert (got.tile_rows, got.tile_columns) == (want.tile_rows, want.tile_columns)
    assert got.row_indices == [int(v) for v in want.row_indices]
    assert got.col_indices == [int(v) for v in want.col_indices]
    for i in range(got.tile_rows):
        for j in range(got.tile_columns):
            np.testing.assert_array_equal(got[i, j].numpy(), np.asarray(want[i, j]))
    got[0, 0] = 5.0
    assert np.all(got.arr.numpy()[got._slice(0, 0)] == 5.0)


@pytest.mark.parametrize("split", SPLITS)
def test_split_tiles_match_reference(split):
    a = RNG.standard_normal((6, 5)).astype(np.float32)
    got = htt.tiling.SplitTiles(htt.array(a, split=split))
    want = heat_tpu.core.tiling.SplitTiles(heat_tpu.array(a, split=split, comm=_self_comm()))
    assert [list(d) for d in got.tile_dimensions] == [list(d) for d in want.tile_dimensions]
    np.testing.assert_array_equal(got.tile_locations, want.tile_locations)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    got[0, 0] = np.zeros((6, 5), np.float32)
    assert np.all(got.arr.numpy() == 0)
