"""The rest of heat_tpu_torch's ``linalg.basics`` against heat_tpu at world
size 1, and the completeness of this slice's surface.

``det``, ``inv``, ``einsum``, ``tensordot``, ``inner``, ``kron``,
``vecdot``, ``cross`` and ``projection`` run on the same numpy inputs in
both packages at every split pair; values within rtol 1e-5, atol 1e-6 (an
integer result exactly), dtype, shape and split the reference's.  The
completeness test walks the ``__all__`` of the reference's statistics,
manipulations, random and ``linalg.basics`` and finds each name in the port.
"""

import importlib

import numpy as np
import pytest

import heat_tpu
import heat_tpu_torch as htt

RNG = np.random.default_rng(37)
M = (RNG.standard_normal((6, 6)) + 4 * np.eye(6)).astype(np.float32)
BM = (RNG.standard_normal((4, 3, 3)) + 3 * np.eye(3)).astype(np.float32)
A = RNG.standard_normal((7, 5)).astype(np.float32)
B = RNG.standard_normal((5, 4)).astype(np.float32)
C = RNG.standard_normal((7, 4)).astype(np.float32)
C5 = RNG.standard_normal((6, 5)).astype(np.float32)
T3 = RNG.standard_normal((3, 7, 5)).astype(np.float32)
IA = RNG.integers(-9, 9, size=(7, 5)).astype(np.int32)
IB = RNG.integers(-9, 9, size=(5, 4)).astype(np.int32)
U3 = RNG.standard_normal((6, 3)).astype(np.float32)
W3 = RNG.standard_normal((6, 3)).astype(np.float32)
SPLITS = [None, 0, 1]


@pytest.fixture(autouse=True)
def on_cpu():
    prev = htt.get_device()
    htt.use_device("cpu")
    yield
    htt.use_device(prev)


def _flat(r):
    return [v for x in r for v in _flat(x)] if isinstance(r, (list, tuple)) else [r]


def hold(got, want):
    for g, w in zip(_flat(got), _flat(want)):
        assert (g.dtype.__name__, tuple(g.shape), g.split) == (w.dtype.__name__, tuple(w.shape), w.split)
        gv, wv = g.numpy(), np.asarray(w.numpy())
        if gv.dtype.kind in "iub":
            np.testing.assert_array_equal(gv, wv)
        else:
            np.testing.assert_allclose(gv, wv, rtol=1e-5, atol=1e-6)


def both(fn):
    hold(fn(htt), fn(heat_tpu))


@pytest.mark.parametrize("split", SPLITS)
def test_det_and_inv_match_reference(split):
    both(lambda ht: [ht.linalg.det(ht.array(M, split=split)), ht.linalg.inv(ht.array(M, split=split))])


@pytest.mark.parametrize("split", [None, 0, 1, 2])
def test_batched_det_and_inv_keep_the_batch_split(split):
    both(lambda ht: [ht.linalg.det(ht.array(BM, split=split)), ht.linalg.inv(ht.array(BM, split=split))])
    both(lambda ht: ht.linalg.det(ht.array(IA[:5, :5] + 10 * np.eye(5, dtype=np.int32), split=split if split != 2
                                           else None)))


EINSUMS = [("ij,jk->ik", A, B), ("ij,jk", A, B), ("ij,ik->jk", A, C), ("ij->j", A, None), ("ij->i", A, None),
           ("ij->", A, None), ("ij,ij->i", A, A), ("ij,kj->ik", A, B.T.copy()), ("bij,jk->bik", T3, B),
           ("i,i->", A[:, 0].copy(), A[:, 1].copy()), ("ij,jk", IA, IB), ("ji", A, None), ("...j,jk->...k", A, B)]


def _splits(a, b):
    return [(sa, sb) for sa in [None, *range(a.ndim)] for sb in ([None] if b is None else [None, *range(b.ndim)])]


@pytest.mark.parametrize("case,sa,sb", [(c, sa, sb) for c, (_, a, b) in enumerate(EINSUMS) for sa, sb in _splits(a, b)])
def test_einsum_matches_reference(case, sa, sb):
    sub, a, b = EINSUMS[case]
    ops = (lambda ht: [ht.array(a, split=sa)]) if b is None else (lambda ht: [ht.array(a, split=sa),
                                                                               ht.array(b, split=sb)])
    both(lambda ht: ht.linalg.einsum(sub, *ops(ht)))


def test_einsum_path_matches_reference():
    got = htt.linalg.einsum_path("ij,jk,kl->il", htt.array(A), htt.array(B), htt.array(B.T.copy()))
    want = heat_tpu.linalg.einsum_path("ij,jk,kl->il", heat_tpu.array(A), heat_tpu.array(B), heat_tpu.array(B.T.copy()))
    assert got[0] == want[0] and got[1] == want[1]


TENSORDOTS = [(A, B, 1), (A, C, ([0], [0])), (T3, B, ([2], [0])), (T3, T3.transpose(1, 2, 0).copy(), 2), (IA, IB, 1), (A, A, 2)]


@pytest.mark.parametrize("case,sa,sb", [(c, sa, sb) for c, (a, b, _) in enumerate(TENSORDOTS)
                                         for sa, sb in _splits(a, b)])
def test_tensordot_matches_reference(case, sa, sb):
    a, b, axes = TENSORDOTS[case]
    both(lambda ht: ht.linalg.tensordot(ht.array(a, split=sa), ht.array(b, split=sb), axes=axes))


@pytest.mark.parametrize("sb", SPLITS)
@pytest.mark.parametrize("sa", SPLITS)
def test_inner_kron_vecdot_match_reference(sa, sb):
    both(lambda ht: ht.linalg.inner(ht.array(A, split=sa), ht.array(C5, split=sb)))
    both(lambda ht: ht.linalg.inner(ht.array(IA, split=sa), ht.array(IA, split=sb)))
    both(lambda ht: ht.linalg.kron(ht.array(A[:4, :3].copy(), split=sa), ht.array(B[:2, :3].copy(), split=sb)))
    both(lambda ht: ht.linalg.kron(ht.array(IA[:3], split=sa), ht.array(IB[:2, :2].copy(), split=sb)))
    both(lambda ht: ht.linalg.vecdot(ht.array(A, split=sa), ht.array(A, split=sb)))
    both(lambda ht: ht.linalg.vecdot(ht.array(A, split=sa), ht.array(A, split=sb), axis=0))


@pytest.mark.parametrize("sb", SPLITS)
@pytest.mark.parametrize("sa", SPLITS)
def test_cross_and_projection_match_reference(sa, sb):
    both(lambda ht: ht.linalg.cross(ht.array(U3, split=sa), ht.array(W3, split=sb)))
    both(lambda ht: ht.linalg.cross(ht.array(U3[:, :2].copy(), split=sa), ht.array(W3[:, :2].copy(), split=sb)))
    both(lambda ht: ht.linalg.cross(ht.array(U3.T.copy(), split=sa), ht.array(W3.T.copy(), split=sb), axis=0))
    if sa in (None, 0) and sb in (None, 0):
        both(lambda ht: ht.linalg.projection(ht.array(U3[:, 0].copy(), split=sa), ht.array(W3[:, 0].copy(), split=sb)))


def test_top_level_names_are_the_references():
    for name in ("einsum", "einsum_path", "kron", "inner", "tensordot", "vecdot", "cross", "projection"):
        assert hasattr(htt, name) and hasattr(heat_tpu, name), name


MODULES = ["core.statistics", "core.manipulations", "core.random", "linalg.basics"]


@pytest.mark.parametrize("module", MODULES)
def test_every_name_of_the_slice_exists_in_the_port(module):
    ref = importlib.import_module(f"heat_tpu.{module}")
    port = importlib.import_module(f"heat_tpu_torch.{module}")
    missing = [n for n in ref.__all__ if not hasattr(port, n)]
    assert not missing, missing
    top = heat_tpu.random if module == "core.random" else heat_tpu.linalg if module == "linalg.basics" else heat_tpu
    ptop = htt.random if module == "core.random" else htt.linalg if module == "linalg.basics" else htt
    missing = [n for n in ref.__all__ if hasattr(top, n) and not hasattr(ptop, n)]
    assert not missing, missing


METHODS = ["argmax", "argmin", "mean", "var", "std", "average", "median", "percentile", "kurtosis", "skew",
           "expand_dims", "flatten", "ravel", "flip", "reshape", "roll", "squeeze", "sort", "topk", "unique", "repeat",
           "tile", "swapaxes", "moveaxis", "broadcast_to", "concatenate", "diagonal", "shuffle", "take", "argsort"]


@pytest.mark.parametrize("name", METHODS)
def test_the_dndarray_methods_the_reference_binds_exist(name):
    assert hasattr(heat_tpu.DNDarray, name)
    assert callable(getattr(htt.DNDarray, name))
