"""heat_tpu_torch.linalg.basics against heat_tpu.linalg.basics.

``matmul``'s split table over all nine (a.split, b.split) cases and the 1-D
operands, ``matmul_summa`` and every other function of the module once, at
world size 1 on the CPU, on the same numpy inputs (ragged: 37 x 29 x 31) as
the reference on its 8-device CPU mesh: global value, dtype, shape and
split.  Tolerances: matmul and dot rtol 1e-5 of the largest entry (float32
sums of 29 terms in another order); other float32 results rtol 1e-5, atol
1e-6; integer results exactly.  The two-rank cases are in
``test_torch_resplit_mp.py``.
"""

import numpy as np
import pytest
import torch

import heat_tpu
import heat_tpu_torch as htt
from heat_tpu.linalg import basics as ref_basics
from heat_tpu_torch.linalg import basics
from test_torch_ops import both, same

RNG = np.random.default_rng(5)
A = RNG.standard_normal((37, 29)).astype(np.float32)
B = RNG.standard_normal((29, 31)).astype(np.float32)
V = RNG.standard_normal(29).astype(np.float32)
S = RNG.standard_normal((9, 9)).astype(np.float32)
BATCH = RNG.standard_normal((3, 37, 29)).astype(np.float32)
I = RNG.integers(-4, 5, (6, 5)).astype(np.int32)


@pytest.fixture(autouse=True)
def on_cpu():
    prev = htt.get_device()
    htt.use_device("cpu")
    yield
    htt.use_device(prev)


def product(got, want):
    w = np.asarray(want.numpy())
    same(got, want, rtol=1e-5, atol=1e-5 * float(np.abs(w).max()))


@pytest.mark.parametrize("sb", [None, 0, 1])
@pytest.mark.parametrize("sa", [None, 0, 1])
def test_matmul_split_table_matches_reference(sa, sb):
    """The result's split is the reference code's table: row for (0, *) and
    (1, None), col for (None, 0/1) and (1, 0/1)."""
    got = htt.matmul(htt.array(A, split=sa), htt.array(B, split=sb))
    want = heat_tpu.matmul(heat_tpu.array(A, split=sa), heat_tpu.array(B, split=sb))
    product(got, want)
    assert basics._matmul_result_split(sa, sb, 2) == ref_basics._matmul_result_split(sa, sb, 2)


@pytest.mark.parametrize("case", ["vec_mat", "mat_vec", "vec_vec", "batch_mat", "mat_batch"])
@pytest.mark.parametrize("splits", [(None, None), (0, None), (None, 0), (0, 0), (0, 1), (1, 0)])
def test_matmul_of_vectors_and_batches_matches_reference(case, splits):
    a, b = {"vec_mat": (V, B), "mat_vec": (A, V), "vec_vec": (V, V), "batch_mat": (BATCH, B),
            "mat_batch": (B.T.copy(), np.transpose(BATCH, (0, 2, 1)).copy())}[case]
    sa, sb = (s if s is None or s < x.ndim else None for s, x in zip(splits, (a, b)))
    got = htt.matmul(htt.array(a, split=sa), htt.array(b, split=sb))
    want = heat_tpu.matmul(heat_tpu.array(a, split=sa), heat_tpu.array(b, split=sb))
    product(got, want)


def test_matmul_summa_methods_and_operator_match_reference():
    for sa, sb in ((0, 0), (1, None)):
        product(htt.linalg.matmul_summa(htt.array(A, split=sa), htt.array(B, split=sb)),
                heat_tpu.linalg.matmul_summa(heat_tpu.array(A, split=sa), heat_tpu.array(B, split=sb)))
    for method in ("auto", "gspmd", "summa"):
        product(htt.matmul(htt.array(A, split=0), htt.array(B, split=0), method=method),
                heat_tpu.matmul(heat_tpu.array(A, split=0), heat_tpu.array(B, split=0), method=method))
    product(*both(lambda ht, a: a @ a.T, A))
    with pytest.raises(ValueError):
        htt.matmul(htt.array(A), htt.array(B), method="ring")
    with pytest.raises(ValueError):
        htt.matmul(htt.array(A), htt.array(A))
    with pytest.raises(ValueError):
        htt.linalg.matmul_summa(htt.array(V), htt.array(B))


def test_summa_dispatch_table_holds_only_measured_cards():
    """Entries only from a measurement on cards (four H100s); on the CPU and
    at world size 1 'auto' takes the gather route."""
    assert set(basics._SUMMA_DISPATCH) == {("gpu", 4)}
    assert not basics._summa_wins(htt.array(A, split=0), htt.array(B, split=0))
    from types import SimpleNamespace

    def operand(n, split=0, p=4, platform="gpu"):
        return SimpleNamespace(ndim=2, split=split, shape=(n, n), comm=SimpleNamespace(size=p),
                               device=SimpleNamespace(device_type=platform))

    assert basics._summa_wins(operand(16384), operand(16384))
    assert not basics._summa_wins(operand(8192), operand(8192))
    assert not basics._summa_wins(operand(16384, p=2), operand(16384, p=2))
    assert not basics._summa_wins(operand(16384, platform="cpu"), operand(16384, platform="cpu"))
    assert not basics._summa_wins(operand(16384), operand(16384, split=1))


def test_matmul_at_world_one_is_one_local_product():
    """At world size 1 ``ht.matmul`` is ``torch.matmul`` of the local tensors, bit for bit."""
    a, b = htt.array(A, split=0), htt.array(B, split=0)
    assert torch.equal(htt.matmul(a, b).larray, torch.matmul(a.larray, b.larray))


def test_dot_vdot_outer_match_reference():
    for s in (None, 0):
        product(*both(lambda ht, x, y: ht.dot(x, y), V, V, split=s))
        product(*both(lambda ht, x, y: ht.dot(x, y), A, B, split=s))
        same(*both(lambda ht, x, y: ht.vdot(x, y), A, A * 2, split=s), rtol=1e-5, atol=1e-4)
    for split in (None, 0, 1):
        same(*both(lambda ht, x, y: ht.outer(x, y, split=split), V, A[:, 0].copy(), split=0))
    same(*both(lambda ht, x, y: ht.outer(x, y), V, V, split=None))


def test_trace_transpose_tril_triu_match_reference():
    for s in (None, 0, 1):
        for offset in (-2, 0, 3):
            same(*both(lambda ht, x: ht.trace(x, offset=offset), S, split=s))
        same(*both(lambda ht, x: ht.trace(x, dtype=ht.float32), I, split=s))
        same(*both(lambda ht, x: ht.transpose(x), A, split=s))
        for k in (-1, 0, 2):
            same(*both(lambda ht, x: ht.tril(x, k), S, split=s))
            same(*both(lambda ht, x: ht.triu(x, k), S, split=s))
    same(*both(lambda ht, x: ht.transpose(x, (1, 2, 0)), BATCH, split=2))
    same(*both(lambda ht, x: x.transpose() + x.T + x.tril(1) + x.triu(-1), S))


@pytest.mark.parametrize("ord", [None, 2, 1, 0, 3, float("inf"), float("-inf")])
def test_vector_norm_matches_reference(ord):
    for split in (None, 0, 1):
        for axis in (None, 0, 1):
            if ord is None and axis is not None:
                continue
            same(*both(lambda ht, x: ht.vector_norm(x, axis=axis, ord=2 if ord is None else ord), A, split=split))
        same(*both(lambda ht, x: ht.vector_norm(x, axis=1, keepdims=True, ord=2 if ord is None else ord), A,
                   split=split))


@pytest.mark.parametrize("ord", ["fro", 1, -1, float("inf"), float("-inf"), 2, -2, "nuc"])
def test_matrix_norm_and_norm_match_reference(ord):
    for split in (None, 0, 1):
        same(*both(lambda ht, x: ht.matrix_norm(x, ord=ord), A, split=split), rtol=1e-4, atol=1e-4)
        same(*both(lambda ht, x: ht.norm(x, axis=(0, 1), ord=ord), A, split=split), rtol=1e-4, atol=1e-4)
    same(*both(lambda ht, x: ht.norm(x, axis=(1, 2), ord=ord), BATCH, split=0), rtol=1e-4, atol=1e-4)
    same(*both(lambda ht, x: ht.matrix_norm(x, ord=ord, keepdims=True), BATCH, split=0), rtol=1e-4, atol=1e-4)


def test_norm_dispatch_matches_reference():
    for split in (None, 0, 1):
        same(*both(lambda ht, x: ht.norm(x), A, split=split))
        same(*both(lambda ht, x: ht.norm(x, axis=1), A, split=split))
        same(*both(lambda ht, x: ht.norm(x, axis=0, keepdims=True), A, split=split))
        same(*both(lambda ht, x: ht.norm(x, ord=1), V, split=split if split != 1 else None))
        same(*both(lambda ht, x: ht.norm(x, ord="fro"), A, split=split), rtol=1e-4)
