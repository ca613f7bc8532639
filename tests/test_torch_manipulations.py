"""heat_tpu_torch's manipulations against heat_tpu at world size 1.

Every name of ``heat_tpu/core/manipulations.py`` runs on the same numpy
inputs (from a seed) in both packages, at every split of its input; the
result's global value, dtype, shape and split must be the reference's,
exactly (a manipulation or an order op computes nothing).  ``sort``,
``unique`` and ``topk`` are also held against the reference's sample-sort
paths (``method='sample'``, its unique threshold lowered).  The in-place
names (``put``, ``place``, ``putmask``, ``copyto``, ``fill_diagonal``,
``put_along_axis``) are held by the array they change.
"""

import warnings

import numpy as np
import pytest

import heat_tpu
import heat_tpu_torch as htt

RNG = np.random.default_rng(29)
A = RNG.standard_normal((7, 5)).astype(np.float32)
A[2, 3] = A[5, 1]  # a tie
B = RNG.standard_normal((4, 5)).astype(np.float32)
T3 = RNG.standard_normal((4, 3, 5)).astype(np.float32)
V = RNG.standard_normal(23).astype(np.float32)
VN = V.copy()
VN[[3, 11]] = np.nan
D = RNG.integers(0, 6, size=29).astype(np.int32)
I2 = RNG.integers(-5, 5, size=(6, 4)).astype(np.int32)


@pytest.fixture(autouse=True)
def on_cpu():
    prev = htt.get_device()
    htt.use_device("cpu")
    warnings.simplefilter("ignore")
    yield
    htt.use_device(prev)


def _flat(r):
    if isinstance(r, (list, tuple)):
        out = []
        for v in r:
            out += _flat(v)
        return out
    return [r]


def hold(got, want):
    got, want = _flat(got), _flat(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if not isinstance(w, heat_tpu.DNDarray):
            assert g == w
            continue
        assert (g.dtype.__name__, tuple(g.shape), g.split) == (w.dtype.__name__, tuple(w.shape), w.split)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w.numpy()))


def both(fn):
    hold(fn(htt), fn(heat_tpu))


def _on(data, fn, nd=None):
    """Cases at every split of ``data``."""
    nd = data.ndim if nd is None else nd
    return {s: (lambda ht, s=s: fn(ht, ht.array(data, split=s))) for s in [None, *range(nd)]}


CASES = {
    "ndim_size_shape": _on(T3, lambda ht, x: [ht.ndim(x), ht.size(x), ht.shape(x)]),
    "atleast": _on(V, lambda ht, x: [ht.atleast_1d(x), ht.atleast_2d(x), ht.atleast_3d(x)]),
    "atleast_2d_of_2d": _on(A, lambda ht, x: [ht.atleast_2d(x), ht.atleast_3d(x)]),
    "expand_dims": _on(A, lambda ht, x: [ht.expand_dims(x, 0), x.expand_dims(1), ht.expand_dims(x, -1)]),
    "squeeze": _on(A[None, :, None, :], lambda ht, x: [ht.squeeze(x), x.squeeze(0), ht.squeeze(x, 2)]),
    "flatten_ravel": _on(T3, lambda ht, x: [ht.flatten(x), x.ravel()]),
    "reshape": _on(T3, lambda ht, x: [ht.reshape(x, (12, 5)), x.reshape((5, 12)), ht.reshape(x, (2, -1, 3)),
                                      ht.reshape(x, (60,)), ht.reshape(x, 3, 4, 5)]),
    "reshape_new_split": _on(A, lambda ht, x: [ht.reshape(x, (5, 7), new_split=1), ht.reshape(x, (35,), new_split=0)]),
    "broadcast_to": _on(A[:, :1], lambda ht, x: [ht.broadcast_to(x, (3, 7, 5)), x.broadcast_to((7, 4))]),
    "broadcast_arrays": _on(V[:5], lambda ht, x: ht.broadcast_arrays(x, ht.array(A))),
    "moveaxis": _on(T3, lambda ht, x: [ht.moveaxis(x, 0, -1), x.moveaxis([0, 1], [2, 0])]),
    "swapaxes": _on(T3, lambda ht, x: [ht.swapaxes(x, 0, 2), x.swapaxes(1, 2)]),
    "permute_dims": _on(T3, lambda ht, x: [ht.permute_dims(x, (2, 0, 1)), ht.permute_dims(x)]),
    "matrix_transpose": _on(T3, lambda ht, x: ht.matrix_transpose(x)),
    "rollaxis": _on(T3, lambda ht, x: [ht.rollaxis(x, 2), ht.rollaxis(x, 0, 2)]),
    "concatenate": _on(A, lambda ht, x: [ht.concatenate([x, ht.array(B)]), ht.concatenate([ht.array(B), x], 0),
                                         x.concatenate(x, axis=1), ht.concat([x, x])]),
    "concatenate_split_second": _on(A, lambda ht, x: ht.concatenate([ht.array(A), x, x], axis=0)),
    "stack": _on(A, lambda ht, x: [ht.stack([x, x]), ht.stack([x, x], axis=1), ht.stack([x, x], axis=2)]),
    "hstack_vstack": _on(A, lambda ht, x: [ht.hstack([x, x]), ht.vstack([x, ht.array(B)]), ht.row_stack([x, x])]),
    "stacks_1d": _on(V, lambda ht, x: [ht.hstack([x, x]), ht.vstack([x, x]), ht.dstack([x, x]),
                                       ht.column_stack([x, x])]),
    "dstack_column_stack": _on(A, lambda ht, x: [ht.dstack([x, x]), ht.column_stack([x, x])]),
    "split": _on(A, lambda ht, x: [ht.split(x, [2, 5]), ht.split(x, 5, axis=1), ht.array_split(x, 3),
                                   ht.array_split(x, 2, axis=1)]),
    "hvd_split": _on(T3, lambda ht, x: [ht.hsplit(x, 3), ht.vsplit(x, 2), ht.dsplit(x, [1, 4])]),
    "append": _on(A, lambda ht, x: [ht.append(x, ht.array(B), axis=0), ht.append(x, x, axis=1),
                                    ht.append(x, [1.0, 2.0])]),
    "insert": _on(A, lambda ht, x: [ht.insert(x, 2, 9.0, axis=0), ht.insert(x, [1, 3], np.array([7.0, 8.0], np.float32), axis=1),
                                    ht.insert(x, 4, 5.0), ht.insert(x, [0, 2, 2], 3.0, axis=0)]),
    "delete": _on(A, lambda ht, x: [ht.delete(x, 2, axis=0), ht.delete(x, [0, 4], axis=1), ht.delete(x, [1, 30]),
                                    ht.delete(x, slice(1, 5, 2), axis=0)]),
    "flip": _on(T3, lambda ht, x: [ht.flip(x), ht.flip(x, 0), x.flip(1), ht.flip(x, (0, 2)), ht.fliplr(x),
                                   ht.flipud(x)]),
    "rot90": _on(A, lambda ht, x: [ht.rot90(x), ht.rot90(x, 2), ht.rot90(x, 3), ht.rot90(x, 1, (1, 0))]),
    "roll": _on(A, lambda ht, x: [ht.roll(x, 2, 0), x.roll(-3, 1), ht.roll(x, 4), ht.roll(x, (1, 2), (0, 1)),
                                  ht.roll(x, 9, 0)]),
    "pad": _on(A, lambda ht, x: [ht.pad(x, 2), ht.pad(x, ((1, 3), (0, 2))), ht.pad(x, (2, 1), constant_values=7),
                                 ht.pad(x, 1, mode="edge"), ht.pad(x, ((2, 1), (1, 2)), mode="reflect"),
                                 ht.pad(x, 2, mode="wrap"), ht.pad(x, 1, mode="symmetric")]),
    "repeat": _on(A, lambda ht, x: [ht.repeat(x, 2), x.repeat(3, 0), ht.repeat(x, np.array([1, 0, 2, 1, 1]), 1),
                                    ht.repeat(x, np.arange(7) % 3, 0)]),
    "tile": _on(A, lambda ht, x: [ht.tile(x, 2), x.tile((2, 1)), ht.tile(x, (2, 1, 3))]),
    "resize": _on(A, lambda ht, x: [ht.resize(x, (3, 4)), ht.resize(x, (9, 6))]),
    "unfold": _on(A, lambda ht, x: [ht.unfold(x, 0, 3), ht.unfold(x, 0, 2, 2), ht.unfold(x, 1, 4)]),
    "diag": _on(V[:6], lambda ht, x: [ht.diag(x), ht.diag(x, 2), ht.diag(x, -1), ht.diagflat(x)]),
    "diag_of_2d": _on(A, lambda ht, x: [ht.diag(x), ht.diag(x, 1), ht.diag(x, -2)]),
    "diagonal": _on(T3, lambda ht, x: [ht.diagonal(x), x.diagonal(1), ht.diagonal(x, 0, 1, 2),
                                       ht.diagonal(x, -1, 0, 2)]),
    "resplit_collect_balance": _on(A, lambda ht, x: [ht.resplit(x, 1), ht.resplit(x, None), ht.collect(x),
                                                     ht.balance(x, copy=True), ht.redistribute(x)]),
    "astype": _on(A, lambda ht, x: [ht.astype(x, ht.int32), ht.ascontiguousarray(x), ht.asfortranarray(x, ht.float16)]),
    "take": _on(A, lambda ht, x: [ht.take(x, [3, 0, 34]), ht.take(x, [[1, 2], [6, 0]], axis=0),
                                  x.take([4, 4, 0], axis=1), ht.take(x, 2, axis=1), ht.take(x, [-1, 2], axis=0)]),
    "take_along_axis": _on(A, lambda ht, x: [ht.take_along_axis(x, ht.array(np.argsort(A, 0).astype(np.int32)), 0),
                                             ht.take_along_axis(x, ht.array(np.argsort(A, 1).astype(np.int32)), 1),
                                             ht.take_along_axis(x, ht.array(np.zeros((2, 5), np.int32)), 0)]),
    "compress_extract": _on(A, lambda ht, x: [ht.compress([True, False, True], x, axis=0),
                                              ht.compress([1, 0, 1, 1, 0], x, axis=1), ht.compress([0, 1, 1], x),
                                              ht.extract(ht.array(A > 0), x)]),
    "select_choose": _on(I2, lambda ht, x: [ht.select([x < 0, x > 2], [x, x * 10], default=-7),
                                            ht.choose(ht.array(np.abs(I2) % 3), [x, x + 100, ht.array(I2 * 0)]),
                                            ht.choose(x, [x, x * 2, x * 3], mode="clip"),
                                            ht.choose(x, [x, x * 2, x * 3], mode="wrap")]),
    "piecewise": _on(A, lambda ht, x: ht.piecewise(x, [ht.array(A < -0.5), ht.array(A > 0.5)], [-1.0, 1.0, 0.0])),
    "apply_over_axes": _on(I2, lambda ht, x: [ht.apply_over_axes(lambda a, ax: a.sum(ax), x, [0]),
                                             ht.apply_over_axes(lambda a, ax: a.sum(ax, keepdims=True), x, [0, 1])]),
    "argwhere": _on(A, lambda ht, x: ht.argwhere(x > 0)),
    "argwhere_1d": _on(V, lambda ht, x: ht.argwhere(x > 0)),
    "unwrap": _on(np.cumsum(np.abs(A) * 2, 0), lambda ht, x: [ht.unwrap(x, axis=0), ht.unwrap(x), ht.unwrap(x, 1.0, 0)]),
    "trim_zeros": _on(np.concatenate([np.zeros(4), V[:7], np.zeros(6)]).astype(np.float32),
                      lambda ht, x: [ht.trim_zeros(x), ht.trim_zeros(x, "f"), ht.trim_zeros(x, "b")]),
    "sort": _on(A, lambda ht, x: [ht.sort(x), ht.sort(x, 0), x.sort(1, descending=True), ht.sort(x, 0, True),
                                  ht.argsort(x, 0), x.argsort(1)]),
    "sort_1d_nan": _on(VN, lambda ht, x: [ht.sort(x), ht.sort(x, descending=True), ht.argsort(x)]),
    "sort_ints_ties": _on(D, lambda ht, x: [ht.sort(x), ht.sort(x, descending=True)]),
    "lexsort": _on(I2, lambda ht, x: [ht.lexsort([x, ht.array(I2 % 2)]), ht.lexsort([x, ht.array(I2 % 2)], axis=0)]),
    "lexsort_1d": _on(D, lambda ht, x: ht.lexsort([ht.array(np.arange(29)[::-1].copy()), x])),
    "sort_complex": _on(A, lambda ht, x: ht.sort_complex(x)),
    "partition": _on(A, lambda ht, x: [ht.partition(x, 2), ht.partition(x, 3, axis=0), ht.argpartition(x, 1),
                                       ht.argpartition(x, 4, axis=0)]),
    "topk": _on(A, lambda ht, x: [ht.topk(x, 2), x.topk(3, dim=0), ht.topk(x, 2, largest=False),
                                  ht.topk(x, 1, dim=0, largest=False)]),
    "topk_1d": _on(np.concatenate([V, V[:9]]), lambda ht, x: [ht.topk(x, 3), ht.topk(x, 4, largest=False)]),
    "searchsorted": _on(np.sort(V), lambda ht, x: [ht.searchsorted(x, ht.array(V[:6])), ht.searchsorted(x, V[:4], "right"),
                                                    ht.searchsorted(x, ht.array(V[::-1].copy()))]),
    "unique": _on(I2, lambda ht, x: [ht.unique(x), ht.unique_values(x), ht.unique_counts(x)]),
    "unique_1d": _on(D, lambda ht, x: [ht.unique(x), x.unique(), ht.unique_all(x), ht.unique_inverse(x)]),
    "unique_axis": _on(np.repeat(I2[:3], 2, 0), lambda ht, x: ht.unique(x, axis=0)),
    "unique_nan": _on(np.concatenate([VN, VN[::2]]), lambda ht, x: ht.unique(x)),
    "set_ops": _on(D, lambda ht, x: [ht.union1d(x, ht.array(D[:7] + 4)), ht.intersect1d(x, ht.array(D[::3] + 2)),
                                     ht.setdiff1d(x, ht.array(np.array([0, 3], np.int32))),
                                     ht.setxor1d(x, ht.array(D[:5] + 3))]),
    "shuffle_shape": _on(A, lambda ht, x: ht.sort(ht.shuffle(x), 0)[0]),
    "strings": _on(A, lambda ht, x: [ht.array2string(x), ht.array_str(x) == str(x), ht.array_repr(x) == repr(x)]),
}


@pytest.mark.parametrize("name,split", [(n, s) for n, c in CASES.items() for s in c])
def test_manipulations_match_reference(name, split):
    both(CASES[name][split])


def _inplace(ht, split, op):
    x = ht.array(A, split=split)
    if op == "put":
        ht.put(x, [0, 7, 34, 7], [5.0, 6.0])
    elif op == "put_modes":
        ht.put(x, [-1, 40], [1.5], mode="clip")
    elif op == "place":
        ht.place(x, ht.array(A > 0.5), np.array([1.0, 2.0, 3.0], np.float32))
    elif op == "putmask":
        ht.putmask(x, ht.array(A < 0), ht.array(np.arange(35, dtype=np.float32).reshape(7, 5)))
    elif op == "putmask_cycle":
        ht.putmask(x, ht.array(A < 0), [9.0, -9.0, 1.5])
    elif op == "copyto":
        ht.copyto(x, ht.array(np.arange(5, dtype=np.float32)))
    elif op == "copyto_where":
        ht.copyto(x, 3.0, where=ht.array(A > 0))
    elif op == "fill_diagonal":
        ht.fill_diagonal(x, 0.0)
    elif op == "fill_diagonal_values":
        ht.fill_diagonal(x, np.array([7.0, 8.0], np.float32))
    elif op == "put_along_axis":
        ht.put_along_axis(x, np.argmax(A, 1)[:, None], -1.0, 1)
    return x


INPLACE = ["put", "put_modes", "place", "putmask", "putmask_cycle", "copyto", "copyto_where", "fill_diagonal",
           "fill_diagonal_values", "put_along_axis"]


@pytest.mark.parametrize("split", [None, 0, 1])
@pytest.mark.parametrize("op", INPLACE)
def test_inplace_manipulations_match_reference(op, split):
    both(lambda ht: _inplace(ht, split, op))


@pytest.mark.parametrize("data", [VN, D, np.sort(V)])
def test_sort_matches_the_reference_sample_sort(data):
    both(lambda ht: ht.sort(ht.array(data, split=0), method="sample"))
    both(lambda ht: ht.sort(ht.array(data, split=0), descending=True, method="sample"))


def test_unique_matches_the_reference_distributed_path(monkeypatch):
    monkeypatch.setattr(heat_tpu.core.manipulations, "_DIST_UNIQUE_THRESHOLD", 16)
    both(lambda ht: ht.unique(ht.array(D, split=0), return_inverse=True))
    both(lambda ht: ht.unique(ht.array(np.concatenate([VN, VN]), split=0)))


def test_topk_matches_the_reference_merge_path():
    x = np.concatenate([V, V[:17]])  # 40 elements: k <= n / 8 on the reference's mesh
    both(lambda ht: [ht.topk(ht.array(x, split=0), 5), ht.topk(ht.array(x, split=0), 3, largest=False)])


@pytest.mark.parametrize("split", [None, 0, 1])
def test_fill_diagonal_wraps_as_numpy(split):
    """The reference's ``jnp.fill_diagonal`` has no ``wrap``; numpy is the witness."""
    a = np.zeros((11, 3), np.float32)
    x = htt.array(a, split=split)
    htt.fill_diagonal(x, [7.0, 8.0], wrap=True)
    np.fill_diagonal(a, [7.0, 8.0], wrap=True)
    np.testing.assert_array_equal(x.numpy(), a)


def test_apply_along_axis_matches_numpy():
    x = htt.array(A, split=0)
    got = htt.apply_along_axis(lambda r: r.sum() * 2, 1, x)
    np.testing.assert_allclose(got.numpy(), np.apply_along_axis(lambda r: r.sum() * 2, 1, A), rtol=1e-6)
    assert got.split == 0
    got = htt.apply_along_axis(lambda r: r[:2], 0, x)
    np.testing.assert_array_equal(got.numpy(), A[:2])


def test_results_do_not_share_storage_with_their_source():
    x = htt.array(A, split=0)
    for y in (htt.expand_dims(x, 0), htt.squeeze(htt.expand_dims(x, 0)), htt.reshape(x, (35,)), htt.flip(x, 1),
              htt.broadcast_to(x, (7, 5)), htt.swapaxes(x, 0, 1), htt.split(x, 5, axis=1)[0], htt.roll(x, 0, 1)):
        assert y.larray.untyped_storage().data_ptr() != x.larray.untyped_storage().data_ptr()


def _chip_smoke():
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location("chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _stats_ops(ht):
    """chip_smoke's phase 3c operations on small arrays of the same layouts."""
    X = ht.array(np.arange(64, dtype=np.float32).reshape(16, 4) / 7, split=0)
    v = ht.array(np.linspace(0, 1, 64, dtype=np.float32), split=0)
    w = ht.array(np.arange(64, dtype=np.int32) % 9, split=0)
    A = ht.array(np.ones((16, 16), np.float32), split=0)
    M = ht.array(np.eye(4, dtype=np.float32) * 2, split=0)
    ops = {"rand": lambda: ht.random.rand(16, 4, split=0), "randn": lambda: ht.random.randn(16, 4, split=0),
           "randint": lambda: ht.random.randint(0, 9, (16, 4), split=0),
           "cov(X, rowvar=False)": lambda: ht.cov(X, rowvar=False),
           "histogram(X[:, 0], 100)": lambda: ht.histogram(X[:, 0], 100)[0],
           "sort(v)": lambda: ht.sort(v)[0], "argsort(v)": lambda: ht.argsort(v),
           "percentile(v, [5, 50, 95])": lambda: ht.percentile(v, [5, 50, 95]), "median(v)": lambda: ht.median(v),
           "topk(v, 1000)": lambda: ht.topk(v, 4)[0], "searchsorted(v, q)": lambda: ht.searchsorted(v, ht.array(V)),
           "unique(w)": lambda: ht.unique(w), "reshape(X, (5e7, 64))": lambda: ht.reshape(X, (8, 8)),
           "concatenate(X halves)": lambda: ht.concatenate([X[:8], X[8:]]), "roll(X, 1000, 0)": lambda: ht.roll(X, 5, 0),
           "pad(A, 8)": lambda: ht.pad(A, 2), "einsum('ij,ik->jk', X, X)": lambda: ht.einsum("ij,ik->jk", X, X),
           "kron(a, b)": lambda: ht.kron(A[:4, :4], ht.array(np.ones((4, 4), np.float32))),
           "det(M)": lambda: ht.linalg.det(M), "inv(M)": lambda: ht.linalg.inv(M)}
    for op in ("mean", "var", "std", "argmax"):
        for axis, key in ((0, f"{op}(X, 0)"), (1, f"{op}(X, 1)"), (None, f"{op}(X)")):
            ops[key] = lambda op=op, axis=axis: getattr(ht, op)(X, axis)
    return ops


def test_chip_smoke_stats_splits_are_the_references():
    """``chip_smoke.STATS_SPLITS`` holds the JAX package's result split of
    each phase-3c operation (on its 8-device mesh), and the port gives the
    same."""
    table = _chip_smoke().STATS_SPLITS
    want, got = _stats_ops(heat_tpu), _stats_ops(htt)
    assert set(table) == set(want)
    for key, fn in want.items():
        assert fn().split == table[key], key
        assert got[key]().split == table[key], key
