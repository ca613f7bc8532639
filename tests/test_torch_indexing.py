"""heat_tpu_torch's indexing surface against heat_tpu at world size 1.

The port at world size 1 on the CPU, the reference on its 8-device CPU mesh,
on the same numpy inputs: ragged 1-D (13,), 2-D (9, 7) and 3-D (5, 6, 7)
float32 arrays holding nan and -0.0, at every split.  ``KEYS`` holds every
kind of key (ints and negative ints, slices of any step, Ellipsis, None,
integer sequences as lists, numpy, ``torch.Tensor`` and DNDarrays, with
repeats and negatives, several index arrays broadcast together, boolean
masks over every run of axes); each result is held exactly (nan equal, the
sign of zero too), with its dtype, shape and split.  ``__setitem__`` is
held the same way for every value kind (Python scalar, numpy,
``torch.Tensor``, DNDarray at each split), float into int included;
``fill_diagonal``, ``lloc``, ``where``, ``nonzero`` and ``flatnonzero``,
and the rule that a result never shares storage with its source.
"""

import functools
import warnings

import numpy as np
import pytest
import torch

import heat_tpu
import heat_tpu_torch as htt

RNG = np.random.default_rng(13)
A1 = RNG.standard_normal(13).astype(np.float32)
A2 = RNG.standard_normal((9, 7)).astype(np.float32)
A3 = RNG.standard_normal((5, 6, 7)).astype(np.float32)
for _a in (A1, A2, A3):
    _a.flat[[1, 4]] = [np.nan, -0.0]
ARRAYS = {1: A1, 2: A2, 3: A3}
I2 = np.nan_to_num(A2 * 4).astype(np.int32)


@pytest.fixture(autouse=True)
def on_cpu():
    prev = htt.get_device()
    htt.use_device("cpu")
    yield
    htt.use_device(prev)


def _np(a):
    return a


def _tensor(a):
    return torch.as_tensor(a)


# (name, the ndims it is held at, function making the key from the numpy
# array a and the wrapper w that turns an index array into the kind under
# test)
KEYS = [
    ("int", (1, 3), lambda a, w: 2),
    ("negative_int", (1, 3), lambda a, w: -1),
    ("slice", (1, 3), lambda a, w: slice(1, 4)),
    ("slice_step", (1, 3), lambda a, w: slice(1, None, 2)),
    ("slice_reversed", (1, 3), lambda a, w: slice(None, None, -1)),
    ("slice_negative_step", (1, 3), lambda a, w: slice(-2, 0, -3)),
    ("slice_empty", (1, 3), lambda a, w: slice(3, 3)),
    ("ellipsis", (1, 3), lambda a, w: Ellipsis),
    ("none", (1, 3), lambda a, w: None),
    ("list", (1, 3), lambda a, w: [1, 3, 0]),
    ("list_repeats_negatives", (1, 3), lambda a, w: [-1, 2, 2]),
    ("numpy", (1, 3), lambda a, w: np.array([4, 0, 3])),
    ("tensor", (1, 3), lambda a, w: torch.tensor([4, 0, 3])),
    ("array_2d", (1, 3), lambda a, w: w(np.array([[0, 1], [2, 3]]))),
    ("none_slice", (1, 3), lambda a, w: (None, slice(1, 3))),
    ("mask_all", (1, 3), lambda a, w: w(~np.isnan(a) & (a > 0))),
    ("col_int", (2, 3), lambda a, w: (slice(None), 2)),
    ("cols", (2, 3), lambda a, w: (slice(None), w(np.array([1, 2])))),
    ("pairs", (2, 3), lambda a, w: (w(np.array([1, 2])), w(np.array([3, 4])))),
    ("ellipsis_int", (2, 3), lambda a, w: (Ellipsis, 1)),
    ("int_ellipsis", (2, 3), lambda a, w: (1, Ellipsis)),
    ("col_slice", (2, 3), lambda a, w: (slice(None), slice(1, 4))),
    ("scalar", (2, 3), lambda a, w: (2, 3)),
    ("col_reversed_step", (2, 3), lambda a, w: (slice(None), slice(None, None, -2))),
    ("both_reversed", (2, 3), lambda a, w: (slice(None, None, -2), slice(5, 1, -1))),
    ("row_mask", (2, 3), lambda a, w: (w(a[(slice(None),) + (0,) * (a.ndim - 1)] > 0),)),
    ("col_mask", (2, 3), lambda a, w: (slice(None), w(a[0] > 0))),
    ("rows_then_slice", (2, 3), lambda a, w: (w(np.array([0, 2])), slice(None))),
    ("rows_then_reversed", (2, 3), lambda a, w: (w(np.array([4, 2])), slice(None, None, -1))),
    ("none_rows_none", (2, 3), lambda a, w: (None, w(np.array([1, 0])), None)),
    ("broadcast_pairs", (2, 3), lambda a, w: (w(np.array([[0], [1]])), w(np.array([0, 2])))),
    ("int_cols", (2, 3), lambda a, w: (3, w(np.array([a.shape[1] - 1, 0, a.shape[1] - 1])))),
    ("int_rows_step", (3,), lambda a, w: (1, slice(None), w(np.array([0, 4])))),
    ("slice_int_array", (3,), lambda a, w: (slice(None), 0, w(np.array([1, 2])))),
    ("arrays_around_slice", (3,), lambda a, w: (w(np.array([0, 1])), slice(None), w(np.array([2, 3])))),
    ("mask_leading_two", (3,), lambda a, w: (w(a[:, :, 0] > 0),)),
    ("mask_trailing_two", (3,), lambda a, w: (slice(None), w(a[0] > 0))),
    ("mask_then_int", (3,), lambda a, w: (w(a[..., 0] > 0), 1)),
    ("mask_middle", (3,), lambda a, w: (slice(None), w(a[0, :, 0] > 0), slice(1, 3))),
    ("ellipsis_array_none", (3,), lambda a, w: (Ellipsis, w(np.array([1, 2])), None)),
    ("int_array_reversed", (3,), lambda a, w: (0, w(np.array([1, 2])), slice(None, None, -1))),
    ("mask_full", (3,), lambda a, w: w(~np.isnan(a) & (a > 0))),
    ("none_ellipsis_none", (3,), lambda a, w: (None, Ellipsis, None, 2)),
]
CASES = [(name, nd, split) for name, nds, _ in KEYS for nd in nds for split in [None, *range(nd)]]
BUILD = {name: fn for name, _, fn in KEYS}


def _for_reference(key):
    """The key as the reference takes it: a ``torch.Tensor`` as numpy."""
    if isinstance(key, tuple):
        return tuple(_for_reference(k) for k in key)
    return key.numpy() if isinstance(key, torch.Tensor) else key


def _hold(got, want):
    """Exact values (nan equal, -0.0 apart from 0.0), dtype, shape, split."""
    g, w = got.numpy(), np.asarray(want.numpy())
    assert (got.dtype.__name__, got.shape, got.split) == (want.dtype.__name__, want.shape, want.split)
    np.testing.assert_array_equal(g, w)
    assert np.array_equal(np.signbit(g), np.signbit(w))


@functools.lru_cache(maxsize=None)
def _reference(nd, split):
    """The reference's array of ``ARRAYS[nd]`` at ``split``, made once (its
    indexing leaves it as it is)."""
    return heat_tpu.array(ARRAYS[nd], split=split)


@pytest.mark.parametrize("name,nd,split", CASES)
def test_getitem_matches_reference(name, nd, split):
    a = ARRAYS[nd]
    key = BUILD[name](a, _np)
    want = _reference(nd, split)[_for_reference(key)]
    _hold(htt.array(a, split=split)[key], want)


@pytest.mark.parametrize("kind", ["tensor", "dndarray", "dndarray_split"])
@pytest.mark.parametrize("name", ["cols", "pairs", "row_mask", "col_mask", "broadcast_pairs", "int_cols"])
def test_getitem_index_array_kinds(name, kind):
    """The same keys with their index arrays as ``torch.Tensor`` and as
    DNDarrays, replicated and split, against the reference's numpy key."""
    wrap = {"tensor": _tensor, "dndarray": lambda t: htt.array(t), "dndarray_split": lambda t: htt.array(t, split=0)}
    for split in (None, 0, 1):
        want = _reference(2, split)[BUILD[name](A2, _np)]
        _hold(htt.array(A2, split=split)[BUILD[name](A2, wrap[kind])], want)


def test_getitem_of_a_dndarray_mask_and_index_splits():
    x = htt.array(A2, split=0)
    m = htt.array(A2, split=1) > 0
    _hold(x[m], heat_tpu.array(A2, split=0)[heat_tpu.array(A2, split=1) > 0])
    i = htt.array(np.array([8, 0, 8, 3], dtype=np.int32), split=0)
    _hold(x[i], heat_tpu.array(A2, split=0)[heat_tpu.array(np.array([8, 0, 8, 3], dtype=np.int32), split=0)])


@pytest.mark.parametrize("dtype", [np.int32, np.bool_, np.uint8])
def test_getitem_keeps_integer_and_bool_dtypes(dtype):
    a = np.nan_to_num(A2 * 3).astype(dtype) if dtype is not np.bool_ else A2 > 0
    for split in (None, 0, 1):
        for key in ([4, 1, 4], (slice(None), [0, 5]), slice(None, None, -1), (Ellipsis, 2)):
            _hold(htt.array(a, split=split)[key], heat_tpu.array(a, split=split)[key])


def test_probe_splits_of_the_reference_rule():
    """The reference's quirky splits (an index array on the split axis sends
    the result to split 0 wherever numpy places its axis)."""
    a = np.arange(120, dtype=np.float32).reshape(4, 6, 5)
    assert htt.array(a, split=1)[:, [1, 2]].split == 0
    assert htt.array(a, split=0)[[1, 2], [3, 4]].split == 0
    assert htt.array(a, split=2)[[1, 2], [3, 4]].split is None
    assert htt.array(a, split=0)[None, 1:3].split == 1
    assert htt.array(a, split=2)[1, :, [0, 4]].split == 0
    assert htt.array(a, split=1)[::-1].split == 1
    assert htt.array(A2, split=0)[[1, 3, 5]].split == 0


def test_out_of_range_and_malformed_keys_raise():
    x = htt.array(A2, split=0)
    for key in (9, -10, [0, 9], (slice(None), 7), (0, 0, 0)):
        with pytest.raises(IndexError):
            x[key]
    with pytest.raises(IndexError):
        x[np.array([0.5])]
    with pytest.raises(IndexError):
        x[np.ones(8, dtype=bool)]
    with pytest.raises(IndexError):
        x[..., ...]


# ---------------------------------------------------------------------- #
# __setitem__
# ---------------------------------------------------------------------- #
SETS = [
    ("int_scalar", A3, lambda a: 1, 3.5),
    ("cols_scalar", A3, lambda a: (slice(None), [1, 2]), 7.0),
    ("reversed_array", A3, lambda a: slice(None, None, -1), (A3 * 2)[::-1].copy()),
    ("int_slice_cols", A3, lambda a: (1, slice(None), [0, 4]), np.arange(12, dtype=np.float32).reshape(2, 6)),
    ("mask_scalar", A3, lambda a: ~np.isnan(a) & (a > 0), 0.0),
    ("leading_mask_scalar", A3, lambda a: a[:, :, 0] > 0, -1.0),
    ("leading_mask_rows", A3, lambda a: (a[:, :, 0] > 0,),
     np.arange(int((A3[:, :, 0] > 0).sum()) * 7, dtype=np.float32).reshape(-1, 7)),
    ("ellipsis_row", A3, lambda a: (Ellipsis, 2), np.ones(6, np.float32)),
    ("rows_slice", A3, lambda a: ([0, 2], slice(1, 4)), np.full((2, 3, 7), 9.0, np.float32)),
    ("reversed_step_broadcast", A3, lambda a: (slice(None), slice(None, None, -2)), np.arange(7, dtype=np.float32)),
    ("none_int", A3, lambda a: (None, 2), np.zeros((6, 7), np.float32)),
    ("int_array_reversed", A3, lambda a: (0, [1, 2], slice(None, None, -1)),
     np.arange(14, dtype=np.float32).reshape(2, 7)),
    ("float_into_int", I2, lambda a: (slice(None), 3), 2.7),
    ("negative_float_into_int", I2, lambda a: [1, 3], -1.7),
    ("float_array_into_int", I2, lambda a: (slice(None), [0, 6]), np.array([[1.5, -2.5]])),
    ("rows", A2, lambda a: [5, 1, 3], np.arange(21, dtype=np.float32).reshape(3, 7)),
]


# the assignments that also take the value as a tensor and as a DNDarray at
# each of its splits
EVERY_VALUE_KIND = ("reversed_array", "int_slice_cols", "leading_mask_rows", "rows_slice", "rows")


def _values(name, v):
    """(name, function making the port value from its split) of each kind the
    assignment ``name`` takes its value ``v`` as."""
    out = [("python" if np.ndim(v) == 0 else "numpy", lambda s: v)]
    if name in EVERY_VALUE_KIND:
        out.append(("tensor", lambda s: torch.as_tensor(v)))
        out += [(f"dndarray_{s}", (lambda s: lambda _: htt.array(v, split=s))(s)) for s in [None, *range(np.ndim(v))]]
    return out


SET_CASES = [(name, vname, split) for name, a, _, v in SETS for vname, _ in _values(name, v)
             for split in [None, *range(a.ndim)]]


@pytest.mark.parametrize("name,vname,split", SET_CASES)
def test_setitem_matches_reference(name, vname, split):
    _, a, key, v = next(s for s in SETS if s[0] == name)
    port_value = next(b for n, b in _values(name, v) if n == vname)(split)
    ref_value = heat_tpu.array(np.asarray(v)) if vname.startswith("dndarray") else v
    want = heat_tpu.array(a, split=split)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want[key(a)] = ref_value
    got = htt.array(a, split=split)
    got[key(a)] = port_value
    _hold(got, want)


def test_setitem_with_dndarray_keys_and_bool_targets():
    x, r = htt.array(A2, split=1), heat_tpu.array(A2, split=1)
    x[htt.array(A2, split=0) < 0] = 0
    r[heat_tpu.array(A2, split=0) < 0] = 0
    _hold(x, r)
    b, rb = htt.array(A2 > 0, split=0), heat_tpu.array(A2 > 0, split=0)
    b[htt.array([0, 4])] = np.arange(7) % 2 == 0
    rb[heat_tpu.array([0, 4])] = np.arange(7) % 2 == 0
    _hold(b, rb)


# ---------------------------------------------------------------------- #
# fill_diagonal, lloc, aliasing
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("shape", [(9, 7), (7, 9), (3, 5, 4)])
def test_fill_diagonal_matches_reference(shape):
    a = RNG.standard_normal(shape).astype(np.float32)
    for split in [None, *range(len(shape))]:
        for value in (0.0, -2.5):
            got = htt.array(a, split=split).fill_diagonal(value)
            _hold(got, heat_tpu.array(a, split=split).fill_diagonal(value))


def test_lloc_reads_and_writes_the_local_tensor():
    x = htt.array(A2, split=0)
    np.testing.assert_array_equal(x.lloc[2:4].numpy(), A2[2:4])
    x.lloc[0, 1] = 42.0
    assert x.larray[0, 1] == 42.0 and x.numpy()[0, 1] == 42.0
    r = heat_tpu.array(A2, split=0)
    r.lloc[0, 1] = 42.0
    np.testing.assert_array_equal(x.numpy(), r.numpy())


@pytest.mark.parametrize("key", [slice(2, 5), 1, (slice(None), 2), (Ellipsis, slice(None, None, 2)), [1, 2],
                                 slice(None, None, -1)])
@pytest.mark.parametrize("split", [None, 0, 1])
def test_a_result_never_aliases_its_source(key, split):
    """A write to the result leaves the source as it was, and a write to
    the source leaves the result."""
    x = htt.array(A2, split=split)
    y = x[key]
    y[...] = 123.0
    np.testing.assert_array_equal(x.numpy(), A2)
    x[...] = -5.0
    assert (y.numpy() == 123.0).all()


# ---------------------------------------------------------------------- #
# where, nonzero, flatnonzero and the index helpers
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("split", [None, 0, 1])
def test_where_nonzero_flatnonzero_match_reference(split):
    a = np.where(np.isnan(A2), 0.0, A2).astype(np.float32)
    x, r = htt.array(a, split=split), heat_tpu.array(a, split=split)
    _hold(htt.where(x > 0, x, 0), heat_tpu.where(r > 0, r, 0))
    _hold(htt.where(x > 0, 1.0, htt.array(a)), heat_tpu.where(r > 0, 1.0, heat_tpu.array(a)))
    _hold(htt.where(x > 0, x, htt.array(a[0], split=0)), heat_tpu.where(r > 0, r, heat_tpu.array(a[0], split=0)))
    _hold(htt.nonzero(x > 0), heat_tpu.nonzero(r > 0))
    _hold((x > 0).nonzero(), heat_tpu.nonzero(r > 0))
    _hold(htt.where(x > 0), heat_tpu.where(r > 0))
    _hold(htt.flatnonzero(x), heat_tpu.flatnonzero(r))
    _hold(htt.nonzero(htt.array(a[0], split=split and 0)), heat_tpu.nonzero(heat_tpu.array(a[0], split=split and 0)))
    with pytest.raises(TypeError):
        htt.where(x > 0, x)


def test_index_helpers_match_reference():
    for got, want in [
        (htt.triu_indices(4, k=1), heat_tpu.triu_indices(4, k=1)),
        (htt.tril_indices(4, m=6), heat_tpu.tril_indices(4, m=6)),
        (htt.mask_indices(4, np.triu, 1), heat_tpu.mask_indices(4, np.triu, 1)),
    ]:
        for g, w in zip(got, want):
            _hold(g, w)


def test_nonzero_indices_widen_to_int64_past_int32():
    from heat_tpu_torch.core import indexing

    assert indexing._index_dtype(2**31 - 1) is torch.int32
    assert indexing._index_dtype(2**31) is torch.int64
    assert htt.flatnonzero(htt.array([0, 3, 0, 1])).dtype is htt.int32
