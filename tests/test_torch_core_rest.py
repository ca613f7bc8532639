"""The rest of heat_tpu_torch's array core against heat_tpu at world size 1:
``types``' predicates and promotion, ``sanitation``, ``printing``,
``complex_math``, the factories past the first ones, the DNDarray members,
``__partitioned__``/``from_partitioned`` and ``matrixgallery``.

The reference runs on its 8-device CPU mesh with 64-bit types off; the port
keeps a 64-bit type where asked for, so where an operand is 64-bit the
port's promoted type, narrowed to 32 bits, is the reference's.  Values are
exact, but where the two compute in another order (``geomspace``,
``vander``'s powers, the windows: rtol 1e-6); the random gallery matrices
are held by their properties.
"""

import itertools
import warnings

import numpy as np
import pytest
import torch

import heat_tpu
import heat_tpu_torch as htt
from heat_tpu_torch.core import printing, sanitation

TYPES = ["bool", "uint8", "int8", "int16", "int32", "int64", "bfloat16", "float16", "float32", "float64", "complex64",
         "complex128"]
NARROW = {"int64": "int32", "float64": "float32", "complex128": "complex64"}
RNG = np.random.default_rng(17)
A = RNG.standard_normal((9, 7)).astype(np.float32)


@pytest.fixture(autouse=True)
def on_cpu():
    prev = htt.get_device()
    htt.use_device("cpu")
    yield
    htt.use_device(prev)


def _hold(got, want, rtol=0.0):
    assert (got.dtype.__name__, got.shape, got.split) == (want.dtype.__name__, want.shape, want.split)
    if rtol:
        np.testing.assert_allclose(got.numpy(), np.asarray(want.numpy()), rtol=rtol, atol=1e-7)
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want.numpy()))


# ---------------------------------------------------------------------- #
# types
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("a,b", list(itertools.product(TYPES, TYPES)))
def test_type_pairs_match_reference(a, b):
    """result_type, can_cast (three castings) and issubdtype of every pair;
    with a 64-bit operand the port's type narrowed is the reference's."""
    ta, tb, ra, rb = getattr(htt, a), getattr(htt, b), getattr(heat_tpu, a), getattr(heat_tpu, b)
    got, want = htt.result_type(ta, tb).__name__, heat_tpu.result_type(ra, rb).__name__
    assert NARROW.get(got, got) == want
    if a not in NARROW and b not in NARROW:
        assert got == want
    assert got == htt.promote_types(ta, tb).__name__
    for casting in ("safe", "same_kind", "unsafe"):
        assert htt.can_cast(ta, tb, casting) == heat_tpu.can_cast(ra, rb, casting), casting
    assert htt.issubdtype(ta, tb) == heat_tpu.issubdtype(ra, rb)


@pytest.mark.parametrize("name", TYPES)
def test_type_predicates_and_limits_match_reference(name):
    t, r = getattr(htt, name), getattr(heat_tpu, name)
    for fn in ("heat_type_is_exact", "heat_type_is_inexact", "heat_type_is_complexfloating"):
        assert getattr(htt, fn)(t) == getattr(heat_tpu, fn)(r), fn
    for kind in (htt.integer, htt.floating, htt.number, htt.signedinteger):
        assert htt.issubdtype(t, kind) == heat_tpu.issubdtype(r, getattr(heat_tpu, kind.__name__))
    for scalar in (True, 3, 2.5, 1j):
        got, want = htt.result_type(t, scalar).__name__, heat_tpu.result_type(r, scalar).__name__
        assert NARROW.get(got, got) == want, scalar
    if htt.heat_type_is_inexact(t):
        got, want = htt.finfo(t), heat_tpu.finfo(r)
        assert (got.bits, got.eps, got.max, got.min, got.tiny) == (want.bits, want.eps, want.max, want.min, want.tiny)
        with pytest.raises(TypeError):
            htt.iinfo(t)
    elif t is not htt.bool:
        got, want = htt.iinfo(t), heat_tpu.iinfo(r)
        assert (got.bits, got.max, got.min) == (want.bits, want.max, want.min)
        with pytest.raises(TypeError):
            htt.finfo(t)
    kinds = ("bool", "signed integer", "unsigned integer", "integral", "real floating", "complex floating", "numeric",
             ("bool", "complex floating"), htt.float32)
    for kind in kinds:
        got = htt.isdtype(t, kind)
        if name == "bfloat16":  # the reference's numpy has no bfloat16 dtype and raises
            assert got == (kind in ("real floating", "numeric"))
        else:
            assert got == heat_tpu.isdtype(r, kind if kind is not htt.float32 else np.dtype("float32")), kind


def test_result_type_of_scalars_and_arrays_and_iscomplex():
    assert htt.result_type(1, 2.0) is htt.float32 and heat_tpu.result_type(1, 2.0) is heat_tpu.float32
    assert htt.result_type(htt.array([1, 2]), 2.5) is htt.float32
    assert htt.result_type(np.int16, htt.uint8) is htt.int16
    z = np.array([[1 + 2j, 3], [0, -1j]], dtype=np.complex64)
    for split in (None, 0, 1):
        _hold(htt.iscomplex(htt.array(z, split=split)), heat_tpu.iscomplex(heat_tpu.array(z, split=split)))
        _hold(htt.isreal(htt.array(z, split=split)), heat_tpu.isreal(heat_tpu.array(z, split=split)))
        _hold(htt.iscomplex(htt.array(A, split=split)), heat_tpu.iscomplex(heat_tpu.array(A, split=split)))
    with pytest.raises(ValueError):
        htt.can_cast(htt.int8, htt.int16, "bogus")


# ---------------------------------------------------------------------- #
# sanitation
# ---------------------------------------------------------------------- #
def test_sanitation_helpers_match_reference():
    x, r = htt.array(A, split=0), heat_tpu.array(A, split=0)
    for dt in ("int32", "float32", "float16", "int8"):
        assert sanitation.sanitize_infinity(x.astype(getattr(htt, dt))) == heat_tpu.sanitation.sanitize_infinity(
            r.astype(getattr(heat_tpu, dt)))
    assert torch.equal(sanitation.sanitize_in_tensor(x), x.larray)
    assert torch.equal(sanitation.sanitize_in_tensor([1, 2]), torch.tensor([1, 2]))
    sanitation.sanitize_lshape(x, torch.empty(4, 7))
    for bad in (torch.empty(4, 6), torch.empty(4, 7, 1)):
        with pytest.raises(ValueError):
            sanitation.sanitize_lshape(x, bad)
    with pytest.raises(ValueError):
        sanitation.sanitize_lshape(htt.array(A), torch.empty(8, 7))
    with pytest.raises(TypeError):
        sanitation.sanitize_in(A)
    y = sanitation.sanitize_distribution(htt.array(A, split=1), target=x)
    assert y.split == 0 and np.array_equal(y.numpy(), A)
    a, b = sanitation.sanitize_distribution(htt.array(A), htt.array(A, split=0), target=x)
    assert a.split == b.split == 0
    assert sanitation.sanitize_sequence((1, 2)) == [1, 2] and sanitation.sanitize_sequence([3]) == [3]
    rows = sanitation.sanitize_sequence(htt.array(A[:3]))
    assert len(rows) == 3 and np.array_equal(rows[1].numpy(), A[1])
    with pytest.raises(TypeError):
        sanitation.sanitize_sequence(x)
    with pytest.raises(TypeError):
        sanitation.sanitize_sequence(5)
    s = sanitation.scalar_to_1d(htt.array(2.5))
    assert s.shape == (1,) and s.numpy().tolist() == [2.5] and sanitation.scalar_to_1d(x) is x
    with pytest.raises(ValueError):
        sanitation.sanitize_out(htt.zeros((9, 7), split=1), (9, 7), 0, "cpu")


def test_metadata_checks_catch_a_corrupted_array():
    x = htt.array(A, split=0)
    assert sanitation.validate_metadata(x) is x and sanitation.validate_dispatch(x, "t") is x
    assert sanitation.check_placement(x, x.comm, 0) is x and sanitation.check(x) is x
    assert sanitation.assert_cross_rank_consistent(x) is x
    bad = htt.array(A, split=0)
    bad._DNDarray__array = bad.larray[:, :5]
    with pytest.raises(sanitation.MetadataError):
        sanitation.validate_metadata(bad, "here")
    with pytest.raises(sanitation.MetadataError):
        sanitation.assert_cross_rank_consistent(bad)
    wrong = htt.array(A)
    wrong._DNDarray__array = wrong.larray.double()
    with pytest.raises(sanitation.MetadataError):
        sanitation.validate_metadata(wrong)
    with pytest.raises(sanitation.MetadataError):
        sanitation.validate_metadata(A)
    assert sanitation.check(bad) is bad  # off by default
    assert not sanitation.checks_enabled()
    sanitation.enable_checks()
    try:
        assert sanitation.checks_enabled()
        with pytest.raises(sanitation.MetadataError):
            sanitation.check(bad)
        bad._DNDarray__array = bad.larray.contiguous()
        with pytest.raises(sanitation.MetadataError):
            htt.exp(bad)  # the dispatch tail checks its result
        y = htt.array(A, split=0)
        y.resplit_(1)
        assert htt.exp(y).split == 1
    finally:
        sanitation.disable_checks()
    assert not sanitation.checks_enabled() and htt.core._operations._CHECKS is None


# ---------------------------------------------------------------------- #
# printing
# ---------------------------------------------------------------------- #
PRINTED = {
    "small": np.arange(12, dtype=np.float32).reshape(3, 4) / 3,
    "int": np.arange(-5, 7, dtype=np.int32).reshape(4, 3),
    "bool": np.arange(6).reshape(2, 3) % 2 == 0,
    "big": RNG.standard_normal((40, 30)).astype(np.float32),
    "big3d": RNG.standard_normal((12, 9, 11)).astype(np.float32),
    "long": np.arange(2001, dtype=np.int32),
    "scalar": np.float32(3.25),
    "empty": np.zeros((0, 3), np.float32),
}


@pytest.fixture
def print_options():
    yield
    printing.set_printoptions(profile="default")
    heat_tpu.set_printoptions(profile="default")


@pytest.mark.parametrize("options", [{}, {"precision": 2}, {"threshold": 50, "edgeitems": 2}, {"linewidth": 60},
                                     {"profile": "short"}])
@pytest.mark.parametrize("name", list(PRINTED))
def test_str_and_repr_match_reference(name, options, print_options):
    printing.set_printoptions(**options)
    heat_tpu.set_printoptions(**options)
    assert htt.get_printoptions() == heat_tpu.get_printoptions()
    a = PRINTED[name]
    for split in [None, *range(np.ndim(a))]:
        x, r = htt.array(a, split=split), heat_tpu.array(a, split=split)
        assert str(x) == str(r)
        assert repr(x) == repr(r)


def test_a_summarized_array_fetches_only_its_edges(monkeypatch):
    """Past the threshold only (2 * edgeitems + 1) entries an axis leave the
    local tensor; the whole array is never gathered."""
    a = RNG.standard_normal((300, 200)).astype(np.float32)
    for split in (None, 0, 1):
        x = htt.array(a, split=split)
        edges = printing._edges(x)
        assert edges.shape == (7, 7)
        np.testing.assert_array_equal(edges, a[np.ix_(np.r_[0:4, 297:300], np.r_[0:4, 197:200])])
        monkeypatch.setattr(htt.DNDarray, "numpy", lambda self: pytest.fail("the whole array was fetched"))
        assert str(x) == str(heat_tpu.array(a, split=split))
        monkeypatch.undo()


def test_local_printing_and_print0(capsys, print_options):
    x = htt.array(PRINTED["small"], split=0)
    printing.local_printing()
    try:
        assert str(x) == np.array2string(PRINTED["small"], separator=", ", precision=4)
    finally:
        printing.global_printing()
    htt.print0("rank zero")
    assert capsys.readouterr().out == "rank zero\n"


# ---------------------------------------------------------------------- #
# complex_math and the DNDarray members
# ---------------------------------------------------------------------- #
Z = (RNG.standard_normal((6, 5)) + 1j * RNG.standard_normal((6, 5))).astype(np.complex64)


@pytest.mark.parametrize("split", [None, 0, 1])
def test_complex_math_matches_reference(split):
    x, r = htt.array(Z, split=split), heat_tpu.array(Z, split=split)
    for fn in ("real", "imag", "conj", "conjugate"):
        _hold(getattr(htt, fn)(x), getattr(heat_tpu, fn)(r))
    _hold(htt.angle(x), heat_tpu.angle(r), rtol=1e-6)
    _hold(htt.angle(x, deg=True), heat_tpu.angle(r, deg=True), rtol=1e-6)
    _hold(x.real, r.real)
    _hold(x.imag, r.imag)
    _hold(x.conj(), r.conj())
    f, fr = htt.array(A, split=split), heat_tpu.array(A, split=split)
    for fn in ("real", "imag", "conj", "angle"):
        _hold(getattr(htt, fn)(f), getattr(heat_tpu, fn)(fr))
    y = f.real
    y[0, 0] = 99.0
    assert f.numpy()[0, 0] == A[0, 0]  # a copy, never a view


@pytest.mark.parametrize("split", [None, 0, 1])
def test_dndarray_members_match_reference(split):
    x, r = htt.array(A, split=split), heat_tpu.array(A, split=split)
    for name in ("gnumel", "nbytes", "gnbytes", "stride", "strides"):
        assert getattr(x, name) == getattr(r, name), name
    # "local" is this rank's part here (all of it at world size 1), shard 0's on the reference's mesh
    assert (x.lnumel, x.lnbytes) == (A.size, A.nbytes)
    if split is None:
        assert (x.lnumel, x.lnbytes) == (r.lnumel, r.lnbytes)
    np.testing.assert_array_equal(x.lshape_map(), [[9, 7]])
    np.testing.assert_array_equal(x.lshape_map(force_check=True), [[9, 7]])
    c = x.cpu()
    assert c is x and x.to_device("cpu") is x


def test_partitioned_round_trips():
    for a in (A, A[0], np.arange(24, dtype=np.int32).reshape(2, 3, 4)):
        for split in [None, *range(a.ndim)]:
            x = htt.array(a, split=split)
            parts = x.__partitioned__
            assert parts["shape"] == a.shape and parts["locals"] == [(0,) * a.ndim]
            assert parts["partition_tiling"] == (1,) * a.ndim
            only = parts["partitions"][(0,) * a.ndim]
            assert only["start"] == (0,) * a.ndim and only["shape"] == a.shape and only["data"] is x.larray
            y = htt.from_partitioned(x)
            assert y.split is None and y.dtype is x.dtype
            np.testing.assert_array_equal(y.numpy(), a)
    # a protocol object whose partitions all carry data: put together, split
    # along the tiled axis
    pieces = {(0, 0): A[:5], (1, 0): A[5:]}
    obj = type("P", (), {"__partitioned__": {
        "shape": A.shape, "partition_tiling": (2, 1), "locals": [(0, 0)], "get": lambda v: v,
        "partitions": {p: {"start": (0 if p[0] == 0 else 5, 0), "shape": v.shape, "data": v, "location": [0]}
                       for p, v in pieces.items()}}})()
    y = htt.from_partitioned(obj)
    assert y.split == 0
    np.testing.assert_array_equal(y.numpy(), A)


# ---------------------------------------------------------------------- #
# factories
# ---------------------------------------------------------------------- #
FACTORIES = {
    "identity": lambda ht, s: ht.identity(5, split=s),
    "identity_int": lambda ht, s: ht.identity(4, dtype=ht.int32, split=s),
    "geomspace": lambda ht, s: ht.geomspace(1, 1000, 7, split=s and 0),
    "geomspace_open": lambda ht, s: ht.geomspace(2.0, 0.5, 6, endpoint=False, split=s and 0),
    "geomspace_negative": lambda ht, s: ht.geomspace(-1, -64, 7, split=s and 0),
    "tri": lambda ht, s: ht.tri(5, 7, 1, split=s),
    "tri_square": lambda ht, s: ht.tri(6, k=-2, dtype=ht.int32, split=s),
    "vander": lambda ht, s: ht.vander(ht.array(np.array([1.5, 2.0, -1.0, 0.5], np.float32), split=s and 0)),
    "vander_int": lambda ht, s: ht.vander(ht.array(np.array([1, 2, 3], np.int32), split=s and 0), 5, increasing=True),
    "vander_list": lambda ht, s: ht.vander([2, 3], 3),
    "indices": lambda ht, s: ht.indices((2, 3)),
    "indices_sparse": lambda ht, s: list(ht.indices((2, 3, 4), sparse=True)),
    "ix_": lambda ht, s: list(ht.ix_([1, 0, 2], np.array([3, 1]))),
    "diag_indices": lambda ht, s: list(ht.diag_indices(4, 3)),
    "diag_indices_from": lambda ht, s: list(ht.diag_indices_from(ht.zeros((3, 3), split=s))),
    "tril_indices_from": lambda ht, s: list(ht.tril_indices_from(ht.zeros((4, 5), split=s), k=1)),
    "triu_indices_from": lambda ht, s: list(ht.triu_indices_from(ht.zeros((4, 5), split=s), k=-1)),
    "unravel_index": lambda ht, s: list(ht.unravel_index(ht.array(np.array([5, 7, 0, 11], np.int32), split=s and 0),
                                                         (3, 4))),
    "unravel_index_list": lambda ht, s: list(ht.unravel_index([22, 41, 37], (7, 6))),
    "ravel_multi_index": lambda ht, s: ht.ravel_multi_index(
        (ht.array(np.array([1, 2, 0], np.int32), split=s and 0), ht.array(np.array([0, 3, 3], np.int32), split=s and 0)),
        (3, 4)),
    "ravel_multi_index_order_f": lambda ht, s: ht.ravel_multi_index(([1, 2], [0, 3]), (3, 4), order="F"),
    "ravel_multi_index_clip": lambda ht, s: ht.ravel_multi_index(([1, 5], [-1, 3]), (3, 4), mode="clip"),
    "ravel_multi_index_wrap": lambda ht, s: ht.ravel_multi_index(([1, 5], [-1, 3]), (3, 4), mode="wrap"),
    "bartlett": lambda ht, s: ht.bartlett(9),
    "blackman": lambda ht, s: ht.blackman(8),
    "hamming": lambda ht, s: ht.hamming(9),
    "hanning": lambda ht, s: ht.hanning(10),
    "kaiser": lambda ht, s: ht.kaiser(9, 4.5),
    "window_of_one": lambda ht, s: [ht.bartlett(1), ht.hanning(1), ht.kaiser(1, 2.0)],
}
ROUNDED = ("geomspace", "vander", "bartlett", "blackman", "hamming", "hanning", "kaiser", "window")


@pytest.mark.parametrize("split", [None, 0, 1])
@pytest.mark.parametrize("name", list(FACTORIES))
def test_factories_match_reference(name, split):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = FACTORIES[name](heat_tpu, split)
    got = FACTORIES[name](htt, split)
    rtol = 1e-6 if name.startswith(ROUNDED) else 0.0
    if isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _hold(g, w, rtol)
    else:
        _hold(got, want, rtol)


def test_factories_refuse_what_the_reference_refuses():
    with pytest.raises(ValueError):
        htt.ravel_multi_index(([1, 3], [0, 0]), (3, 4))
    with pytest.raises(ValueError):
        htt.diag_indices_from(htt.zeros((3, 4)))
    with pytest.raises(ValueError):
        htt.tril_indices_from(htt.zeros(3))
    with pytest.raises(ValueError):
        htt.vander(htt.zeros((2, 2)))
    with pytest.raises(ValueError):
        htt.geomspace(0, 10)


# ---------------------------------------------------------------------- #
# matrixgallery
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("split", [None, 0, 1])
def test_matrixgallery_by_its_properties(split):
    from heat_tpu_torch.utils.data import matrixgallery as mg

    _hold(mg.parter(9, split=split), heat_tpu.utils.data.matrixgallery.parter(9, split=split))
    s = np.linalg.svd(mg.parter(64).numpy().astype(np.float64), compute_uv=False)
    assert np.abs(s[:40] - np.pi).max() < 1e-3  # the Parter matrix's singular values cluster at pi
    h = mg.hermitian(12, split=split).numpy()
    assert h.dtype == np.complex64 and h.shape == (12, 12) and np.allclose(h, h.conj().T, atol=1e-6)
    pd = mg.hermitian(12, split=split, positive_definite=True, dtype=htt.float32).numpy()
    assert np.allclose(pd, pd.T) and np.linalg.eigvalsh(pd.astype(np.float64)).min() > 0
    sv = np.array([5.0, 2.0, 0.5], np.float32)
    a, (u, s_, v) = mg.random_known_singularvalues(40, 12, sv, split=split)
    assert a.split == split and a.shape == (40, 12) and a.dtype is htt.float32
    np.testing.assert_allclose(np.linalg.svd(a.numpy().astype(np.float64), compute_uv=False)[:3], sv, rtol=1e-5)
    np.testing.assert_allclose(u.numpy().T @ u.numpy(), np.eye(3), atol=1e-5)
    np.testing.assert_allclose(a.numpy(), (u.numpy() * s_.numpy()) @ v.numpy().T, atol=1e-5)
    r, _ = mg.random_known_rank(30, 20, 4, split=split)
    assert np.linalg.matrix_rank(r.numpy().astype(np.float64), tol=1e-4) == 4
