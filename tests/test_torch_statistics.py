"""heat_tpu_torch's statistics against heat_tpu at world size 1.

The reference runs on its 8-device CPU mesh; the same numpy inputs (made
from a seed) go through both packages, and each result's global value,
dtype, shape and split are held against the reference's: integer results
and the order-selecting percentile methods (lower, higher, nearest) exactly,
float reductions, ``cov``, ``corrcoef`` and linear percentiles within rtol
1e-5, atol 1e-6, NaN equal.  ``percentile`` of a 1-D split array is also
held against the reference's distributed order statistics path (its
threshold lowered, as ``tests/test_sample_sort.py``'s neighbours do).
"""

import numpy as np
import pytest

import heat_tpu
import heat_tpu_torch as htt

RNG = np.random.default_rng(23)
X = RNG.standard_normal((13, 7)).astype(np.float32)
XN = X.copy()
XN[[1, 4, 9], [2, 2, 5]] = np.nan
XN[:, 6] = np.nan  # an all-NaN column
I = RNG.integers(-20, 20, size=(13, 7)).astype(np.int32)
C = RNG.integers(0, 9, size=40).astype(np.int32)
V = RNG.standard_normal(101).astype(np.float32)
W = RNG.random(7).astype(np.float32)
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def on_cpu():
    prev = htt.get_device()
    htt.use_device("cpu")
    yield
    htt.use_device(prev)


def _flat(r):
    if isinstance(r, (list, tuple)):
        out = []
        for v in r:
            out += _flat(v)
        return out
    return [r]


def hold(got, want, exact=False):
    got, want = _flat(got), _flat(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.dtype.__name__, tuple(g.shape), g.split) == (w.dtype.__name__, tuple(w.shape), w.split)
        gv, wv = g.numpy(), np.asarray(w.numpy())
        if exact or gv.dtype.kind in "iub":
            np.testing.assert_array_equal(gv, wv)
        else:
            np.testing.assert_allclose(gv, wv, equal_nan=True, **TOL)


def both(fn, exact=False):
    hold(fn(htt), fn(heat_tpu), exact)


SPLITS = [None, 0, 1]

REDUCTIONS = {
    "mean": lambda ht, x: ht.mean(x),
    "mean_0": lambda ht, x: ht.mean(x, 0),
    "mean_1": lambda ht, x: x.mean(1),
    "var": lambda ht, x: ht.var(x),
    "var_0_ddof": lambda ht, x: ht.var(x, 0, ddof=1),
    "std_1": lambda ht, x: x.std(1),
    "std_ddof": lambda ht, x: ht.std(x, ddof=1),
    "ptp_0": lambda ht, x: ht.ptp(x, 0),
    "ptp_keep": lambda ht, x: ht.ptp(x, 1, keepdims=True),
    "skew": lambda ht, x: ht.skew(x),
    "skew_0": lambda ht, x: x.skew(0),
    "skew_1_biased": lambda ht, x: ht.skew(x, 1, unbiased=False),
    "kurtosis": lambda ht, x: ht.kurtosis(x),
    "kurtosis_0": lambda ht, x: x.kurtosis(0, Fischer=False),
    "kurtosis_1_biased": lambda ht, x: ht.kurtosis(x, 1, unbiased=False),
    "average": lambda ht, x: ht.average(x),
    "average_w1": lambda ht, x: ht.average(x, 1, weights=ht.array(W)),
    "average_wfull": lambda ht, x: ht.average(x, 0, weights=ht.array(np.abs(X) + 1), returned=True),
    "average_returned": lambda ht, x: x.average(0, returned=True),
    "fmax": lambda ht, x: ht.fmax(x, ht.array(XN)),
    "fmin": lambda ht, x: ht.fmin(ht.array(XN), x),
    "amax": lambda ht, x: ht.amax(x, 0),
}


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("name", list(REDUCTIONS))
def test_moments_match_reference(name, split):
    fn = REDUCTIONS[name]
    both(lambda ht: fn(ht, ht.array(X, split=split)))


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("name", ["nanmean", "nanvar", "nanstd", "nanmax", "nanmin"])
@pytest.mark.parametrize("axis", [None, 0, 1])
def test_nan_reductions_match_reference(name, axis, split):
    both(lambda ht: getattr(ht, name)(ht.array(XN, split=split), axis=axis))


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("axis", [None, 0, 1])
def test_integer_mean_var_are_float32(axis, split):
    both(lambda ht: [ht.mean(ht.array(I, split=split), axis), ht.var(ht.array(I, split=split), axis),
                     ht.std(ht.array(I, split=split), axis)])


ARGS = ["argmax", "argmin", "nanargmax", "nanargmin"]


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("name", ARGS)
@pytest.mark.parametrize("axis", [None, 0, 1])
def test_arg_extrema_match_reference(name, axis, split):
    data = XN[:, :6] if name.startswith("nan") else XN  # the reference's nanarg of an all-NaN slice is undefined
    both(lambda ht: getattr(ht, name)(ht.array(data, split=split), axis=axis), exact=True)


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("axis", [None, 0, 1])
def test_argmax_ties_and_keepdims_match_reference(axis, split):
    both(lambda ht: [ht.array(I, split=split).argmax(axis), ht.array(I, split=split).argmin(axis),
                     ht.argmax(ht.array(X, split=split), axis=axis, keepdims=True)], exact=True)


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("kw", [{}, {"rowvar": False}, {"bias": True}, {"ddof": 0}, {"rowvar": False, "ddof": 3}])
def test_cov_and_corrcoef_match_reference(kw, split):
    both(lambda ht: ht.cov(ht.array(X, split=split), **kw))
    rv = {"rowvar": kw["rowvar"]} if "rowvar" in kw else {}
    both(lambda ht: ht.corrcoef(ht.array(X, split=split), **rv))


@pytest.mark.parametrize("split", [None, 0])
def test_cov_of_two_and_one_variables_match_reference(split):
    both(lambda ht: ht.cov(ht.array(V, split=split), ht.array(V[::-1].copy(), split=split)))
    both(lambda ht: [ht.cov(ht.array(V, split=split)), ht.corrcoef(ht.array(V, split=split))])


@pytest.mark.parametrize("split", [None, 0])
def test_counts_match_reference(split):
    both(lambda ht: [ht.bincount(ht.array(C, split=split)), ht.bincount(ht.array(C, split=split), minlength=15)],
         exact=True)
    both(lambda ht: ht.bincount(ht.array(C, split=split), weights=ht.array(np.linspace(0, 1, 40, dtype=np.float32),
                                                                            split=split)))
    b = np.array([-1.0, 0.0, 0.5, 2.0], np.float32)
    for right in (False, True):
        both(lambda ht: [ht.bucketize(ht.array(X, split=split), ht.array(b), right=right),
                         ht.digitize(ht.array(X, split=split), ht.array(b), right=right),
                         ht.digitize(ht.array(X, split=split), ht.array(b[::-1].copy()), right=right)], exact=True)


@pytest.mark.parametrize("split", [None, 0, 1])
def test_histograms_match_reference(split):
    both(lambda ht: ht.histogram(ht.array(X, split=split)))
    both(lambda ht: ht.histogram(ht.array(X, split=split), bins=5, range=(-1.0, 1.0)))
    both(lambda ht: ht.histogram(ht.array(I, split=split), bins=4))
    if split != 1:  # the reference takes weights of the flattened shape only, so a 1-D array
        both(lambda ht: ht.histogram(ht.array(V, split=split), bins=6, weights=ht.array(np.abs(V), split=split)))
    both(lambda ht: ht.histogram(ht.array(X, split=split), bins=6, density=True))
    both(lambda ht: ht.histogram(ht.array(X, split=split), bins=np.array([-2, -0.5, 0, 3], np.float32)))
    both(lambda ht: ht.histogram_bin_edges(ht.array(X, split=split), bins=7))
    both(lambda ht: [ht.histc(ht.array(X, split=split), bins=9), ht.histc(ht.array(X, split=split), 4, -1, 1)])


@pytest.mark.parametrize("split", [None, 0])
def test_histogram2d_and_dd_match_reference(split):
    s = np.stack([X[:, 0], X[:, 1], X[:, 2]], 1)
    both(lambda ht: ht.histogram2d(ht.array(X[:, 0], split=split), ht.array(X[:, 1], split=split), bins=4))
    both(lambda ht: ht.histogram2d(ht.array(X[:, 0], split=split), ht.array(X[:, 1], split=split), bins=[3, 5],
                                   range=[[-1, 1], [-2, 2]]))
    both(lambda ht: ht.histogramdd(ht.array(s, split=split), bins=3))
    both(lambda ht: ht.histogramdd(ht.array(s, split=split), bins=[2, 3, 4], density=True))


METHODS = ["linear", "lower", "higher", "midpoint", "nearest"]
QS = [37.5, [0, 5.0, 33.3, 50, 99.9, 100]]


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("axis", [None, 0, 1])
def test_percentiles_match_reference(method, axis, split):
    exact = method in ("lower", "higher", "nearest")
    for q in QS:
        both(lambda ht: ht.percentile(ht.array(X, split=split), q, axis=axis, interpolation=method), exact)
        both(lambda ht: ht.quantile(ht.array(X, split=split), np.asarray(q) / 100, axis=axis,
                                    interpolation=method), exact)
    both(lambda ht: ht.percentile(ht.array(X, split=split), QS[1], axis=axis, interpolation=method, keepdims=True),
         exact)
    both(lambda ht: ht.percentile(ht.array(XN, split=split), 30, axis=axis, interpolation=method), exact)


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("axis", [None, 0, 1])
def test_medians_and_nan_percentiles_match_reference(axis, split):
    both(lambda ht: [ht.median(ht.array(X, split=split), axis=axis), ht.array(X, split=split).median(axis)])
    both(lambda ht: [ht.nanmedian(ht.array(XN[:, :6], split=split), axis=axis),
                     ht.nanpercentile(ht.array(XN[:, :6], split=split), [10, 90], axis=axis),
                     ht.nanquantile(ht.array(XN[:, :6], split=split), 0.3, axis=axis, interpolation="lower")])


@pytest.mark.parametrize("method", METHODS)
def test_percentile_matches_the_reference_order_statistics_path(method, monkeypatch):
    """The reference's distributed path (radix-256 selection) for a 1-D
    split float32 array at or above its threshold: linear only there."""
    monkeypatch.setattr(heat_tpu.core.statistics, "PERCENTILE_BISECT_THRESHOLD", 64)
    exact = method in ("lower", "higher", "nearest")
    for q in (QS[0], [1, 25, 75.5]):
        both(lambda ht: ht.percentile(ht.array(V, split=0), q, interpolation=method), exact)
    both(lambda ht: ht.median(ht.array(V, split=0)))


def test_percentile_rejects_a_q_outside_0_100():
    with pytest.raises(ValueError):
        htt.percentile(htt.array(V, split=0), 101.0)
