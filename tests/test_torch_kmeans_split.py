"""The split-TF32 products of the KMeans kernels (``csrc/kmeans.cu``),
emulated on the CPU and held to chip_smoke.py's tolerances.

The kernels take x.c on the tensor cores, whose TF32 operands keep 10
mantissa bits.  Each of x and c is split into two TF32 parts, hi = tf32(v)
and lo = tf32(v - hi), rounded as the kernels round them (to nearest, ties
away from zero, by integer ops on the float32 bits), and x.c is taken as
x_lo.c_hi + x_hi.c_lo + x_hi.c_hi, a k-step of 8 columns at a time into a
float32 accumulator; bfloat16 rows are exact in TF32, so x_lo = 0 and two
products remain.  The emulation forms each k-step's 8 products exactly
(float64) and rounds the accumulator once a product, to nearest or, as a
worse case than the tensor cores', toward zero.  Against the plain version
(full float32) d2 must stay within D2_RTOL of |x|^2 + |c|^2 and a label may
differ only at a near tie within TIE_RTOL of |x|^2 (compare_assign, as the
card's checks hold the kernels); a single TF32 product breaks D2_RTOL,
which is why the kernels split."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from heat_tpu_torch.ops import kmeans_kernels as kk

REPO = Path(__file__).resolve().parents[1]
PRODUCTS = {"float32": ("lo_hi", "hi_lo", "hi_hi"), "bfloat16": ("hi_lo", "hi_hi"), "one": ("hi_hi",)}


@pytest.fixture(scope="module")
def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def tf32(v: torch.Tensor) -> torch.Tensor:
    """float32 v rounded to TF32 as the kernels' to_tf32 does: (bits + 0x1000) & ~0x1fff."""
    return ((v.contiguous().view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def split(v: torch.Tensor):
    hi = tf32(v)
    return hi, tf32(v - hi)


def _toward_zero(exact: torch.Tensor) -> torch.Tensor:
    r = exact.float()
    return torch.where(r.double().abs() > exact.abs(), torch.nextafter(r, torch.zeros_like(r)), r)


def split_dots(x: torch.Tensor, c: torch.Tensor, products, rounding: str = "nearest") -> torch.Tensor:
    """x.c (n, k) by the kernels' split-TF32 products, in their order."""
    (xh, xl), (ch, cl) = split(x.float()), split(c)
    parts = {"lo_hi": (xl, ch), "hi_lo": (xh, cl), "hi_hi": (xh, ch)}
    acc = torch.zeros(x.shape[0], c.shape[0])
    for s in range(0, x.shape[1], 8):
        for name in products:
            a, b = parts[name]
            exact = acc.double() + a[:, s : s + 8].double() @ b[:, s : s + 8].double().T
            acc = exact.float() if rounding == "nearest" else _toward_zero(exact)
    return acc


def emulated_assign(x, c, products, rounding="nearest", pad=0):
    """(labels, d2) with x.c by split_dots: d2 = (|x|^2 + |c|^2) - 2 x.c
    clamped at 0, then the lowest-index argmin.  ``pad`` zero centres follow
    the k real ones with |c|^2 = +inf, as the kernels pad to whole tiles."""
    if pad:
        c = torch.cat([c, torch.zeros(pad, c.shape[1])])
    xf = x.float()
    cc = (c * c).sum(1)
    if pad:
        cc[-pad:] = float("inf")
    d2 = ((xf * xf).sum(1, keepdim=True) + cc[None]) - 2.0 * split_dots(x, c, products, rounding)
    d2 = d2.clamp_min(0.0)
    lab = d2.argmin(1)
    return lab.int(), d2.gather(1, lab[:, None])[:, 0]


def _blobs(d: int, data: str, seed: int):
    """4000 rows around 64 centres: chip_smoke's edge data (sd 0.7 around
    centres of sd 4), or the main path's (sd 1 around means uniform in
    [-20, 20], as create_clusters makes them)."""
    rng = np.random.default_rng(seed)
    if data == "edge":
        c = (4.0 * rng.standard_normal((64, d))).astype(np.float32)
        x = c[rng.integers(0, 64, 4000)] + 0.7 * rng.standard_normal((4000, d))
    else:
        c = (rng.random((64, d)) * 40.0 - 20.0).astype(np.float32)
        x = c[rng.integers(0, 64, 4000)] + rng.standard_normal((4000, d))
        c = c + 0.5 * rng.standard_normal((64, d)).astype(np.float32)  # centres of a fit, not the means
    return torch.from_numpy(x.astype(np.float32)), torch.from_numpy(c)


def _d2_err(x, c, d2, lab_p, d2_p) -> float:
    xx = x.float().square().sum(1)
    return float(((d2 - d2_p).abs() / (xx + (c * c).sum(1)[lab_p.long()])).max())


@pytest.mark.parametrize("scale", [1e-30, 1e-3, 1.0, 37.0, 1e30])
def test_tf32_rounds_to_nearest_ties_away_from_zero(scale):
    """The kernels' integer rounding is round-to-nearest to 11 significant
    bits, ties away from zero, on random values and on exact ties."""
    rng = np.random.default_rng(1)
    v = torch.from_numpy((rng.standard_normal(20000) * scale).astype(np.float32))
    m, e = torch.frexp(v.double())  # v = m 2^e, 0.5 <= |m| < 1
    scaled = m * 2.0**11
    want = (torch.sign(scaled) * torch.floor(scaled.abs() + 0.5)) * torch.pow(2.0, (e - 11).double())
    assert torch.equal(tf32(v).double(), want)
    # halfway between neighbouring TF32 values of [1, 2)
    ties = 1.0 + (torch.arange(0, 200, dtype=torch.float64) + 0.5) * 2.0**-10
    t = ties.float()
    assert torch.equal(tf32(t).double(), torch.floor(ties * 2.0**10 + 0.5) * 2.0**-10)
    assert torch.equal(tf32(-t), -tf32(t))


def test_split_parts_are_tf32_and_sum_to_x():
    """hi and lo keep 10 mantissa bits (the low 13 are zero) and hi + lo is x
    to 2^-22 of |x|."""
    v = torch.from_numpy(np.random.default_rng(2).standard_normal(50000).astype(np.float32) * 10.0)
    hi, lo = split(v)
    for part in (hi, lo):
        assert not bool((part.view(torch.int32) & 0x1FFF).any())
    assert bool(((v.double() - hi.double() - lo.double()).abs() <= 2.0**-22 * v.double().abs()).all())
    assert bool((lo.abs() <= 2.0**-11 * v.abs()).all())


@pytest.mark.parametrize("d", [32, 128])
@pytest.mark.parametrize("rounding", ["nearest", "toward_zero"])
@pytest.mark.parametrize("data", ["edge", "main"])
def test_three_products_keep_the_chip_tolerances(chip_smoke, d, rounding, data):
    """float32 rows: three products hold d2 within D2_RTOL (with room: under
    a quarter of it) and move labels only at near ties (compare_assign)."""
    x, c = _blobs(d, data, seed=d)
    lab_p, d2_p = kk._torch_assign(x, c)
    lab, d2 = emulated_assign(x, c, PRODUCTS["float32"], rounding)
    chip_smoke.compare_assign(x, c, lab, d2, lab_p, d2_p)  # raises past D2_RTOL or TIE_RTOL
    assert _d2_err(x, c, d2, lab_p, d2_p) < chip_smoke.D2_RTOL / 4


@pytest.mark.parametrize("d", [32, 128])
def test_bfloat16_rows_take_two_products(chip_smoke, d):
    """bfloat16 rows are exact in TF32: x_lo is 0, so the product x_lo.c_hi
    adds nothing and two products give the three's bits."""
    x, c = _blobs(d, "main", seed=d + 1)
    xb = x.to(torch.bfloat16)
    hi, lo = split(xb.float())
    assert torch.equal(hi, xb.float()) and not bool(lo.any())
    assert torch.equal(split_dots(xb, c, PRODUCTS["bfloat16"]), split_dots(xb, c, PRODUCTS["float32"]))
    lab_p, d2_p = kk._torch_assign(xb, c)
    lab, d2 = emulated_assign(xb, c, PRODUCTS["bfloat16"], "toward_zero")
    chip_smoke.compare_assign(xb, c, lab, d2, lab_p, d2_p)


@pytest.mark.parametrize("d", [32, 128])
def test_near_equidistant_rows_move_only_near_ties(chip_smoke, d):
    """Rows halfway between two centres, moved by 1e-6 of the centres'
    distance: most are near ties (the plain top-2 gap within TIE_RTOL of
    |x|^2), and the split products move a label only there."""
    rng = np.random.default_rng(d + 2)
    c = torch.from_numpy((4.0 * rng.standard_normal((64, d))).astype(np.float32))
    a, b = rng.integers(0, 64, 3000), rng.integers(0, 64, 3000)
    b = np.where(a == b, (b + 1) % 64, b)
    mid = 0.5 * (c[a] + c[b])
    x = (mid + 1e-6 * (c[a] - c[b]) * torch.from_numpy(rng.standard_normal((3000, 1)).astype(np.float32))).float()
    dd = torch.cat([db for _, _, db, _ in kk.sq_dist_blocks(x, c)])
    top2 = dd.topk(2, dim=1, largest=False).values
    near = (top2[:, 1] - top2[:, 0]) <= chip_smoke.TIE_RTOL * x.square().sum(1)
    assert float(near.float().mean()) > 0.5
    lab_p, d2_p = kk._torch_assign(x, c)
    for rounding in ("nearest", "toward_zero"):
        lab, d2 = emulated_assign(x, c, PRODUCTS["float32"], rounding)
        chip_smoke.compare_assign(x, c, lab, d2, lab_p, d2_p)


@pytest.mark.parametrize("d", [32, 128])
@pytest.mark.parametrize("data", ["edge", "main"])
def test_one_tf32_product_breaks_d2_rtol(chip_smoke, d, data):
    """A single TF32 product (x_hi.c_hi) misses d2 by ~3e-4 of |x|^2 + |c|^2,
    past D2_RTOL: the reason for the split."""
    x, c = _blobs(d, data, seed=d)
    lab_p, d2_p = kk._torch_assign(x, c)
    lab, d2 = emulated_assign(x, c, PRODUCTS["one"])
    assert _d2_err(x, c, d2, lab_p, d2_p) > 10 * chip_smoke.D2_RTOL
    with pytest.raises(RuntimeError, match="d2 row"):
        chip_smoke.compare_assign(x, c, lab, d2, lab_p, d2_p)


@pytest.mark.parametrize("k", [1, 3, 61])
def test_a_pad_centre_never_wins(k):
    """Centres padded to a whole n8 tile with zeros: at |c|^2 = +inf (the
    kernels' pad) no row takes a pad, and the labels and d2 are those of the
    k real centres; with |c|^2 = 0 a zero centre would win the rows near
    the origin (100 of them here)."""
    x, c = _blobs(32, "edge", seed=k)
    c = c[:k].contiguous()
    x = torch.cat([x, 0.1 * torch.from_numpy(np.random.default_rng(k).standard_normal((100, 32)).astype(np.float32))])
    pad = (-k) % 8 or 8
    lab, d2 = emulated_assign(x, c, PRODUCTS["float32"])
    lab_pad, d2_pad = emulated_assign(x, c, PRODUCTS["float32"], pad=pad)
    assert int(lab_pad.max()) < k
    assert torch.equal(lab, lab_pad) and torch.equal(d2, d2_pad)
    near_origin = x.square().sum(1) < d2
    assert bool(near_origin.any())  # rows a zero centre would take
