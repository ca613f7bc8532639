"""heat_tpu_torch's random streams against heat_tpu's.

After ``seed(s)`` the port's uniform family and ``randint`` equal the
reference's bit for bit (each value a function of the seed, the call
counter and the element's flat global index: jax's partitionable
Threefry-2x32), at every split; the normal family is ``sqrt(2) erfinv(u)``
of the same ``u`` and is held within rtol 1e-5, atol 1e-6 (``erfinv``'s
float32 rounding differs).  ``permutation`` and ``randperm`` are jax's
stable-sort shuffle and come out identical too; ``shuffle`` is held by its
property.  The numpy-only helpers (``derive_seed``, ``host_rng``, the
state) are the reference's.
"""

import numpy as np
import pytest
import torch

import heat_tpu
import heat_tpu_torch as htt
from heat_tpu_torch.core import random as prandom


@pytest.fixture(autouse=True)
def on_cpu():
    prev = htt.get_device()
    htt.use_device("cpu")
    yield
    htt.use_device(prev)


def hold(got, want, exact=True):
    assert (got.dtype.__name__, tuple(got.shape), got.split) == (want.dtype.__name__, tuple(want.shape), want.split)
    if exact:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want.numpy()))
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want.numpy()), rtol=1e-5, atol=1e-6)


def both(seed, fn, exact=True):
    htt.random.seed(seed)
    heat_tpu.random.seed(seed)
    for _ in range(2):  # the counter advances alike
        hold(fn(htt), fn(heat_tpu), exact)


SEEDS = [0, 7, 2**33 + 5, 123456789]
UNIFORM = {
    "rand_2d": lambda ht, s: ht.random.rand(13, 5, split=s),
    "rand_3d": lambda ht, s: ht.random.rand(3, 4, 5, split=s),
    "random_sample": lambda ht, s: ht.random.random_sample((9, 4), split=s),
    "random": lambda ht, s: ht.random.random((6, 6), split=s),
    "ranf": lambda ht, s: ht.random.ranf((5, 3), split=s),
    "sample": lambda ht, s: ht.random.sample((4, 7), split=s),
    "uniform": lambda ht, s: ht.random.uniform(-2.5, 3.0, (11, 3), split=s),
    "randint": lambda ht, s: ht.random.randint(0, 100, (12, 5), split=s),
    "randint_wide": lambda ht, s: ht.random.randint(-5, 2**31 - 1, (6, 7), split=s),
    "randint_int8": lambda ht, s: ht.random.randint(-3, 9, (8, 3), dtype=ht.int8, split=s),
    "randint_int16": lambda ht, s: ht.random.randint(0, 2**16, (5, 5), dtype=ht.int16, split=s),
    "random_integer": lambda ht, s: ht.random.random_integer(7, size=(4, 9), split=s),
}


@pytest.mark.parametrize("split", [None, 0, 1])
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", list(UNIFORM))
def test_uniform_family_is_the_reference_bit_for_bit(name, seed, split):
    both(seed, lambda ht: UNIFORM[name](ht, split))


NORMAL = {
    "randn": lambda ht, s: ht.random.randn(13, 5, split=s),
    "standard_normal": lambda ht, s: ht.random.standard_normal((7, 4), split=s),
    "normal": lambda ht, s: ht.random.normal(1.5, 3.0, (9, 6), split=s),
}


@pytest.mark.parametrize("split", [None, 0, 1])
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", list(NORMAL))
def test_normal_family_matches_the_reference(name, seed, split):
    both(seed, lambda ht: NORMAL[name](ht, split), exact=False)


@pytest.mark.parametrize("split", [None, 0])
@pytest.mark.parametrize("n", [1, 20, 5000])
def test_permutation_is_a_permutation_and_the_references(n, split):
    htt.random.seed(11)
    heat_tpu.random.seed(11)
    got = htt.random.permutation(n, split=split)
    want = heat_tpu.random.permutation(n, split=split)
    np.testing.assert_array_equal(np.sort(got.numpy()), np.arange(n))
    hold(got, want)
    hold(htt.random.randperm(n, split=split), heat_tpu.random.randperm(n, split=split))


@pytest.mark.parametrize("split", [None, 0, 1])
def test_permutation_of_an_array_permutes_its_rows(split):
    a = np.arange(24, dtype=np.float32).reshape(8, 3)
    htt.random.seed(4)
    heat_tpu.random.seed(4)
    hold(htt.random.permutation(htt.array(a, split=split)), heat_tpu.random.permutation(heat_tpu.array(a, split=split)))
    got = htt.shuffle(htt.array(a, split=split)).numpy()
    np.testing.assert_array_equal(got[np.argsort(got[:, 0])], a)


def test_chunked_hashing_gives_the_same_stream(monkeypatch):
    htt.random.seed(3)
    whole = htt.random.rand(40, 7, split=1).numpy()
    monkeypatch.setattr(prandom, "_CHUNK", 16)
    htt.random.seed(3)
    np.testing.assert_array_equal(htt.random.rand(40, 7, split=1).numpy(), whole)
    htt.random.seed(3)
    np.testing.assert_array_equal(htt.random.rand(40, 7, split=0).numpy(), whole)


def test_state_and_host_helpers_are_the_references():
    for ht in (htt, heat_tpu):
        ht.random.seed(5)
        ht.random.rand(3)
    assert htt.random.get_state() == heat_tpu.random.get_state() == ("Threefry", 5, 1, 0, 0.0)
    assert htt.random.derive_seed() == heat_tpu.random.derive_seed()
    np.testing.assert_array_equal(htt.random.host_rng(9).random(4), heat_tpu.random.host_rng(9).random(4))
    for ht in (htt, heat_tpu):
        ht.random.set_state(("Batchparallel", 8, 2))
    assert htt.random.get_state() == heat_tpu.random.get_state()
    hold(htt.random.rand(6, 2), heat_tpu.random.rand(6, 2))  # one process: rank 0 folded in, as jax's process 0
    for ht in (htt, heat_tpu):
        ht.random.set_state(("Threefry", 8, 0))
    with pytest.raises(ValueError):
        htt.random.set_state(("Philox", 1, 0))


def test_seed_none_draws_fresh_entropy():
    htt.random.seed(None)
    a = htt.random.get_state()[1]
    htt.random.seed(None)
    assert htt.random.get_state()[1] != a


def test_float64_and_half_draws_keep_their_dtype():
    htt.random.seed(2)
    for dt in (htt.float64, htt.float16, htt.bfloat16):
        u = htt.random.rand(50, dtype=dt)
        assert u.dtype is dt
        v = u.numpy().astype(np.float64)
        assert v.min() >= 0.0 and v.max() < 1.0
        assert htt.random.randn(20, dtype=dt).dtype is dt
    assert htt.random.randint(0, 5, (4,), dtype=htt.int64).dtype is htt.int64
    assert torch.unique(htt.random.randint(0, 5, (400,)).larray).numel() == 5
