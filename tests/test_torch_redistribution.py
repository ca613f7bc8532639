"""heat_tpu_torch's tiled resplit planner (``core/redistribution.py``) and
the ``memory_budget`` argument, against heat_tpu.

The planner is pure shard arithmetic, copied: over a grid of shapes,
splits, world sizes and budgets the port's :func:`plan_resplit` must equal
the reference's field for field, ``reason`` included.  ``parse_budget``
and the process default are held the same way.  ``memory_budget=`` is
accepted by ``DNDarray.resplit_``, ``DNDarray.resplit`` and
``ht.resplit`` (it raised ``TypeError`` before), exactly the budget-less
result at world size 1, where a resplit moves nothing.  The multi-rank
executor is held bit for bit against the monolithic resplit on 3 gloo
ranks in ``tests/test_torch_estimators_mp.py``.
"""

import dataclasses
import itertools

import numpy as np
import pytest

import heat_tpu
import heat_tpu_torch as htt
from heat_tpu.core import redistribution as ref
from heat_tpu_torch.core import redistribution as port

SHAPES = [(64,), (16, 8), (6, 9, 37), (8, 8, 8), (12, 5, 7, 3), (1, 40), (3, 1, 1000)]
BUDGETS = [None, 0, 1, 100, "400", 4096, "4K", "64M", 10**9]


@pytest.fixture(autouse=True)
def on_cpu():
    prev = htt.get_device()
    htt.use_device("cpu")
    yield
    htt.use_device(prev)


def _grid():
    for shape in SHAPES:
        splits = [None, *range(len(shape))]
        for src, dst, size in itertools.product(splits, splits, (1, 2, 3, 4, 8)):
            for budget in BUDGETS:
                yield shape, src, dst, size, budget


GRID = list(_grid())


@pytest.mark.parametrize("itemsize", [1, 4, 8])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plan_resplit_is_the_references(shape, itemsize):
    n = 0
    for sh, src, dst, size, budget in GRID:
        if sh != shape:
            continue
        got = port.plan_resplit(sh, itemsize, src, dst, size, budget)
        want = ref.plan_resplit(sh, itemsize, src, dst, size, budget)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), (sh, src, dst, size, budget)
        if got.tile_axis is not None:
            for i in range(got.n_tiles):
                assert got.tile_bounds(i) == want.tile_bounds(i)
                assert got.tile_nbytes(got.tile_bounds(i)[1]) == want.tile_nbytes(want.tile_bounds(i)[1])
            assert got.max_tile_bytes == want.max_tile_bytes
        n += 1
    assert n > 0


def test_the_grid_reaches_every_reason():
    reasons = {port.plan_resplit(sh, 4, src, dst, size, b).reason for sh, src, dst, size, b in GRID}
    assert reasons == {"no-budget", "too-few-dims", "fits-in-budget", "ragged-src", "ragged-dst", "no-free-axis",
                       "tiled", "tiled-floor-one-slice"}


@pytest.mark.parametrize("text", [None, 0, -3, "", 4096, "512", "4K", "64M", "2GB", "0.5G", "1.5M", " 8k ", 7.9])
def test_parse_budget_is_the_references(text):
    assert port.parse_budget(text) == ref.parse_budget(text)


def test_collectives_take_the_same_parse_budget():
    from heat_tpu_torch.core import collectives

    assert collectives.parse_budget is port.parse_budget


def test_set_and_get_redistribution_budget():
    assert htt.set_redistribution_budget is port.set_redistribution_budget
    assert htt.get_redistribution_budget is port.get_redistribution_budget
    prev = htt.set_redistribution_budget("64M")
    try:
        assert htt.get_redistribution_budget() == 64 * 2**20
        assert htt.set_redistribution_budget(0) == 64 * 2**20
        assert htt.get_redistribution_budget() is None
        htt.set_redistribution_budget(4096)
        hprev = heat_tpu.set_redistribution_budget(4096)
        try:
            assert htt.get_redistribution_budget() == heat_tpu.get_redistribution_budget()
        finally:
            heat_tpu.set_redistribution_budget(hprev)
    finally:
        htt.set_redistribution_budget(prev)
    assert htt.get_redistribution_budget() == prev


def test_make_plan_takes_the_default_and_moves_nothing_alone():
    comm = htt.get_comm()
    assert port.make_plan(comm, (6, 9, 37), 4, 0, 1, "400") is None  # world size 1 moves nothing
    prev = htt.set_redistribution_budget(None)
    try:
        assert port.make_plan(comm, (6, 9, 37), 4, 0, 1, None) is None
    finally:
        htt.set_redistribution_budget(prev)


@pytest.mark.parametrize("budget", [None, 0, 400, "64M"])
@pytest.mark.parametrize("src,dst", [(0, 1), (0, None), (None, 0), (1, 2), (2, None)])
def test_memory_budget_is_accepted_by_every_entry_point(src, dst, budget):
    a = np.random.default_rng(3).standard_normal((6, 9, 37)).astype(np.float32)
    want = heat_tpu.resplit(heat_tpu.array(a, split=src), dst, memory_budget=budget)
    x = htt.array(a, split=src)
    copy = x.resplit(dst, memory_budget=budget)
    func = htt.resplit(x, dst, memory_budget=budget)
    inplace = htt.array(a, split=src).resplit_(dst, memory_budget=budget)
    for got in (copy, func, inplace):
        assert got.split == want.split
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert x.split == src  # the copies leave their source as it was
