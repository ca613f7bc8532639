"""The port's bucket planner and stage math against heat_tpu's ``core.collectives``, on the CPU.

Pure functions, held exactly: the bucket plan field for field over a
hypothesis sweep of leaf sizes and budgets, the budget parser, the
hierarchical stage factors (which telescope to the flat ring's 2(p-1)/p)
and groups, the byte telescope, the domain count.  The executors at world
size 1 are the identity; over 4 ranks they are held in
``tests/test_torch_data_parallel_mp.py``.
"""

import math

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from heat_tpu.core import collectives as ref
from heat_tpu.core import redistribution as ref_redistribution

from heat_tpu_torch.core import collectives as port
from heat_tpu_torch.core.communication import Communication

BUDGETS = st.one_of(st.none(), st.just(0), st.sampled_from(["4K", "1K", "0.5K", "64", "2M", "", "-5"]),
                    st.integers(min_value=-3, max_value=20_000))


@settings(max_examples=300, deadline=None)
@given(sizes=st.lists(st.integers(min_value=0, max_value=9_000), max_size=24), budget=BUDGETS)
def test_plan_matches_reference_field_for_field(sizes, budget):
    got, want = port.plan_grad_buckets(sizes, budget), ref.plan_grad_buckets(sizes, budget)
    for field in ("leaf_nbytes", "budget", "buckets", "total_bytes", "reason", "n_buckets", "max_bucket_bytes"):
        assert getattr(got, field) == getattr(want, field), field
    assert [got.bucket_nbytes(k) for k in range(got.n_buckets)] == [want.bucket_nbytes(k)
                                                                     for k in range(want.n_buckets)]
    assert sorted(j for b in got.buckets for j in b) == list(range(len(sizes)))


@pytest.mark.parametrize("default", [None, "3K", 1000])
def test_plan_takes_the_process_default_budget(default):
    prev_port, prev_ref = port.set_grad_bucket_budget(default), ref.set_grad_bucket_budget(default)
    try:
        assert port.get_grad_bucket_budget() == ref.get_grad_bucket_budget()
        sizes = [700, 1200, 300, 2500, 40, 900]
        assert port.plan_grad_buckets(sizes).buckets == ref.plan_grad_buckets(sizes).buckets
        assert port.plan_grad_buckets(sizes, 0).buckets == ((0, 1, 2, 3, 4, 5),)  # 0 forces one bucket
    finally:
        port.set_grad_bucket_budget(prev_port)
        ref.set_grad_bucket_budget(prev_ref)


@pytest.mark.parametrize("text", [None, 0, -1, "", "  ", "64", "4K", "4KB", "0.5G", "1.5M", "2g", 12345, "7b"])
def test_parse_budget_matches_reference(text):
    assert port.parse_budget(text) == ref_redistribution.parse_budget(text)


@pytest.mark.parametrize("p", [1, 2, 3, 4, 6, 8, 12, 16, 64])
def test_stage_factors_telescope_to_the_flat_ring(p):
    for d in range(1, p + 1):
        got, want = port._hier_stage_factors(p, d), ref._hier_stage_factors(p, d)
        assert got == want
        if got is not None:
            assert math.isclose(sum(got), 2.0 * (p - 1) / p, rel_tol=1e-12)
            assert port._hier_groups(p, d) == ref._hier_groups(p, d)
            intra, inter = port._hier_groups(p, d)
            assert sorted(r for g in intra for r in g) == list(range(p))
            assert sorted(r for g in inter for r in g) == list(range(p))
        if p % d == 0:
            assert port._daso_stage_factors(d, p // d) == ref._daso_stage_factors(d, p // d)


@settings(max_examples=100, deadline=None)
@given(parts=st.lists(st.floats(min_value=0, max_value=1e6, allow_nan=False), min_size=1, max_size=20))
def test_telescope_sums_to_the_rounded_total(parts):
    tele = port._Telescope()
    assert sum(tele.wire(x) for x in parts) == int(round(sum(parts)))


class _FakeComm:
    def __init__(self, size):
        self.size = size


@pytest.mark.parametrize("p,local,domains,want", [(8, None, None, 1), (8, "4", None, 2), (8, "8", None, 1),
                                                  (8, "3", None, 1), (8, "1", None, 1), (8, None, 4, 4),
                                                  (8, "2", 2, 2), (6, None, 4, 1), (4, None, 4, 1)])
def test_domains_are_one_a_host(monkeypatch, p, local, domains, want):
    if local is None:
        monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    else:
        monkeypatch.setenv("LOCAL_WORLD_SIZE", local)
    assert port._derive_domains(_FakeComm(p), domains) == want


def test_executors_at_world_size_one_are_the_identity():
    comm = Communication()
    rng = np.random.default_rng(0)
    tensors = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for s in ((3, 4), (5,))]
    before = [t.clone() for t in tensors]
    assert port.bucketed_grad_allreduce(comm, tensors, budget=16) == tensors
    assert all(torch.equal(a, b) for a, b in zip(tensors, before))
    port.bucketed_grad_allreduce(comm, tensors, scale=0.5)
    assert all(torch.equal(a, b * 0.5) for a, b in zip(tensors, before))
    assert port.bucketed_param_sync(comm, tensors, 0.5) == tensors
    assert port.dispatch_all_bucket_averages(comm, tensors) is None
    assert comm.traffic() == {}
    sub = comm.Split(0)
    assert sub.size == 1 and sub.rank == 0 and sub.ranks == (0,)
    req = comm.Iallreduce(tensors[0])
    assert req.wait() is tensors[0] and comm.Wait(comm.Iallgather(tensors[1])).shape == (5,)
    assert torch.equal(comm.Ireduce_scatter(tensors[1]).wait(), tensors[1])
    with pytest.raises(ValueError):
        port.bucketed_grad_allreduce(_MultiRank(), tensors, op="max")


class _MultiRank(Communication):
    """A communicator that claims two ranks, to reach the argument checks."""

    def __init__(self):
        super().__init__()

    @property
    def size(self):
        return 2

    def is_distributed(self):
        return True


@pytest.mark.parametrize("local", [None, "2", "3"])
def test_daso_group_size_is_a_host_else_the_reference_default(monkeypatch, local):
    from heat_tpu.optim.dp_optimizer import DASO as RefDASO

    if local is None:
        monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    else:
        monkeypatch.setenv("LOCAL_WORLD_SIZE", local)
    for p in range(1, 41):
        want = int(local) if local is not None and p % int(local) == 0 else RefDASO._default_ici(p)
        assert port._daso_group_size(p) == want
        assert port._derive_domains(_FakeComm(p)) == (p // int(local) if want == int(local or 0) and p // want > 1
                                                      else 1)
