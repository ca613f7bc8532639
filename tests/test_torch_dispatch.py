"""heat_tpu_torch's op dispatch core, DNDarray distribution methods, the
rest of the factories, ``memory`` and ``stride_tricks`` against heat_tpu.

The dispatch core (``_local_op``, ``_binary_op``, ``_reduce_op``,
``_cum_op``) over the split grid (None, 0, 1) on one op of each kind (add,
exp, sum, cumsum), ``out=`` and ``where=``; ``resplit_``/``resplit``, ``T``,
``item`` and the scalar conversions, ``astype(copy=False)``; ``eye``,
``linspace``, ``logspace``, ``meshgrid`` and the ``*_like`` factories; all at
world size 1 on the CPU, on the same numpy inputs as the reference on its
8-device CPU mesh: global value, dtype, shape and split (integer and data
movement exactly, float32 rtol 1e-5, atol 1e-6).  The communicator's new
collectives at world size 1 are the identity and count no traffic.
"""

import warnings

import numpy as np
import pytest
import torch

import heat_tpu
import heat_tpu_torch as htt
from test_torch_ops import both, same

RNG = np.random.default_rng(6)
X = RNG.standard_normal((13, 7)).astype(np.float32)
Y = RNG.standard_normal((13, 7)).astype(np.float32)
ROW = RNG.standard_normal(7).astype(np.float32)
I = RNG.integers(-9, 10, (13, 7)).astype(np.int32)


@pytest.fixture(autouse=True)
def on_cpu():
    prev = htt.get_device()
    htt.use_device("cpu")
    yield
    htt.use_device(prev)


def pair(data, split):
    return htt.array(data, split=split), heat_tpu.array(data, split=split)


@pytest.mark.parametrize("s2", [None, 0, 1])
@pytest.mark.parametrize("s1", [None, 0, 1])
def test_binary_op_over_the_split_grid(s1, s2):
    """Mismatched splits resplit the second operand, with the reference's
    warning, and only then."""
    (a, ra), (b, rb) = pair(X, s1), pair(Y, s2)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = htt.add(a, b)
    warned = any("mismatched splits" in str(w.message) for w in caught)
    assert warned == (None not in (s1, s2) and s1 != s2)
    same(got, heat_tpu.add(ra, rb))
    row, rrow = pair(ROW, s2 if s2 != 1 else 0)
    same(htt.add(a, row), heat_tpu.add(ra, rrow))
    same(htt.add(row, a), heat_tpu.add(rrow, ra))


@pytest.mark.parametrize("split", [None, 0, 1])
def test_local_reduce_and_cum_ops_over_the_split_grid(split):
    (a, ra), (i, ri) = pair(X, split), pair(I, split)
    same(htt.exp(a), heat_tpu.exp(ra))
    for axis in (None, 0, 1, (0, 1)):
        for keepdims in (False, True):
            same(htt.sum(a, axis=axis, keepdims=keepdims), heat_tpu.sum(ra, axis=axis, keepdims=keepdims))
    same(htt.sum(i, axis=0, dtype=htt.float32), heat_tpu.sum(ri, axis=0, dtype=heat_tpu.float32))
    for axis in (None, 0, 1):
        same(htt.cumsum(a, axis), heat_tpu.cumsum(ra, axis))
        same(htt.cumsum(i, axis), heat_tpu.cumsum(ri, axis))
    same(htt.cumsum(a, 0, dtype=htt.float64).astype(htt.float32), heat_tpu.cumsum(ra, 0))


@pytest.mark.parametrize("split", [None, 0, 1])
def test_out_and_where_match_reference(split):
    (a, ra), (b, rb) = pair(X, split), pair(Y, split)
    mask, rmask = pair(X > Y, split)
    out, rout = pair(np.full((13, 7), 5.0, np.float32), split)
    same(htt.add(a, b, out=out, where=mask), heat_tpu.add(ra, rb, out=rout, where=rmask))
    same(htt.mul(a, b, where=mask), heat_tpu.mul(ra, rb, where=rmask))
    out, rout = pair(np.zeros(7, np.float32), None)
    same(htt.sum(a, axis=0, out=out), heat_tpu.sum(ra, axis=0, out=rout))
    out, rout = pair(np.zeros((13, 7), np.float32), split)
    same(htt.cumsum(a, 1, out=out), heat_tpu.cumsum(ra, 1, out=rout))
    with pytest.raises(ValueError):
        htt.add(a, b, out=htt.zeros((3, 3)))


def test_resplit_and_conversions_match_reference():
    for src in (None, 0, 1):
        for dst in (None, 0, 1):
            a, ra = pair(X, src)
            copy = a.resplit(dst)
            same(copy, ra.resplit(dst))
            assert copy.larray.data_ptr() != a.larray.data_ptr() and a.split == src
            assert a.resplit_(dst) is a
            same(a, ra.resplit_(dst))
    a, ra = pair(X, 0)
    same(a.T, ra.T)
    one, rone = pair(np.array([[2.5]], np.float32), 0)
    assert (one.item(), float(one), int(one), bool(one)) == (rone.item(), float(rone), int(rone), bool(rone))
    assert a.tolist() == ra.tolist()
    np.testing.assert_array_equal(np.asarray(a), X)
    i, ri = pair(np.array(3, np.int32), None)
    assert [10, 20, 30, 40][i] == 40 and i.__index__() == ri.__index__()
    with pytest.raises(ValueError):
        a.item()
    with pytest.raises(TypeError):
        len(htt.array(1.0))


def test_astype_copy_false_replaces_the_local_tensor():
    a = htt.array(I, split=0)
    b = a.astype(htt.float32)
    assert b is not a and a.dtype is htt.int32
    assert a.astype(htt.float32, copy=False) is a and a.dtype is htt.float32 and a.larray.dtype == torch.float32
    same(a, heat_tpu.array(I, split=0).astype(heat_tpu.float32, copy=False))


def test_layout_methods_at_world_one():
    """One rank holds everything: balanced under HeAT's criterion, and
    ``balance_``/``redistribute_`` keep the data."""
    a = htt.array(X, split=0)
    assert a.is_balanced() and a.is_balanced(force_check=True)
    sliced = a[3:]
    sliced.balance_()
    np.testing.assert_array_equal(sliced.numpy(), X[3:])
    a.redistribute_(lshape_map=a.lshape_map(), target_map=a.lshape_map())
    np.testing.assert_array_equal(a.numpy(), X)


@pytest.mark.parametrize("split", [None, 0, 1])
def test_factories_match_reference(split):
    for args in ((5,), ((5, 7),), ((6, 4),)):
        same(htt.eye(*args, split=split), heat_tpu.eye(*args, split=split))
    same(htt.eye(4, dtype=htt.int32, split=split), heat_tpu.eye(4, dtype=heat_tpu.int32, split=split))
    s1 = None if split == 1 else split
    for kw in ({}, {"endpoint": False}, {"dtype": htt.int32}):
        rkw = {k: (heat_tpu.int32 if v is htt.int32 else v) for k, v in kw.items()}
        same(htt.linspace(-2, 3, 13, split=s1, **kw), heat_tpu.linspace(-2, 3, 13, split=s1, **rkw))
    got, step = htt.linspace(0, 1, 9, retstep=True, split=s1)
    want, rstep = heat_tpu.linspace(0, 1, 9, retstep=True, split=s1)
    same(got, want)
    assert step == pytest.approx(rstep)
    same(htt.logspace(0, 2, 7, split=s1), heat_tpu.logspace(0, 2, 7, split=s1), rtol=1e-5)
    same(htt.logspace(0, 3, 4, base=2.0, split=s1), heat_tpu.logspace(0, 3, 4, base=2.0, split=s1))
    a, ra = pair(X, split)
    for name in ("zeros_like", "ones_like"):
        same(getattr(htt, name)(a), getattr(heat_tpu, name)(ra))
        same(getattr(htt, name)(a, dtype=htt.int32), getattr(heat_tpu, name)(ra, dtype=heat_tpu.int32))
    same(htt.full_like(a, 2.5), heat_tpu.full_like(ra, 2.5))
    e = htt.empty_like(a)
    want = heat_tpu.empty_like(ra)
    assert (e.shape, e.split, e.dtype.__name__) == (want.shape, want.split, want.dtype.__name__)


@pytest.mark.parametrize("indexing", ["xy", "ij"])
@pytest.mark.parametrize("split", [None, 0])
def test_meshgrid_matches_reference(indexing, split):
    got = htt.meshgrid(htt.arange(5, split=split), htt.arange(3), htt.linspace(0, 1, 4), indexing=indexing)
    want = heat_tpu.meshgrid(heat_tpu.arange(5, split=split), heat_tpu.arange(3), heat_tpu.linspace(0, 1, 4),
                             indexing=indexing)
    same(got, want)
    same(htt.meshgrid(htt.arange(3), htt.arange(4, split=0), indexing=indexing),
         heat_tpu.meshgrid(heat_tpu.arange(3), heat_tpu.arange(4, split=0), indexing=indexing))


def test_memory_and_stride_tricks_match_reference():
    a, ra = pair(X, 1)
    c = htt.copy(a)
    same(c, heat_tpu.copy(ra))
    assert c.larray.data_ptr() != a.larray.data_ptr()
    assert htt.sanitize_memory_layout(a, "F") is a
    with pytest.raises(ValueError):
        htt.sanitize_memory_layout(a, "K")
    with pytest.raises(TypeError):
        htt.copy(X)
    assert htt.broadcast_shapes((13, 1), (7,), (1, 1, 7)) == heat_tpu.broadcast_shapes((13, 1), (7,), (1, 1, 7))
    with pytest.raises(ValueError):
        htt.broadcast_shapes((3,), (4,))


def test_new_collectives_at_world_one_are_identity():
    comm = htt.get_comm()
    comm.reset_traffic()
    t = torch.arange(6.0).reshape(2, 3)
    for out in (comm.Alltoall(t, 0, 1), comm.ReduceScatter(t, 1), comm.Scan(t), comm.Reduce(t), comm.Scatter(t),
                comm.Gather(t), comm.resplit(t, (2, 3), 0, 1), comm.redistribute(t, 0, [2], [2])):
        assert out is t
    assert torch.equal(comm.Exscan(t), torch.zeros_like(t))  # rank 0 gets the sum's identity
    assert torch.equal(comm.Exscan(t, op="prod"), torch.ones_like(t))
    assert comm.Wait(comm.Isend(t)) is t and comm.Wait(t) is t
    comm.Barrier()
    assert comm.traffic() == {} and comm.transport(t, "Alltoall") == "local"
    with pytest.raises(ValueError):
        comm.Exscan(t, op="xor")
