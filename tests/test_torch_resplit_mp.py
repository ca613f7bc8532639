"""heat_tpu_torch's array core and ``ht.matmul`` on two gloo processes.

One module-scoped spawn of 2 ranks (``torch.multiprocessing``, spawn) runs
every case of ``CASES`` on HeAT's uneven chunks (37 rows: 19 and 18; one
row: 1 and 0) and writes the gathered global result of each.  Each case is
one test here, held against the reference on its 8-device CPU mesh and
against the port at world size 1: value, dtype, shape and split.
Tolerances: integer, bool and data movement exactly; float32 element-wise
ops and reductions rtol 1e-5, atol 1e-6 (another order of the same float32
sums); matmul rtol 1e-5 of the largest entry (partial products over K
halves summed).

``COLLECTIVES`` holds each communicator collective at world size 2: on even
blocks against the reference's collective inside ``shard_map`` on a mesh of
2 devices, and on uneven blocks against its numpy definition (the reference
takes no uneven blocks).

This module imports neither JAX nor heat_tpu at the top: the spawned
workers import it and need only torch.
"""

import json
import pathlib
import socket
import warnings

import numpy as np
import pytest
import torch

M, K, N = 37, 29, 31


def _data():
    rng = np.random.default_rng(10)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {
        "A": f(M, K), "B": f(K, N), "v": f(K), "w": f(M), "X": f(13, 7), "Y": f(13, 7), "row": f(7), "col": f(13, 1),
        "one": f(1, 5), "I": rng.integers(-5, 6, (13, 7)).astype(np.int32), "batch": f(3, M, K),
        "pos": np.abs(f(13, 7)) + 0.5,
    }


def _matmul_case(sa, sb):
    return lambda ht, d: ht.matmul(ht.array(d["A"], split=sa), ht.array(d["B"], split=sb))


def _resplit_round_trip(ht, d):
    x = ht.array(d["X"], split=0)
    steps = []
    for axis in (1, None, 0):
        x.resplit_(axis)
        steps.append((x.split, x.numpy().tolist()))
    assert all(s == want for (s, _), want in zip(steps, (1, None, 0)))
    assert all(v == d["X"].tolist() for _, v in steps)
    return x


def _unbalanced_plus_balanced(ht, d):
    x = ht.array(d["X"], split=0)[2:]  # rows 2..12: an unbalanced layout
    y = ht.array(d["Y"][2:], split=0)
    return x + y


def _iadd(ht, d):
    x = ht.array(d["X"], split=0)
    x += ht.array(d["Y"], split=1)
    return x


CASES = {
    **{f"matmul_{sa}_{sb}": _matmul_case(sa, sb) for sa in (None, 0, 1) for sb in (None, 0, 1)},
    "matmul_vec_mat_0_1": lambda ht, d: ht.matmul(ht.array(d["v"], split=0), ht.array(d["B"], split=1)),
    "matmul_vec_mat_0_0": lambda ht, d: ht.matmul(ht.array(d["v"], split=0), ht.array(d["B"], split=0)),
    "matmul_vec_mat_None_1": lambda ht, d: ht.matmul(ht.array(d["v"]), ht.array(d["B"], split=1)),
    "matmul_mat_vec_0_0": lambda ht, d: ht.matmul(ht.array(d["A"], split=0), ht.array(d["v"], split=0)),
    "matmul_mat_vec_1_None": lambda ht, d: ht.matmul(ht.array(d["A"], split=1), ht.array(d["v"])),
    "matmul_mat_vec_None_0": lambda ht, d: ht.matmul(ht.array(d["A"]), ht.array(d["v"], split=0)),
    "matmul_batch_0_None": lambda ht, d: ht.matmul(ht.array(d["batch"], split=0), ht.array(d["B"])),
    "matmul_batch_1_1": lambda ht, d: ht.matmul(ht.array(d["batch"], split=1), ht.array(d["B"], split=1)),
    "dot_0_0": lambda ht, d: ht.dot(ht.array(d["v"], split=0), ht.array(d["v"], split=0)),
    "matmul_summa_0_0": lambda ht, d: ht.linalg.matmul_summa(ht.array(d["A"], split=0), ht.array(d["B"], split=0)),
    "matmul_summa_1_1": lambda ht, d: ht.linalg.matmul_summa(ht.array(d["A"], split=1), ht.array(d["B"], split=1)),
    "matmul_method_summa": lambda ht, d: ht.matmul(ht.array(d["A"], split=0), ht.array(d["B"], split=0),
                                                   method="summa"),
    "matmul_operator_T": lambda ht, d: ht.array(d["A"], split=0) @ ht.array(d["A"], split=0).T,
    "resplit_round_trip": _resplit_round_trip,
    "resplit_copy_0_1": lambda ht, d: ht.array(d["X"], split=0).resplit(1),
    "resplit_one_row": lambda ht, d: ht.array(d["one"], split=0).resplit(1),
    "add_mismatched_splits": lambda ht, d: ht.array(d["X"], split=0) + ht.array(d["Y"], split=1),
    "add_split_and_replicated": lambda ht, d: ht.array(d["X"], split=0) + ht.array(d["Y"]),
    "add_replicated_and_split": lambda ht, d: ht.array(d["X"]) + ht.array(d["Y"], split=1),
    "mul_broadcast_row": lambda ht, d: ht.array(d["X"], split=0) * ht.array(d["row"], split=0),
    "sub_broadcast_col": lambda ht, d: ht.array(d["X"], split=1) - ht.array(d["col"], split=0),
    "add_unbalanced": _unbalanced_plus_balanced,
    "iadd_mismatched": _iadd,
    "where_out": lambda ht, d: ht.add(ht.array(d["X"], split=0), 1.0, out=ht.zeros((13, 7), split=0),
                                      where=ht.array(d["X"], split=0) > 0),
    "exp_split1": lambda ht, d: ht.exp(ht.array(d["X"], split=1)),
    "sum_split_axis": lambda ht, d: ht.sum(ht.array(d["X"], split=0), axis=0),
    "sum_other_axis": lambda ht, d: ht.sum(ht.array(d["X"], split=0), axis=1),
    "sum_all": lambda ht, d: ht.array(d["X"], split=1).sum(),
    "sum_keepdims": lambda ht, d: ht.sum(ht.array(d["X"], split=1), axis=0, keepdims=True),
    "max_split_axis": lambda ht, d: ht.max(ht.array(d["X"], split=0), axis=0),
    "min_other_axis": lambda ht, d: ht.array(d["X"], split=0).min(1),
    "prod_split_axis_int": lambda ht, d: ht.prod(ht.array(d["I"] % 3 + 1, split=0), axis=0),
    "all_any_count": lambda ht, d: [ht.all(ht.array(d["X"], split=0) > -3, axis=0),
                                    ht.any(ht.array(d["X"], split=0) > 2, axis=0),
                                    ht.count_nonzero(ht.array(d["I"], split=0), axis=0)],
    "sum_one_row": lambda ht, d: ht.sum(ht.array(d["one"], split=0), axis=0),
    "max_one_row": lambda ht, d: ht.max(ht.array(d["one"], split=0), axis=0),
    "cumsum_split_axis": lambda ht, d: ht.cumsum(ht.array(d["X"], split=0), 0),
    "cumsum_other_axis": lambda ht, d: ht.cumsum(ht.array(d["X"], split=0), 1),
    "cumprod_split_axis": lambda ht, d: ht.cumprod(ht.array(d["pos"], split=0), 0),
    "cumsum_one_row": lambda ht, d: ht.cumsum(ht.array(d["one"], split=0), 0),
    "cumsum_int_split": lambda ht, d: ht.cumsum(ht.array(d["I"], split=0), 0),
    "diff_split_axis": lambda ht, d: ht.diff(ht.array(d["X"], split=0), n=2, axis=0),
    "trapz_split_axis": lambda ht, d: ht.trapezoid(ht.array(d["X"], split=0), axis=0),
    "gradient_split_axis": lambda ht, d: ht.gradient(ht.array(d["X"], split=0), axis=0),
    "ediff1d_split": lambda ht, d: ht.ediff1d(ht.array(d["X"], split=0)),
    "norm_split": lambda ht, d: [ht.norm(ht.array(d["X"], split=0)), ht.norm(ht.array(d["X"], split=0), axis=1),
                                 ht.matrix_norm(ht.array(d["X"], split=1), ord=1)],
    "trace_tril_split": lambda ht, d: [ht.trace(ht.array(d["X"], split=0), offset=1),
                                       ht.tril(ht.array(d["X"], split=0), -1), ht.triu(ht.array(d["X"], split=1), 2)],
    "outer_split": lambda ht, d: ht.outer(ht.array(d["w"], split=0), ht.array(d["v"])),
    "transpose_split": lambda ht, d: ht.transpose(ht.array(d["batch"], split=1), (2, 0, 1)),
    "equal_allclose": lambda ht, d: [ht.equal(ht.array(d["X"], split=0), ht.array(d["X"], split=1)),
                                     ht.allclose(ht.array(d["X"], split=0), ht.array(d["X"] + 1e-9, split=0))],
    "factories_split": lambda ht, d: [ht.eye((5, 7), split=1), ht.linspace(-1, 2, 11, split=0),
                                      ht.zeros_like(ht.array(d["X"], split=1)),
                                      ht.meshgrid(ht.arange(5, split=0), ht.arange(3))[0]],
    "vdot_split": lambda ht, d: ht.vdot(ht.array(d["X"], split=0), ht.array(d["Y"], split=1)),
    "matmul_unbalanced_0_0": lambda ht, d: ht.matmul(ht.array(d["A"], split=0)[3:], ht.array(d["B"], split=0)),
    "matmul_summa_unbalanced": lambda ht, d: ht.linalg.matmul_summa(ht.array(d["A"], split=0)[3:, 2:],
                                                                    ht.array(d["B"], split=0)[2:]),
    "trapz_other_axis": lambda ht, d: ht.trapezoid(ht.array(d["X"], split=0), dx=0.5, axis=1),
    "diff_prepend_split_axis": lambda ht, d: ht.diff(ht.array(d["X"], split=0), axis=0, prepend=0.0),
    "gradient_coords_split": lambda ht, d: ht.gradient(ht.array(d["X"], split=0), np.arange(13.0) ** 1.5, axis=0),
    "outer_split1": lambda ht, d: ht.outer(ht.array(d["w"]), ht.array(d["v"], split=0), split=1),
    "in1d_split": lambda ht, d: ht.in1d(ht.array(d["I"], split=0), [0, 1, 2]),
    "where_replicated_mask": lambda ht, d: ht.mul(ht.array(d["X"], split=1), ht.array(d["Y"], split=1),
                                                  where=ht.array(d["X"] > 0)),
    "where_mask_split_elsewhere": lambda ht, d: ht.add(ht.array(d["X"], split=1), ht.array(d["Y"], split=1),
                                                       out=ht.zeros((13, 7), split=0),
                                                       where=ht.array(d["X"] > 0, split=0)),
    "cumprod_one_row": lambda ht, d: ht.cumprod(ht.array(d["one"], split=0), 0),
    "all_one_row": lambda ht, d: ht.all(ht.array(d["one"], split=0) > -9, axis=0),
}


COLLECTIVES = ("Allreduce", "Allgather", "Allgatherv", "Alltoall", "ReduceScatter", "Exscan", "Scan", "Bcast",
               "Reduce", "Scatter", "Gather", "Send")


ROW_UNEVEN = ("Allgatherv", "Alltoall", "Gather")  # uneven: 3 | 2 rows; the others an axis of 5


def _blocks(rank, even, name):
    """This rank's block: 4 x 6 on every rank (even); uneven, 3 | 2 rows of 6
    for the collectives that take blocks of differing rows, else 4 x 5 (an
    axis that HeAT cuts 3 | 2)."""
    rows, cols = (4, 6) if even else ((3 - rank, 6) if name in ROW_UNEVEN else (4, 5))
    return np.arange(rows * cols, dtype=np.float32).reshape(rows, cols) + 100 * rank + 1


def _run_collective(comm, name, x):
    if name == "Allreduce":
        return comm.Allreduce(x.clone())
    if name == "Allgather":
        return torch.cat(comm.Allgather(x))
    if name == "Allgatherv":
        return comm.Allgatherv(x, 0)
    if name == "Alltoall":
        return comm.Alltoall(x, 1, 0)
    if name == "ReduceScatter":
        return comm.ReduceScatter(x, 1)
    if name in ("Exscan", "Scan"):
        return getattr(comm, name)(x)
    if name == "Bcast":
        return comm.Bcast(x.clone(), root=1)
    if name == "Reduce":
        return comm.Reduce(x.clone(), root=1)
    if name == "Scatter":
        return comm.Scatter(x, root=1, axis=1)
    if name == "Gather":
        return comm.Gather(x, root=1, axis=0)
    return comm.Send(x, shift=1)


def _encode(r):
    import heat_tpu_torch as ht

    if isinstance(r, (list, tuple)):
        return [_encode(v) for v in r]
    if isinstance(r, ht.DNDarray):
        return {"value": r.numpy().tolist(), "dtype": r.dtype.__name__, "shape": list(r.shape), "split": r.split,
                "lshape": list(r.lshape)}
    return {"scalar": r}


def _worker(rank, port, out_dir):
    import heat_tpu_torch as ht

    ht.core.bootstrap.init_distributed(f"tcp://localhost:{port}", world_size=2, rank=rank, backend="gloo",
                                       timeout_s=60)
    warnings.simplefilter("ignore")
    try:
        ht.use_device("cpu")
        d, res = _data(), {}
        for name, fn in CASES.items():
            try:
                res[name] = _encode(fn(ht, d))
            except Exception as e:  # recorded per case, so one fault fails one test
                res[name] = {"error": f"{type(e).__name__}: {e}"}
        comm = ht.get_comm()
        comm.reset_traffic()
        for name in COLLECTIVES:
            res[name] = {str(even): _run_collective(comm, name, torch.from_numpy(_blocks(rank, even, name))).tolist()
                         for even in (True, False) if even or name != "Allgather"}
        res["traffic"] = comm.traffic()
        res["transport"] = {name: comm.transport(torch.zeros(1), name) for name in COLLECTIVES}
        x = ht.array(_data()["X"], split=0)[3:]  # rows 3..12: 4 | 6 on two ranks
        res["is_balanced"] = [x.is_balanced(), x.is_balanced(force_check=True), x.lshape_map().tolist()]
        x.balance_()
        res["balance_"] = [x.lshape_map().tolist(), x.balanced, x.numpy().tolist(), x.is_balanced()]
        x.redistribute_(target_map=[[10, 7], [0, 7]])
        res["redistribute_"] = [list(x.lshape), x.balanced, x.numpy().tolist()]
        (pathlib.Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(res))
    finally:
        ht.core.bootstrap.finalize_distributed()


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("resplit_mp")
    ctx = torch.multiprocessing.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_worker, args=(r, port, str(out))) for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=240)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(5)
    assert [p.exitcode for p in procs] == [0, 0]
    return [json.loads((out / f"rank{r}.json").read_text()) for r in range(2)]


@pytest.fixture(scope="module")
def references():
    """Each case through the reference (8-device mesh) and the port at world size 1."""
    import heat_tpu
    import heat_tpu_torch as htt

    prev = htt.get_device()
    htt.use_device("cpu")
    try:
        d, ref, one = _data(), {}, {}
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            for name, fn in CASES.items():
                ref[name] = fn(heat_tpu, d)
                one[name] = _encode(fn(htt, d))
        return ref, one
    finally:
        htt.use_device(prev)


def _ref_encode(r):
    if isinstance(r, (list, tuple)):
        return [_ref_encode(v) for v in r]
    if hasattr(r, "numpy") and hasattr(r, "split"):
        return {"value": np.asarray(r.numpy()).tolist(), "dtype": r.dtype.__name__, "shape": list(r.shape),
                "split": r.split}
    return {"scalar": bool(r) if isinstance(r, (bool, np.bool_)) else r}


def _hold(got, want, name):
    if isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), name
        for g, w in zip(got, want):
            _hold(g, w, name)
        return
    assert "error" not in got, f"{name}: {got.get('error')}"
    if "scalar" in want:
        if isinstance(want["scalar"], bool):
            assert got["scalar"] is want["scalar"], name
        else:
            assert got["scalar"] == pytest.approx(want["scalar"], rel=1e-5, abs=1e-6), name
        return
    assert (got["dtype"], got["shape"], got["split"]) == (want["dtype"], want["shape"], want["split"]), name
    g, w = np.asarray(got["value"]), np.asarray(want["value"])
    if w.dtype.kind in "biu" or name.startswith("resplit"):
        np.testing.assert_array_equal(g, w, err_msg=name)
    elif name.startswith(("matmul", "dot")):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5 * float(np.abs(w).max()), err_msg=name)
    else:
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("name", list(CASES))
def test_two_ranks_match_reference_and_world_one(name, two_ranks, references):
    ref, one = references
    want = _ref_encode(ref[name])
    for rank, res in enumerate(two_ranks):
        _hold(res[name], want, f"{name} (rank {rank} vs reference)")
        _hold(res[name], one[name], f"{name} (rank {rank} vs world 1)")


def test_matmul_local_shapes_follow_the_chunks(two_ranks):
    """A row-split product holds HeAT's chunk of rows on each rank (19 | 18),
    a column-split one its chunk of columns (16 | 15)."""
    assert [r["matmul_0_0"]["lshape"] for r in two_ranks] == [[19, N], [18, N]]
    assert [r["matmul_1_1"]["lshape"] for r in two_ranks] == [[M, 16], [M, 15]]
    assert [r["matmul_None_0"]["lshape"] for r in two_ranks] == [[M, 16], [M, 15]]


def _reference_collective(name, blocks):
    """The reference's collective inside ``shard_map`` on a 2-device mesh:
    shard r holds ``blocks[r]``; returns each shard's result."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from heat_tpu.core.communication import Communication

    comm = Communication(Mesh(np.array(jax.devices()[:2]), ("x",)))
    fns = {
        "Allreduce": lambda x: comm.Allreduce(x), "Allgather": lambda x: comm.Allgather(x, axis=0),
        "Allgatherv": lambda x: comm.Allgather(x, axis=0), "Alltoall": lambda x: comm.Alltoall(x, 1, 0),
        "ReduceScatter": lambda x: comm.ReduceScatter(x, 1), "Exscan": comm.Exscan, "Scan": comm.Scan,
        "Bcast": lambda x: comm.Bcast(x, root=1), "Reduce": lambda x: comm.Reduce(x, root=1),
        "Scatter": lambda x: comm.Scatter(x, root=1, axis=1), "Gather": lambda x: comm.Gather(x, root=1, axis=0),
        "Send": lambda x: comm.Send(x, shift=1),
    }
    mapped = comm.shard_map(lambda x: fns[name](x[0])[None], in_splits=((3, 0),), out_splits=(3, 0))
    out = np.asarray(mapped(jnp.asarray(np.stack(blocks))))
    return [out[r] for r in range(2)]


def _cols(n, rank):
    """HeAT's chunk of n columns on 2 ranks."""
    first = n - n // 2
    return slice(0, first) if rank == 0 else slice(first, n)


def _numpy_collective(name, blocks, rank):
    """The collective's definition on numpy blocks (uneven ones too)."""
    rows = np.concatenate(blocks)
    total = blocks[0] + blocks[1] if blocks[0].shape == blocks[1].shape else None
    n = blocks[0].shape[1]
    return {
        "Allreduce": total, "Allgather": rows, "Allgatherv": rows,
        "Alltoall": np.concatenate([b[:, _cols(n, rank)] for b in blocks]),
        "ReduceScatter": None if total is None else total[:, _cols(n, rank)],
        "Exscan": blocks[0] if rank == 1 else np.zeros_like(blocks[0]),
        "Scan": blocks[0] if rank == 0 else total,
        "Bcast": blocks[1], "Reduce": total if rank == 1 else np.zeros_like(blocks[0]),
        "Scatter": blocks[1][:, _cols(n, rank)],
        "Gather": rows if rank == 1 else np.zeros_like(rows),
        "Send": blocks[1 - rank],
    }[name]


@pytest.mark.parametrize("name", COLLECTIVES)
def test_collective_at_world_two(name, two_ranks):
    """Even blocks (4 x 6) against the reference's collective on 2 devices
    and the numpy definition; uneven blocks (3 | 2 rows, or an axis of 5
    cut 3 | 2) against the numpy definition, exactly."""
    even = [_blocks(r, True, name) for r in range(2)]
    want = _reference_collective(name, even)
    uneven = [_blocks(r, False, name) for r in range(2)]
    for rank, res in enumerate(two_ranks):
        got = np.asarray(res[name]["True"])
        np.testing.assert_array_equal(got, want[rank], err_msg=f"{name} rank {rank} vs reference")
        np.testing.assert_array_equal(got, _numpy_collective(name, even, rank), err_msg=f"{name} rank {rank}")
        if name != "Allgather":  # its blocks share one shape: Allgatherv takes uneven ones
            np.testing.assert_array_equal(np.asarray(res[name]["False"]), _numpy_collective(name, uneven, rank),
                                          err_msg=f"{name} uneven, rank {rank}")


def test_traffic_counts_each_collective(two_ranks):
    """One call a collective and block, and the wire bytes of the JAX
    package's factors at p = 2: Alltoall 0.5x the payload, Send 1x, Exscan
    2x, Scan 1x (Allgatherv, Gather and Alltoall gather their counts with an
    Allgather of their own)."""
    for rank, res in enumerate(two_ranks):
        t = res["traffic"]

        def payload(name):
            return sum(_blocks(rank, even, name).nbytes for even in (True, False))

        assert t["Alltoall"] == {"calls": 2, "bytes": payload("Alltoall") // 2}
        assert t["Send"] == {"calls": 2, "bytes": payload("Send")}
        assert t["Exscan"] == {"calls": 2, "bytes": 2 * payload("Exscan")}
        assert t["Scan"] == {"calls": 2, "bytes": payload("Scan")}
        assert t["ReduceScatter"] == {"calls": 2, "bytes": payload("ReduceScatter") // 2}
        for name in ("Allreduce", "Bcast", "Reduce", "Scatter", "Gather"):
            assert t[name]["calls"] == 2, name
        assert set(res["transport"].values()) == {"gloo"}


def test_layout_is_balanced_balance_redistribute(two_ranks):
    """Rows 3..12 of 13 on two ranks hold 4 | 6 rows: not balanced by HeAT's
    criterion; balance_ moves them to 5 | 5, redistribute_ to 10 | 0."""
    X = _data()["X"]
    for rank, res in enumerate(two_ranks):
        assert res["is_balanced"] == [False, False, [[4, 7], [6, 7]]]
        assert res["balance_"][:2] == [[[5, 7], [5, 7]], True] and res["balance_"][3] is True
        np.testing.assert_array_equal(res["balance_"][2], X[3:])
        assert res["redistribute_"][:2] == [[10, 7] if rank == 0 else [0, 7], False]
        np.testing.assert_array_equal(res["redistribute_"][2], X[3:])
