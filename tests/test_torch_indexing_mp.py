"""heat_tpu_torch's indexing surface on three gloo processes.

One module-scoped spawn of 3 ranks (``torch.multiprocessing``, spawn) runs
every case of ``CASES`` on HeAT's uneven chunks (10 rows: 4, 3 and 3; 13:
5, 4, 4; 7: 3, 2, 2) and writes the gathered global result of each.  Each
case is one test here, held exactly against the port at world size 1 (which
``tests/test_torch_indexing.py`` holds against the reference): value with
nan equal and the sign of zero, dtype, shape and split.  The cases: every
key kind at every split, keys and masks given as split DNDarrays, an
unbalanced source, ``__setitem__`` with each value kind (a DNDarray value
at each split), ``-0.0`` and bool rows through a fancy index, ``where``,
``nonzero``, ``flatnonzero`` and ``fill_diagonal``.  Then the traffic of
``x[idx]`` and of ``x[idx] = y`` (only the rows that change rank move) and
of ``nonzero`` on a split-1 mask (no coordinates gathered), the metadata
checks on a sound array and on one corrupted by hand, ``str()`` on every
rank, and ``print0`` of a split array.

This module imports neither JAX nor heat_tpu: the spawned workers import it
and need only torch.
"""

import json
import pathlib
import socket
import warnings

import numpy as np
import pytest
import torch


def _data():
    rng = np.random.default_rng(31)
    d = {1: rng.standard_normal(13).astype(np.float32), 2: rng.standard_normal((10, 7)).astype(np.float32),
         3: rng.standard_normal((7, 6, 5)).astype(np.float32)}
    for a in d.values():
        a.flat[[1, 4]] = [np.nan, -0.0]
    return d


def _mask(a):
    return ~np.isnan(a) & (a > 0)


GET_KEYS = {
    1: {"int": 3, "neg_int": -1, "slice": slice(2, 9), "step": slice(1, None, 3), "reversed": slice(None, None, -1),
        "neg_step": slice(-2, 0, -3), "ellipsis": Ellipsis, "none": None, "list": [12, 0, 5, 5, -1],
        "array_2d": np.array([[0, 12], [6, 7]]), "mask": "mask", "tail_slice": slice(9, 13)},
    2: {"col": (slice(None), 2), "cols": (slice(None), [1, 2]), "pairs": ([1, 9], [3, 4]), "row": 7,
        "rows": [9, 0, 4, 4, 7], "scalar": (5, 3), "ellipsis_int": (Ellipsis, 1), "col_reversed": (slice(None), slice(None, None, -2)),
        "both_reversed": (slice(None, None, -3), slice(5, 1, -1)), "row_mask": "row_mask", "col_mask": "col_mask",
        "mask": "mask", "none_rows_none": (None, [1, 8], None), "broadcast": ([[0], [9]], [0, 2]), "int_cols": (3, [6, 0, 6]),
        "rows_reversed_cols": ([8, 2], slice(None, None, -1))},
    3: {"int_slice_cols": (1, slice(None), [0, 4]), "slice_int_cols": (slice(None), 0, [1, 2]),
        "arrays_around_slice": ([0, 6], slice(None), [2, 3]), "mask_leading_two": "mask_leading_two",
        "mask_trailing_two": "mask_trailing_two", "mask_middle": "mask_middle", "ellipsis_array_none": (Ellipsis, [1, 2], None),
        "int_array_reversed": (0, [1, 2], slice(None, None, -1)), "none_ellipsis_none": (None, Ellipsis, None, 2),
        "reversed": slice(None, None, -1)},
}


def _key(nd, a, k):
    named = {"mask": lambda: _mask(a), "row_mask": lambda: (a[:, 0] > 0,), "col_mask": lambda: (slice(None), a[0] > 0),
             "mask_leading_two": lambda: (a[:, :, 0] > 0,), "mask_trailing_two": lambda: (slice(None), a[0] > 0),
             "mask_middle": lambda: (slice(None), a[0, :, 0] > 0, slice(1, 3))}
    return named[k]() if isinstance(k, str) else k


def _get(nd, name, split):
    return lambda ht, d: ht.array(d[nd], split=split)[_key(nd, d[nd], GET_KEYS[nd][name])]


SET_CASES = {
    "scalar_row": (1, 3.5, 3), "scalar_cols": ((slice(None), [1, 2]), 7.0, 3), "reversed": (slice(None, None, -1), "rev", 3),
    "int_slice_cols": ((1, slice(None), [0, 4]), "b26", 3), "mask_scalar": ("mask", 0.0, 3),
    "leading_mask_rows": ("mask_leading_two", "rows", 3), "ellipsis": ((Ellipsis, 2), "ones76", 3),
    "rows_slice": (([0, 2], slice(1, 4)), "full", 3), "reversed_step": ((slice(None), slice(None, None, -2)), "ar5", 3),
    "fancy_rows": ([5, 1, 3], "rows3", 3), "float_into_int": ((slice(None), 3), 2.7, "int"),
    "mask_values": ("mask", "mask_vals", 3), "broadcast_pairs": (([[0], [6]], [1, 2]), "b225", 3),
    "repeated_rows": ([5, 1, 5], "rows3", 3), "int_reversed": ((2, slice(None, None, -1)), "ar65", 3),
}


def _set_value(name, d):
    a = d[3]
    nmask = int(_mask(a).sum())
    return {"rev": a[::-1] * 2, "b26": np.arange(12, dtype=np.float32).reshape(2, 6),
            "rows": np.arange(int((a[:, :, 0] > 0).sum()) * 5, dtype=np.float32).reshape(-1, 5),
            "ones76": np.ones((7, 6), np.float32), "full": np.full((2, 3, 5), 9.0, np.float32),
            "ar5": np.arange(5, dtype=np.float32), "rows3": np.arange(90, dtype=np.float32).reshape(3, 6, 5),
            "b225": np.arange(20, dtype=np.float32).reshape(2, 2, 5),
            "ar65": np.arange(30, dtype=np.float32).reshape(6, 5),
            "mask_vals": -np.arange(nmask, dtype=np.float32)}.get(name, name)


def _set(name, split, vkind):
    def run(ht, d):
        key, v, target = SET_CASES[name]
        a = d[3] if target == 3 else np.nan_to_num(d[2] * 4).astype(np.int32)
        key = _key(3, a, key) if isinstance(key, str) else key
        v = _set_value(v, d)
        x = ht.array(a, split=split)
        x[key] = v if vkind == "raw" else (torch.as_tensor(v) if vkind == "tensor" else ht.array(v, split=vkind))
        return x

    return run


def _value_kinds(name):
    v = _set_value(SET_CASES[name][1], _data())
    return ["raw"] if np.ndim(v) == 0 else ["raw", "tensor", None, *range(np.ndim(v))]


def _dnd_keys(ht, d):
    """Keys given as split DNDarrays: an index array and masks of another split."""
    x = ht.array(d[2], split=0)
    return [x[ht.array(np.array([9, 0, 9, 3], dtype=np.int32), split=0)], x[ht.array(d[2], split=1) > 0],
            ht.array(d[2], split=1)[ht.array(d[2], split=0) > 0], x[ht.array(d[2][:, 0] > 0, split=0)]]


def _unbalanced(ht, d):
    x = ht.array(d[2], split=0)[3:]  # 7 rows: 1, 3, 3 after the slice
    return [x[[6, 0, 3]], x[::-1], x[x > 0], x[1:6:2]]


def _special_rows(ht, d):
    z = np.array([[-0.0, 1.0], [0.0, -0.0], [np.nan, -np.inf], [2.0, 0.0]] * 3, dtype=np.float32)
    b = np.arange(24).reshape(12, 2) % 3 == 0
    idx = [11, 0, 5, 5, 2, 9]
    return [ht.array(z, split=0)[idx], ht.array(b, split=0)[idx], ht.array(b, split=1)[::-1],
            ht.array(z, split=0)[::-1], ht.array(b, split=0)[ht.array(b[:, 0], split=0)]]


def _where_nonzero(ht, d):
    a = np.nan_to_num(d[2])
    out = []
    for split in (None, 0, 1):
        x = ht.array(a, split=split)
        out += [ht.where(x > 0, x, 0), ht.where(x > 0, 1.0, ht.array(a)), ht.nonzero(x > 0), ht.flatnonzero(x),
                ht.where(x < 0)]
    return out


def _fill_diagonal(ht, d):
    return [ht.array(d[2], split=s).fill_diagonal(-1.5) for s in (None, 0, 1)] + [
        ht.array(d[3], split=s).fill_diagonal(9.0) for s in (0, 1, 2)]


CASES = {
    **{f"get_{nd}d_{name}_{split}": _get(nd, name, split) for nd, keys in GET_KEYS.items() for name in keys
       for split in [None, *range(nd)]},
    **{f"set_{name}_{split}_{vk}": _set(name, split, vk) for name in SET_CASES for split in (None, 0, 1, 2)
       for vk in _value_kinds(name) if SET_CASES[name][2] == 3 or split != 2},
    "dndarray_keys": _dnd_keys,
    "unbalanced_source": _unbalanced,
    "negative_zero_and_bool_rows": _special_rows,
    "where_nonzero": _where_nonzero,
    "fill_diagonal": _fill_diagonal,
}


def _encode(r):
    if isinstance(r, (list, tuple)):
        return [_encode(v) for v in r]
    a = r.numpy()
    return {"value": a.tolist(), "signbit": np.signbit(a).tolist() if a.dtype.kind == "f" else None,
            "dtype": r.dtype.__name__, "shape": list(r.shape), "split": r.split}


def _traffic(ht, d):
    """x[idx] on 10 x 7 float32 rows split 0 (4, 3, 3): the rows of each
    rank's chunk of the result that another rank holds, and nothing else."""
    comm = ht.get_comm()
    x = ht.array(d[2], split=0)
    idx = [9, 0, 4, 4, 7, 1]
    comm.reset_traffic()
    y = x[idx]
    return {"traffic": comm.traffic(), "value": y.numpy().tolist(), "split": y.split}


def _put_traffic(ht, d):
    """x[idx] = y on 10 x 7 float32 rows split 0 (4, 3, 3), y split 0 (2,
    2, 2): each rank sends the rows of its block of y that another rank
    holds, each with its position in y."""
    comm = ht.get_comm()
    x = ht.array(d[2], split=0)
    y = ht.array(-np.arange(42, dtype=np.float32).reshape(6, 7), split=0)
    comm.reset_traffic()
    x[[9, 0, 4, 1, 7, 8]] = y
    return {"traffic": comm.traffic(), "value": x.numpy().tolist()}


def _nonzero_traffic(ht, d):
    """ht.nonzero of a 10 x 7 bool mask split along axis 1 (3, 2, 2): the
    mask is resplit to 0 (one Alltoall of the bytes that change rank) and
    the ranks' counts are gathered; no coordinates are gathered."""
    comm = ht.get_comm()
    m = ht.array(d[2] > 0, split=1)
    comm.reset_traffic()
    nz = ht.nonzero(m)
    return {"traffic": comm.traffic(), "value": nz.numpy().tolist(), "split": nz.split,
            "lshape": list(nz.lshape)}


def _print0(ht, d):
    """What ``print0`` of a split array writes on this rank."""
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ht.print0(ht.array(d[2], split=1))
    return out.getvalue()


def _checks(ht, d):
    from heat_tpu_torch.core import sanitation

    res = {}
    x = ht.array(d[2], split=0)
    res["sound"] = [sanitation.validate_metadata(x) is x, sanitation.assert_cross_rank_consistent(x) is x,
                    sanitation.assert_cross_rank_consistent(x[x > 0]) is not None]
    bad = ht.array(d[2], split=0)
    if ht.get_comm().rank == 1:  # a local tensor one row short on one rank
        bad._DNDarray__array = bad.larray[:-1]
    for name, fn in (("validate", lambda: sanitation.validate_metadata(bad)),
                     ("cross_rank", lambda: sanitation.assert_cross_rank_consistent(bad))):
        try:
            fn()
            res[name] = "passed"
        except sanitation.MetadataError as e:
            res[name] = f"MetadataError: {e}"
    other = ht.array(d[2], split=0)
    if ht.get_comm().rank == 2:  # metadata that differs on one rank
        other._DNDarray__gshape = (11, 7)
    try:
        sanitation.assert_cross_rank_consistent(other)
        res["gshape_differs"] = "passed"
    except sanitation.MetadataError as e:
        res["gshape_differs"] = f"MetadataError: {e}"
    return res


def _strings(ht, d):
    big = np.arange(40 * 30, dtype=np.float32).reshape(40, 30) / 7
    return [str(ht.array(d[2], split=0)), repr(ht.array(d[3], split=2)), str(ht.array(big, split=0)),
            str(ht.array(big, split=1)), str(ht.array(np.arange(2000), split=0))]


def _worker(rank, port, out_dir):
    import heat_tpu_torch as ht

    ht.core.bootstrap.init_distributed(f"tcp://localhost:{port}", world_size=3, rank=rank, backend="gloo",
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
        res["_traffic"] = _traffic(ht, d)
        res["_put_traffic"] = _put_traffic(ht, d)
        res["_nonzero_traffic"] = _nonzero_traffic(ht, d)
        res["_print0"] = _print0(ht, d)
        res["_checks"] = _checks(ht, d)
        res["_strings"] = _strings(ht, d)
        (pathlib.Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(res))
    finally:
        ht.core.bootstrap.finalize_distributed()


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def three_ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("indexing_mp")
    ctx = torch.multiprocessing.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_worker, args=(r, port, str(out))) for r in range(3)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=300)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(5)
    assert [p.exitcode for p in procs] == [0, 0, 0]
    return [json.loads((out / f"rank{r}.json").read_text()) for r in range(3)]


@pytest.fixture(scope="module")
def world_one():
    import heat_tpu_torch as ht

    prev = ht.get_device()
    ht.use_device("cpu")
    try:
        d = _data()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return {name: _encode(fn(ht, d)) for name, fn in CASES.items()}, _strings(ht, d)
    finally:
        ht.use_device(prev)


def _hold(got, want, name):
    if isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), name
        for g, w in zip(got, want):
            _hold(g, w, name)
        return
    assert "error" not in got, f"{name}: {got.get('error')}"
    assert (got["dtype"], got["shape"], got["split"]) == (want["dtype"], want["shape"], want["split"]), name
    np.testing.assert_array_equal(np.asarray(got["value"]), np.asarray(want["value"]), err_msg=name)
    assert got["signbit"] == want["signbit"], f"{name}: the sign of a zero differs"


@pytest.mark.parametrize("name", list(CASES))
def test_three_ranks_match_world_one(name, three_ranks, world_one):
    for rank, res in enumerate(three_ranks):
        _hold(res[name], world_one[0][name], f"{name} (rank {rank})")


def test_fancy_index_moves_only_the_rows_that_change_rank(three_ranks):
    """idx = [9, 0, 4, 4, 7, 1] over rows held 0-3 | 4-6 | 7-9; the result's
    chunks (2, 2, 2) need rows {9, 0} on rank 0, {4} on rank 1 and {7, 1} on
    rank 2.  So rank 0 sends row 1 (to rank 2), rank 1 nothing, rank 2 row 9
    (to rank 0): 28 bytes each, in one exchange, and the index (the same on
    every rank) does not move."""
    want_rows = _data()[2][[9, 0, 4, 4, 7, 1]]
    sent = {0: 28, 1: 0, 2: 28}
    for rank, res in enumerate(three_ranks):
        t = res["_traffic"]
        np.testing.assert_array_equal(np.asarray(t["value"], dtype=np.float32), want_rows)
        assert t["split"] == 0
        assert t["traffic"] == {"Alltoall": {"calls": 1, "bytes": sent[rank]}}, rank


def test_metadata_checks_pass_a_sound_array_and_catch_a_corrupted_one(three_ranks):
    for rank, res in enumerate(three_ranks):
        c = res["_checks"]
        assert c["sound"] == [True, True, True]
        if rank == 1:
            assert c["validate"].startswith("MetadataError"), c["validate"]
        else:
            assert c["validate"] == "passed"
        assert c["cross_rank"].startswith("MetadataError"), (rank, c["cross_rank"])
        assert c["gshape_differs"].startswith("MetadataError"), (rank, c["gshape_differs"])


def test_str_is_the_same_on_every_rank_and_at_world_one(three_ranks, world_one):
    for rank, res in enumerate(three_ranks):
        assert res["_strings"] == world_one[1], rank
    assert "..." in world_one[1][2] and "..." in world_one[1][4]


def test_assignment_moves_only_the_rows_that_change_rank(three_ranks):
    """idx = [9, 0, 4, 1, 7, 8] over rows held 0-3 | 4-6 | 7-9, y's blocks
    (2, 2, 2): rank 0 sends y's row 0 (to row 9, rank 2), rank 1 y's row 3
    (to row 1, rank 0), rank 2 nothing.  A row costs its int64 position and
    its 28 bytes; the ranks' counts cost one Allgather of 3 int64 to 2
    ranks."""
    want = _data()[2].copy()
    want[[9, 0, 4, 1, 7, 8]] = -np.arange(42, dtype=np.float32).reshape(6, 7)
    rows = {0: 1, 1: 1, 2: 0}
    for rank, res in enumerate(three_ranks):
        t = res["_put_traffic"]
        np.testing.assert_array_equal(np.asarray(t["value"], dtype=np.float32), want)
        assert t["traffic"] == {"Allgather": {"calls": 1, "bytes": 48},
                                "Alltoall": {"calls": 2, "bytes": rows[rank] * (8 + 28)}}, rank


def test_nonzero_of_a_later_split_gathers_no_coordinates(three_ranks):
    m = _data()[2] > 0
    want = np.stack(np.nonzero(m), 1)
    for rank, res in enumerate(three_ranks):
        t = res["_nonzero_traffic"]
        np.testing.assert_array_equal(np.asarray(t["value"]), want)
        assert t["split"] == 0
        assert set(t["traffic"]) == {"Alltoall", "Allgather"}, (rank, t["traffic"])
        assert t["traffic"]["Alltoall"]["bytes"] <= m.size, (rank, t["traffic"])
    # each rank holds the coordinates of the mask's rows it holds after the resplit (4, 3, 3)
    held = [int(m[a:b].sum()) for a, b in ((0, 4), (4, 7), (7, 10))]
    assert [res["_nonzero_traffic"]["lshape"][0] for res in three_ranks] == held


def test_print0_of_a_split_array_prints_once_and_returns_on_every_rank(three_ranks, world_one):
    import heat_tpu_torch as ht

    prev = ht.get_device()
    ht.use_device("cpu")
    try:
        want = str(ht.array(_data()[2], split=1)) + "\n"
    finally:
        ht.use_device(prev)
    assert [res["_print0"] for res in three_ranks] == [want, "", ""]
