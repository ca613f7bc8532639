"""heat_tpu_torch's spatial distances, QR, SVD, solvers, tile views and
boolean masks on two gloo processes.

One module-scoped spawn of 2 ranks (``torch.multiprocessing``, spawn) runs
every case of ``CASES`` on HeAT's uneven chunks (37 rows: 19 and 18) and
writes the gathered global result of each.  Each case is one test here,
held against the reference on its 8-device CPU mesh (the tile views, whose
algebra depends on the world size, against the reference on a mesh of 2
devices) and against the port at world size 1: value, dtype, shape and
split.  QR factors are compared with R's diagonal made positive, SVD
factors with each V column's largest entry made positive (U's column
flipped with it).

Tolerances: masks and tiles exactly; distances by the direct form rtol
1e-5, atol 1e-6; the quadratic expansion, the factors and the solvers
rtol 1e-4, atol 1e-4 times the largest entry (other orders of the same
float32 sums; cg stops at its own residual).

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

M, N = 37, 5


def _data():
    rng = np.random.default_rng(71)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    g = f(M, M)
    u, _ = np.linalg.qr(rng.standard_normal((M, 4)))
    v, _ = np.linalg.qr(rng.standard_normal((12, 4)))
    v0 = f(M)
    return {
        "X": f(M, N), "Y": f(31, N) + 0.5, "wide": f(5, 9), "short": f(9, 6),
        "spd": (g @ g.T / M + np.eye(M)).astype(np.float32), "b": f(M), "B": f(M, 3),
        "upper": (np.triu(f(M, M)) + 4 * np.eye(M)).astype(np.float32),
        "rank4": ((u * np.array([8.0, 5.0, 3.0, 1.0])) @ v.T).astype(np.float32),
        "v0": (v0 / np.linalg.norm(v0)).astype(np.float32), "rows": np.arange(M, dtype=np.float32),
    }


def _pairs(name, fn):
    return {f"{name}_{sx}_{sy}": (lambda ht, d, c, sx=sx, sy=sy: fn(ht, ht.array(d["X"], split=sx, comm=c),
                                                                     ht.array(d["Y"], split=sy, comm=c)))
            for sx in (None, 0, 1) for sy in (None, 0, 1)}


def _rsvd(ht, d, c):
    u, s, v = ht.linalg.rsvd(ht.array(d["rank4"], split=0), 4)
    recon = u.numpy() @ np.diag(s.numpy()) @ v.numpy().T
    return [s, bool(np.abs(recon - d["rank4"]).max() < 1e-4 * np.abs(d["rank4"]).max()), u.split, list(u.shape)]


def _tiles(ht, d, c):
    a = ht.array(d["spd"][:, :20], split=0, comm=c)
    tiles = ht.core.tiling.SquareDiagTiles(a, tiles_per_proc=2) if ht.__name__ == "heat_tpu" else \
        ht.tiling.SquareDiagTiles(a, tiles_per_proc=2)
    out = [int(v) for v in tiles.row_indices] + [int(v) for v in tiles.col_indices] + [tiles.tile_rows]
    return out + [ht.array(np.asarray(tiles[i, i])) for i in range(tiles.tile_columns)]


def _split_tiles(ht, d, c):
    a = ht.array(d["X"], split=0, comm=c)
    tiles = ht.core.tiling.SplitTiles(a) if ht.__name__ == "heat_tpu" else ht.tiling.SplitTiles(a)
    return [int(v) for dims in tiles.tile_dimensions for v in dims] + [ht.array(np.asarray(tiles[1]))]


CASES = {
    **_pairs("cdist", lambda ht, x, y: ht.spatial.cdist(x, y)),
    **_pairs("cdist_ring", lambda ht, x, y: ht.spatial.cdist_ring(x, y)),
    "cdist_self_0": lambda ht, d, c: ht.spatial.cdist(ht.array(d["X"], split=0)),
    "cdist_expansion_0_0": lambda ht, d, c: ht.spatial.cdist(ht.array(d["X"], split=0), ht.array(d["Y"], split=0),
                                                             quadratic_expansion=True),
    "manhattan_0_1": lambda ht, d, c: ht.spatial.manhattan(ht.array(d["X"], split=0), ht.array(d["Y"], split=1)),
    "manhattan_None_0": lambda ht, d, c: ht.spatial.manhattan(ht.array(d["X"]), ht.array(d["Y"], split=0)),
    "rbf_0_0": lambda ht, d, c: ht.spatial.rbf(ht.array(d["X"], split=0), ht.array(d["Y"], split=0), sigma=2.0),
    "rbf_1_0": lambda ht, d, c: ht.spatial.rbf(ht.array(d["X"], split=1), ht.array(d["Y"], split=0),
                                               quadratic_expansion=True),
    "qr_split0": lambda ht, d, c: list(ht.linalg.qr(ht.array(d["X"], split=0))),
    "qr_split0_householder": lambda ht, d, c: list(ht.linalg.qr(ht.array(d["X"], split=0), method="householder")),
    "qr_split1_tall": lambda ht, d, c: list(ht.linalg.qr(ht.array(d["X"], split=1))),
    "qr_split1_wide": lambda ht, d, c: list(ht.linalg.qr(ht.array(d["wide"], split=1))),
    "qr_replicated_path": lambda ht, d, c: list(ht.linalg.qr(ht.array(d["short"], split=0))),
    "qr_mode_r": lambda ht, d, c: [ht.linalg.qr(ht.array(d["X"], split=0), mode="r").R],
    "tsqr_split1": lambda ht, d, c: list(ht.linalg.tsqr(ht.array(d["X"], split=1))),
    "svd_split0": lambda ht, d, c: list(ht.linalg.svd(ht.array(d["X"], split=0))),
    "svd_split1_wide": lambda ht, d, c: list(ht.linalg.svd(ht.array(d["X"].T.copy(), split=1))),
    "svd_split1_tall": lambda ht, d, c: list(ht.linalg.svd(ht.array(d["X"], split=1))),
    "svd_values": lambda ht, d, c: ht.linalg.svd(ht.array(d["X"], split=0), compute_uv=False),
    "hsvd_rank_split0": lambda ht, d, c: list(ht.linalg.hsvd_rank(ht.array(d["rank4"], split=0), 4,
                                                                  compute_sv=True)[:3]),
    "hsvd_rank_split1": lambda ht, d, c: list(ht.linalg.hsvd_rank(ht.array(d["rank4"], split=1), 4,
                                                                  compute_sv=True)[:3]),
    "hsvd_rtol_values": lambda ht, d, c: ht.linalg.hsvd_rtol(ht.array(d["rank4"], split=0), 1e-3,
                                                             compute_sv=True)[1][:4],
    "rsvd_recovers_rank4": _rsvd,
    "cg_split0": lambda ht, d, c: ht.linalg.cg(ht.array(d["spd"], split=0), ht.array(d["b"], split=0), tol=1e-6),
    "cg_split1_b_replicated": lambda ht, d, c: ht.linalg.cg(ht.array(d["spd"], split=1), ht.array(d["b"]), tol=1e-6),
    "lanczos_split0": lambda ht, d, c: list(ht.linalg.lanczos(ht.array(d["spd"], split=0), 8,
                                                              v0=ht.array(d["v0"], split=0))),
    "solve_blocked_split0": lambda ht, d, c: ht.linalg.solve_triangular(ht.array(d["upper"], split=0),
                                                                        ht.array(d["b"], split=0)),
    "solve_blocked_split1_lower": lambda ht, d, c: ht.linalg.solve_triangular(
        ht.array(d["upper"].T.copy(), split=1), ht.array(d["B"], split=0), lower=True),
    "solve_native_split0": lambda ht, d, c: ht.linalg.solve_triangular(ht.array(d["upper"], split=0),
                                                                       ht.array(d["B"]), blocked=False),
    "mask_rank1_rows_only": lambda ht, d, c: (lambda x: x[x > 25])(ht.array(d["rows"], split=0)),
    "mask_numpy_alternate": lambda ht, d, c: ht.array(d["X"], split=0)[np.arange(M) % 2 == 0],
    "mask_replicated_dndarray": lambda ht, d, c: ht.array(d["X"], split=0)[ht.array(d["rows"] % 3 == 1)],
    "mask_of_values": lambda ht, d, c: (lambda x: x[x > 0.5])(ht.array(d["X"], split=0)),
    "tiles_square_diag": _tiles,
    "tiles_split": _split_tiles,
}
TWO_DEVICE = ("tiles_square_diag", "tiles_split")


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
                res[name] = _encode(fn(ht, d, None))
            except Exception as e:  # recorded per case, so one fault fails one test
                res[name] = {"error": f"{type(e).__name__}: {e}"}
        (pathlib.Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(res))
    finally:
        ht.core.bootstrap.finalize_distributed()


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("linalg_mp")
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
    """Each case through the reference (8 devices; 2 for the tile views) and
    the port at world size 1."""
    import jax
    from jax.sharding import Mesh

    import heat_tpu
    import heat_tpu_torch as htt

    two = heat_tpu.core.communication.Communication(Mesh(np.asarray(jax.devices()[:2]), ("x",)), "x")
    prev = htt.get_device()
    htt.use_device("cpu")
    try:
        d, ref, one = _data(), {}, {}
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            for name, fn in CASES.items():
                ref[name] = _ref_encode(fn(heat_tpu, d, two if name in TWO_DEVICE else None))
                if name not in TWO_DEVICE:  # the tile views of one rank are another algebra
                    one[name] = _encode(fn(htt, d, None))
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


def _canonical(name, res):
    """Factors with their sign freedom fixed: QR's R diagonal positive (Q's
    columns with it), each V column's largest entry positive (U's with it)."""
    if not isinstance(res, list) or any("error" in r for r in res if isinstance(r, dict)):
        return res
    vals = [np.asarray(r["value"]) if "value" in r else None for r in res]
    if name.startswith(("qr", "tsqr")):
        r = vals[-1]
        d = np.sign(np.diag(r))
        vals[-1] = r * d[:, None] if r.shape[0] == d.shape[0] else np.vstack([r[: len(d)] * d[:, None], r[len(d):]])
        if len(vals) == 2:
            vals[0] = vals[0][:, : len(d)] * d
    elif name.startswith(("svd", "hsvd")) and len(vals) == 3:
        u, v = vals[0], vals[2]
        d = np.sign(v[np.argmax(np.abs(v), axis=0), np.arange(v.shape[1])])
        vals[0], vals[2] = u * d, v * d
    return [dict(r, value=v.tolist()) if v is not None else r for r, v in zip(res, vals)]


def _hold(got, want, name):
    if isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), name
        for g, w in zip(got, want):
            _hold(g, w, name)
        return
    assert "error" not in got, f"{name}: {got.get('error')}"
    if "scalar" in want:
        assert got["scalar"] == want["scalar"], name
        return
    assert (got["dtype"], got["shape"], got["split"]) == (want["dtype"], want["shape"], want["split"]), name
    g, w = np.asarray(got["value"]), np.asarray(want["value"])
    if w.dtype.kind in "biu" or name.startswith(("mask", "tiles")):
        np.testing.assert_array_equal(g, w, err_msg=name)
    elif name.startswith(("cdist_", "manhattan", "rbf_0")) and "ring" not in name and "expansion" not in name:
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6, err_msg=name)
    else:
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4 * max(float(np.abs(w).max()), 1.0), err_msg=name)


@pytest.mark.parametrize("name", list(CASES))
def test_two_ranks_match_reference_and_world_one(name, two_ranks, references):
    ref, one = references
    want = _canonical(name, ref[name])
    for rank, res in enumerate(two_ranks):
        got = _canonical(name, res[name])
        _hold(got, want, f"{name} (rank {rank} vs reference)")
        if name in one:
            _hold(got, _canonical(name, one[name]), f"{name} (rank {rank} vs world 1)")


def test_results_follow_the_ranks_rows(two_ranks):
    """A split-0 distance matrix holds this rank's rows of x (19 | 18), a
    split-1 one its rows of y as columns (16 | 15); TSQR's Q follows a's
    rows; the mask selecting rows 26.. selects none on rank 0."""
    assert [r["cdist_0_None"]["lshape"] for r in two_ranks] == [[19, 31], [18, 31]]
    assert [r["cdist_None_0"]["lshape"] for r in two_ranks] == [[M, 16], [M, 15]]
    assert [r["cdist_ring_0_0"]["lshape"] for r in two_ranks] == [[19, 31], [18, 31]]
    assert [r["qr_split0"][0]["lshape"] for r in two_ranks] == [[19, N], [18, N]]
    assert [r["mask_rank1_rows_only"]["lshape"] for r in two_ranks] == [[0], [11]]
