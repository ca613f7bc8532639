"""heat_tpu_torch on three gloo processes: parallel I/O, the array checkpoint
across world sizes, the halo convolution, fft along the split axis, the
sparse product, ``ring_map``, ``vmap`` and DASO's checkpoint and resume.

One module-scoped spawn of 3 ranks (``torch.multiprocessing``, spawn) runs
every case of ``CASES`` on HeAT's uneven chunks (13 rows: 5, 4, 4; a
7-sample signal: 3, 2, 2, shorter than a 5-tap filter's halo of 4) and
saves the gathered global result, its dtype and split.  Each case is one
test here, held against the port at world size 1 and, where the reference
has the operation, against heat_tpu on its 8-device CPU mesh: I/O and data
movement exactly, float32 arithmetic within 1e-5 of the largest entry
(another order of the same sums), dtype and split exactly.  Files the
ranks write are also read here at world size 1 and by the reference; the
array checkpoint written by 3 ranks is read by 2 (a ``Split`` of the
world) and by 1.  DASO with 3 groups checkpoints at step 3, a fresh DASO
resumes, and its next 2 steps equal the uninterrupted run's bit for bit.

This module imports neither JAX nor heat_tpu at the top: the spawned
workers import it and need only torch.
"""

import json
import os
import pathlib
import socket
import warnings

import numpy as np
import pytest
import torch

P = 3


def _data():
    rng = np.random.default_rng(61)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    dense = f(13, 9) * (rng.random((13, 9)) < 0.35)
    return {"X": f(13, 5), "I": rng.integers(-99, 99, (13, 5)).astype(np.int32), "sig": f(7), "long": f(40),
            "ker": f(5), "ker7": f(7), "M": f(13, 6), "S": dense.astype(np.float32), "D": f(9, 4),
            "C": (f(13, 6) + 1j * f(13, 6)).astype(np.complex64)}


def _io_case(ext, split, which):
    def run(ht, d, out):
        arr = d[which]
        path = os.path.join(out, f"{which}_{split}{ext}")
        args = ("data",) if ext in (".h5", ".nc") else ()
        ht.save(ht.array(arr, split=split), path, *args)
        kw = {"dtype": ht.int32} if which == "I" and ext != ".zarr" else {}
        return ht.load(path, *args, split=split, **kw)
    return run


def _checkpoint_case(ht, d, out):
    path = os.path.join(out, "ck3")
    ht.save_array_checkpoint(ht.array(d["X"], split=0), path, keep_versions=2)
    ht.save_array_checkpoint(ht.array(d["X"] * 2, split=0), path, keep_versions=2)
    return ht.load_array_checkpoint(path)


def _checkpoint_at_two(ht, d, out):
    comm = ht.get_comm()
    sub = comm.Split(0 if comm.rank < 2 else 1)
    x = ht.load_array_checkpoint(os.path.join(out, "ck3"), comm=sub)
    assert x.comm.size == (2 if comm.rank < 2 else 1) and x.split == 0
    return x.numpy()


def _checkpoint_fallback(ht, d, out):
    comm = ht.get_comm()
    path = os.path.join(out, "ck_bad")
    ht.save_array_checkpoint(ht.array(d["X"], split=0), path, keep_versions=2)
    ht.save_array_checkpoint(ht.array(d["X"] + 1, split=0), path, keep_versions=2)
    comm.Barrier()
    if comm.rank == 0:
        chunk = os.path.join(path, "v1", "chunk_5.npy")  # rank 1's chunk: verified on rank 1
        raw = bytearray(open(chunk, "rb").read())
        raw[-1] ^= 0xFF
        open(chunk, "wb").write(bytes(raw))
    comm.Barrier()
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        x = ht.load_array_checkpoint(path)
    assert any("falling back to v0" in str(m.message) for m in w)
    return x


def _convolve_case(sig, ker, mode):
    return lambda ht, d, out: ht.convolve(ht.array(d[sig], split=0), ht.array(d[ker]), mode=mode)


def _ring_concat(ht, d, out):
    x = ht.array(d["X"], split=0)
    return ht.parallel.ring_map(lambda a, b, src: a @ b.T, x, x)


def _ring_sum(ht, d, out):
    x = ht.array(d["X"], split=0)
    return ht.parallel.ring_map(lambda a, b, src: a * b.sum(), x, x, combine="sum")


def _ring_src(ht, d, out):
    """Each block of the result holds the index the step was given."""
    x = ht.array(d["X"], split=0)
    return ht.parallel.ring_map(lambda a, b, src: torch.full((a.shape[0], b.shape[0]), float(src)), x, x)


def _fft_routes(ht, d, out):
    """The routes a transform along the split axis takes: the transpose
    method where an axis is free, the gather where none is."""
    import importlib

    paths = importlib.import_module("heat_tpu_torch.fft.fft").fft_paths
    for key in paths:
        paths[key] = 0
    ht.fft.fft(ht.array(d["C"], split=0), axis=0)
    ht.fft.fft(ht.array(d["long"], split=0))
    ht.fft.fft(ht.array(d["C"], split=0), axis=1)
    return np.array([paths["transpose"], paths["gather"], paths["direct"]])


def _daso(ht, d, out, interrupt):
    comm = ht.get_comm()
    torch.manual_seed(3)
    rng = np.random.default_rng(5 + comm.rank)
    xs = [torch.from_numpy(rng.standard_normal((6, 5)).astype(np.float32)) for _ in range(5)]
    ys = [torch.from_numpy(rng.integers(0, 3, 6)) for _ in range(5)]
    ckpt = os.path.join(out, "daso_b" if interrupt else "daso_a")

    def build(seed):
        torch.manual_seed(seed)
        model = torch.nn.Sequential(torch.nn.Linear(5, 6), torch.nn.ReLU(), torch.nn.Linear(6, 3))
        daso = ht.optim.DASO(ht.optim.DataParallelOptimizer("adam", lr=0.01), total_local_comm_size=1,
                             warmup_steps=1, global_skip=2, stale_steps=1,
                             checkpoint_every=3 if interrupt else None, checkpoint_dir=ckpt)
        daso.init(model)
        return daso

    daso = build(3)
    losses, params = [], []
    for t in range(5):
        if interrupt and t == 3:
            daso = build(99)
            assert daso.resume()
        losses.append(float(daso.step(torch.nn.functional.cross_entropy, xs[t], ys[t])))
        params.append(np.concatenate([p.detach().numpy().ravel() for p in daso.parameters]))
    rows = torch.from_numpy(np.concatenate([np.asarray(losses, np.float32), params[-1], params[-2]])[None])
    return ht.array(rows, is_split=0)


CASES = {
    **{f"io_{ext[1:]}_{which}_{split}": _io_case(ext, split, which)
       for ext in (".npy", ".csv", ".h5", ".nc", ".zarr") for split in (None, 0, 1) for which in ("X", "I")},
    "checkpoint_written_at_3": _checkpoint_case,
    "checkpoint_read_at_2": _checkpoint_at_two,
    "checkpoint_fallback": _checkpoint_fallback,
    **{f"convolve_{sig}_{mode}": _convolve_case(sig, ker, mode)
       for sig, ker in (("sig", "ker"), ("long", "ker7")) for mode in ("full", "same", "valid")},
    "convolve_swapped": lambda ht, d, out: ht.convolve(ht.array(d["ker"], split=0), ht.array(d["long"]), "same"),
    "correlate_short": lambda ht, d, out: ht.correlate(ht.array(d["sig"], split=0), ht.array(d["ker"]), "full"),
    "convolve2d_split0": lambda ht, d, out: ht.convolve2d(ht.array(d["M"], split=0), ht.array(d["X"][:4, :3]),
                                                          "same"),
    "fft_split_axis": lambda ht, d, out: ht.fft.fft(ht.array(d["C"], split=0), axis=0),
    "rfft2_split1": lambda ht, d, out: ht.fft.rfft2(ht.array(d["M"], split=1)),
    "ifftn_all_axes": lambda ht, d, out: ht.fft.ifftn(ht.array(d["C"], split=0)),
    "fft_1d_gathered": lambda ht, d, out: ht.fft.fft(ht.array(d["long"], split=0)),
    "fftshift_split": lambda ht, d, out: ht.fft.fftshift(ht.array(d["M"], split=0)),
    "fft_routes": _fft_routes,
    "sparse_matmul_dense_none": lambda ht, d, out: ht.sparse.sparse_csr_matrix(d["S"], split=0) @ ht.array(d["D"]),
    "sparse_matmul_dense_split1": lambda ht, d, out: ht.sparse.matmul(ht.sparse.sparse_csr_matrix(d["S"], split=0),
                                                                      ht.array(d["D"], split=1)),
    "sparse_matmul_vector": lambda ht, d, out: ht.sparse.sparse_csr_matrix(d["S"], split=0) @ ht.array(d["D"][:, 0],
                                                                                                        split=0),
    "sparse_add": lambda ht, d, out: ht.sparse.add(ht.sparse.sparse_csr_matrix(d["S"], split=0),
                                                   ht.sparse.sparse_csr_matrix(d["S"] * 2, split=0)).todense(),
    "sparse_transpose": lambda ht, d, out: ht.sparse.transpose(
        ht.sparse.to_sparse(ht.array(d["S"], split=0))).todense(),
    "ring_map_concat": _ring_concat,
    "ring_map_sum": _ring_sum,
    "ring_map_src": _ring_src,
    "vmap_split0": lambda ht, d, out: ht.vmap(lambda r: ht.exp(r) - ht.sum(r))(ht.array(d["X"], split=0)),
    "vmap_split1": lambda ht, d, out: ht.vmap(lambda r: r * 2.0)(ht.array(d["X"], split=1)),
    "daso_uninterrupted": lambda ht, d, out: _daso(ht, d, out, False),
    "daso_resumed": lambda ht, d, out: _daso(ht, d, out, True),
}


def _encode(ht, r):
    if isinstance(r, ht.sparse.DCSR_matrix):
        r = r.todense()
    if isinstance(r, ht.DNDarray):
        return r.numpy(), {"dtype": r.dtype.__name__, "split": r.split, "shape": list(r.shape)}
    return np.asarray(r), {}


def _worker(rank, port, out_dir):
    import heat_tpu_torch as ht

    ht.core.bootstrap.init_distributed(f"tcp://localhost:{port}", world_size=P, rank=rank, backend="gloo",
                                       timeout_s=90)
    warnings.simplefilter("ignore")
    try:
        ht.use_device("cpu")
        d, arrays, meta = _data(), {}, {}
        files = os.path.join(out_dir, "files")
        if rank == 0:
            os.makedirs(files, exist_ok=True)
        ht.get_comm().Barrier()
        for name, fn in CASES.items():
            try:
                arr, info = _encode(ht, fn(ht, d, files))
                arrays[name] = arr
                meta[name] = info
            except Exception as e:  # recorded per case, so one fault fails one test
                meta[name] = {"error": f"{type(e).__name__}: {e}"}
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **arrays)
        (pathlib.Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(meta))
    finally:
        ht.core.bootstrap.finalize_distributed()


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def three_ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("io_mp")
    ctx = torch.multiprocessing.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_worker, args=(r, port, str(out))) for r in range(P)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=300)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(5)
    assert [p.exitcode for p in procs] == [0] * P
    ranks = [(dict(np.load(out / f"rank{r}.npz")), json.loads((out / f"rank{r}.json").read_text()))
             for r in range(P)]
    return out, ranks


@pytest.fixture(scope="module")
def world_one(tmp_path_factory):
    """Each case through the port at world size 1."""
    import heat_tpu_torch as htt

    out = tmp_path_factory.mktemp("io_w1")
    prev = htt.get_device()
    htt.use_device("cpu")
    res = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        try:
            for name, fn in CASES.items():
                if name.startswith(("checkpoint_read", "checkpoint_fallback", "daso")):
                    continue
                res[name] = _encode(htt, fn(htt, _data(), str(out)))
        finally:
            htt.use_device(prev)
    return res


TOL = 1e-5
EXACT = ("io_", "checkpoint", "vmap_split1", "sparse_add", "sparse_transpose", "fftshift")


def _hold(got, want, name):
    if name.startswith(EXACT):
        np.testing.assert_array_equal(got, want)
    else:
        scale = max(float(np.abs(want).max()), 1e-30)
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * scale)


@pytest.mark.parametrize("name", [n for n in CASES if not n.startswith(("daso", "checkpoint_read",
                                                                         "checkpoint_fallback", "ring_map_src",
                                                                         "fft_routes"))])
def test_three_ranks_match_world_one(name, three_ranks, world_one):
    _, ranks = three_ranks
    want, info = world_one[name]
    for arrays, meta in ranks:
        assert "error" not in meta[name], meta[name]
        _hold(arrays[name], want, name)
        assert meta[name] == info, (meta[name], info)


@pytest.mark.parametrize("fmt", ["npy", "csv", "h5", "nc", "zarr"])
@pytest.mark.parametrize("split", [None, 0, 1])
def test_files_written_by_three_ranks_load_at_world_one_and_in_the_reference(fmt, split, three_ranks):
    import heat_tpu
    import heat_tpu_torch as htt

    out, _ = three_ranks
    d = _data()
    for which in ("X", "I"):
        path = str(out / "files" / f"{which}_{split}.{fmt}")
        args = ("data",) if fmt in ("h5", "nc") else ()
        kw = which == "I" and fmt != "zarr"
        ref = heat_tpu.load(path, *args, split=split, **({"dtype": heat_tpu.int32} if kw else {}))
        np.testing.assert_array_equal(ref.numpy(), d[which])
        prev = htt.get_device()
        htt.use_device("cpu")
        try:
            got = htt.load(path, *args, split=split, **({"dtype": htt.int32} if kw else {}))
        finally:
            htt.use_device(prev)
        np.testing.assert_array_equal(got.numpy(), d[which])
        assert got.split == ref.split == split and got.dtype.__name__ == ref.dtype.__name__


def test_ring_map_passes_the_global_block_index(three_ranks):
    _, ranks = three_ranks
    want = np.repeat(np.repeat(np.arange(P, dtype=np.float32)[None], 13, 0), [5, 4, 4], axis=1)
    for arrays, meta in ranks:
        assert "error" not in meta["ring_map_src"], meta["ring_map_src"]
        np.testing.assert_array_equal(arrays["ring_map_src"], want)
        assert meta["ring_map_src"]["split"] == 0


def test_fft_along_the_split_axis_moves_the_split_and_gathers_only_without_a_free_axis(three_ranks):
    _, ranks = three_ranks
    for arrays, meta in ranks:
        assert "error" not in meta["fft_routes"], meta["fft_routes"]
        np.testing.assert_array_equal(arrays["fft_routes"], [1, 1, 1])


def test_checkpoint_written_at_three_loads_at_two_and_one(three_ranks):
    import heat_tpu
    import heat_tpu_torch as htt

    out, ranks = three_ranks
    d = _data()
    for arrays, meta in ranks:
        assert "error" not in meta["checkpoint_read_at_2"], meta["checkpoint_read_at_2"]
        np.testing.assert_array_equal(arrays["checkpoint_read_at_2"], d["X"] * 2)
    path = str(out / "files" / "ck3")
    assert sorted(os.listdir(path)) == ["LATEST", "v0", "v1"]
    assert sorted(json.load(open(os.path.join(path, "v1", "meta.json")))["starts"]) == [0, 5, 9]
    prev = htt.get_device()
    htt.use_device("cpu")
    try:
        np.testing.assert_array_equal(htt.load_array_checkpoint(path).numpy(), d["X"] * 2)
    finally:
        htt.use_device(prev)
    np.testing.assert_array_equal(heat_tpu.load_array_checkpoint(path).numpy(), d["X"] * 2)


def test_corrupt_chunk_falls_back_on_every_rank(three_ranks):
    _, ranks = three_ranks
    for arrays, meta in ranks:
        assert "error" not in meta["checkpoint_fallback"], meta["checkpoint_fallback"]
        np.testing.assert_array_equal(arrays["checkpoint_fallback"], _data()["X"])


def test_daso_resume_is_bit_identical(three_ranks):
    out, ranks = three_ranks
    for arrays, meta in ranks:
        for name in ("daso_uninterrupted", "daso_resumed"):
            assert "error" not in meta[name], meta[name]
        np.testing.assert_array_equal(arrays["daso_resumed"], arrays["daso_uninterrupted"])
    m = json.load(open(out / "files" / "daso_b" / "daso_state.meta.json"))
    assert (m["step"], m["n_groups"], m["ici"], m["devices"]) == (3, 3, 1, 3)
    # the three groups really differ: each rank's losses are its own
    assert not np.array_equal(ranks[0][0]["daso_uninterrupted"][0, :5], ranks[0][0]["daso_uninterrupted"][1, :5])


def test_reference_agrees_on_the_distributed_results(three_ranks):
    """The cases the reference has, against heat_tpu on its 8-device mesh."""
    import heat_tpu

    _, ranks = three_ranks
    d = _data()
    arrays = ranks[0][0]
    h = heat_tpu
    want = {
        "convolve_sig_full": h.convolve(h.array(d["sig"], split=0), h.array(d["ker"]), "full"),
        "convolve_long_same": h.convolve(h.array(d["long"], split=0), h.array(d["ker7"]), "same"),
        "convolve_swapped": h.convolve(h.array(d["ker"], split=0), h.array(d["long"]), "same"),
        "fft_split_axis": h.fft.fft(h.array(d["C"]), axis=0),
        "rfft2_split1": h.fft.rfft2(h.array(d["M"])),
        "sparse_matmul_dense_none": h.sparse.sparse_csr_matrix(d["S"], split=0) @ h.array(d["D"]),
    }
    for name, w in want.items():
        _hold(arrays[name], w.numpy(), name)
