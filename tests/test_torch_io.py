"""heat_tpu_torch's parallel I/O against heat_tpu, across the two packages.

At world size 1 on the CPU; the reference writes and reads on its
8-device CPU mesh (so its zarr chunks and array-checkpoint chunks follow
its padded grid).  Every file one package writes loads in the other to the
same values, dtype and split, exactly (every format holds the float32 and
int32 bits; CSV writes enough digits to read back the same bits).  Also:
the zarr ``.zarray`` and checkpoint ``meta.json`` keys are the reference's,
the checkpoint's corruption fallback, ``keep_versions`` and
``CheckpointCorruptionError``, ``load_fraction``, ``PartialH5Dataset``, the
retry schedule, and DASO's checkpoint and resume (the resumed steps equal
the uninterrupted ones bit for bit).
"""

import json
import os
import warnings

import numpy as np
import pytest
import torch

import heat_tpu
import heat_tpu_torch as htt

RNG = np.random.default_rng(16)
X = RNG.standard_normal((13, 5)).astype(np.float32)
I = RNG.integers(-1000, 1000, (13, 5)).astype(np.int32)
V = RNG.standard_normal(11).astype(np.float32)


@pytest.fixture(autouse=True)
def on_cpu():
    prev = htt.get_device()
    htt.use_device("cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        yield
    htt.use_device(prev)


def same(got, want, split):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.split == split
    assert got.dtype.__name__ == heat_tpu.array(np.asarray(want)).dtype.__name__


FORMATS = [("npy", ".npy", ()), ("csv", ".csv", ()), ("hdf5", ".h5", ("data",)), ("netcdf", ".nc", ("data",)),
           ("zarr", ".zarr", ())]


def _load_kw(fmt, arr):
    kw = {}
    if fmt in ("npy", "csv", "hdf5", "netcdf") and arr.dtype == np.int32:
        kw["dtype"] = "int32"
    return kw


@pytest.mark.parametrize("fmt,ext,args", FORMATS)
@pytest.mark.parametrize("split", [None, 0, 1])
@pytest.mark.parametrize("which", ["float", "int"])
def test_reference_file_loads_in_the_port(fmt, ext, args, split, which, tmp_path):
    arr = X if which == "float" else I
    path = str(tmp_path / f"a{ext}")
    heat_tpu.save(heat_tpu.array(arr, split=split), path, *args)
    kw = _load_kw(fmt, arr)
    got = htt.load(path, *args, split=split, **{k: getattr(htt, v) for k, v in kw.items()})
    want = heat_tpu.load(path, *args, split=split, **{k: getattr(heat_tpu, v) for k, v in kw.items()})
    same(got, want.numpy(), want.split)
    np.testing.assert_array_equal(got.numpy(), arr)


@pytest.mark.parametrize("fmt,ext,args", FORMATS)
@pytest.mark.parametrize("split", [None, 0, 1])
@pytest.mark.parametrize("which", ["float", "int"])
def test_port_file_loads_in_the_reference(fmt, ext, args, split, which, tmp_path):
    arr = X if which == "float" else I
    path = str(tmp_path / f"a{ext}")
    htt.save(htt.array(arr, split=split), path, *args)
    kw = _load_kw(fmt, arr)
    want = heat_tpu.load(path, *args, split=split, **{k: getattr(heat_tpu, v) for k, v in kw.items()})
    np.testing.assert_array_equal(want.numpy(), arr)
    got = htt.load(path, *args, split=split, **{k: getattr(htt, v) for k, v in kw.items()})
    same(got, want.numpy(), want.split)


@pytest.mark.parametrize("split", [None, 0])
def test_one_dimensional_csv_and_header_lines(split, tmp_path):
    path = str(tmp_path / "v.csv")
    htt.save_csv(htt.array(V, split=split), path, header_lines=["# a header", "# two lines"])
    got = htt.load_csv(path, header_lines=2, split=split)
    want = heat_tpu.load_csv(path, header_lines=2, split=split)
    same(got, want.numpy(), want.split)
    np.testing.assert_array_equal(got.numpy(), V)


def test_csv_decimals_and_separator_match_the_reference(tmp_path):
    a, b = str(tmp_path / "a.csv"), str(tmp_path / "b.csv")
    htt.save_csv(htt.array(X), a, sep=";", decimals=3)
    heat_tpu.save_csv(heat_tpu.array(X), b, sep=";", decimals=3)
    np.testing.assert_array_equal(htt.load_csv(a, sep=";").numpy(), heat_tpu.load_csv(b, sep=";").numpy())


def test_npy_directory_concatenates_sorted_files(tmp_path):
    d = tmp_path / "parts"
    d.mkdir()
    np.save(d / "b.npy", X[7:])
    np.save(d / "a.npy", X[:7])
    got = htt.load_npy_from_path(str(d), split=0)
    want = heat_tpu.load_npy_from_path(str(d), split=0)
    same(got, want.numpy(), want.split)


def test_load_fraction_keeps_the_leading_rows(tmp_path):
    path = str(tmp_path / "a.h5")
    heat_tpu.save_hdf5(heat_tpu.array(X), path, "data")
    got = htt.load_hdf5(path, "data", load_fraction=0.5, split=0)
    want = heat_tpu.load_hdf5(path, "data", load_fraction=0.5, split=0)
    same(got, want.numpy(), want.split)
    assert got.shape == (6, 5)


def test_zarr_descriptor_has_the_references_keys(tmp_path):
    a, b = str(tmp_path / "a.zarr"), str(tmp_path / "b.zarr")
    htt.save_zarr(htt.array(X, split=0), a)
    heat_tpu.save_zarr(heat_tpu.array(X, split=0), b)
    ma = json.load(open(os.path.join(a, ".zarray")))
    mb = json.load(open(os.path.join(b, ".zarray")))
    assert sorted(ma) == sorted(mb)
    assert {k: ma[k] for k in ma if k != "chunks"} == {k: mb[k] for k in mb if k != "chunks"}


def test_netcdf_dimension_scales_are_attached(tmp_path):
    import h5py

    path = str(tmp_path / "a.nc")
    htt.save_netcdf(htt.array(X, split=0), path, "data", dimension_names=["rows", "cols"])
    with h5py.File(path, "r") as f:
        assert [d[0].name for d in f["data"].dims] == ["/rows", "/cols"]
    with pytest.raises(ValueError):
        htt.save_netcdf(htt.array(X[:4]), path, "data", mode="a", dimension_names=["rows", "cols"])


@pytest.mark.parametrize("split", [None, 0, 1])
def test_array_checkpoint_crosses_packages(split, tmp_path):
    a, b = str(tmp_path / "port"), str(tmp_path / "ref")
    htt.save_array_checkpoint(htt.array(X, split=split), a)
    heat_tpu.save_array_checkpoint(heat_tpu.array(X, split=split), b)
    want = heat_tpu.load_array_checkpoint(a)
    np.testing.assert_array_equal(want.numpy(), X)
    assert want.split == split
    got = htt.load_array_checkpoint(b)
    same(got, X, split)
    ma = json.load(open(os.path.join(a, "v0", "meta.json")))
    mb = json.load(open(os.path.join(b, "v0", "meta.json")))
    assert sorted(ma) == sorted(mb)
    assert (ma["gshape"], ma["dtype"], ma["split"]) == (mb["gshape"], mb["dtype"], mb["split"])


def test_array_checkpoint_falls_back_to_the_previous_version(tmp_path):
    d = str(tmp_path / "ck")
    htt.save_array_checkpoint(htt.array(X, split=0), d, keep_versions=2)
    htt.save_array_checkpoint(htt.array(X + 1, split=0), d, keep_versions=2)
    assert sorted(os.listdir(d)) == ["LATEST", "v0", "v1"]
    np.testing.assert_array_equal(htt.load_array_checkpoint(d).numpy(), X + 1)
    chunk = os.path.join(d, "v1", "chunk_0.npy")
    raw = bytearray(open(chunk, "rb").read())
    raw[-3] ^= 0xFF
    open(chunk, "wb").write(bytes(raw))
    with pytest.warns(UserWarning, match="falling back to v0"):
        got = htt.load_array_checkpoint(d)
    np.testing.assert_array_equal(got.numpy(), X)
    ref = heat_tpu.load_array_checkpoint(d)  # the reference makes the same choice
    np.testing.assert_array_equal(ref.numpy(), X)


def test_keep_versions_prunes_and_corruption_everywhere_raises(tmp_path):
    d = str(tmp_path / "ck")
    for k in range(4):
        htt.save_array_checkpoint(htt.array(X * k, split=0), d, keep_versions=2)
    assert sorted(os.listdir(d)) == ["LATEST", "v2", "v3"]
    for v in ("v2", "v3"):
        os.remove(os.path.join(d, v, "chunk_0.npy"))
    with pytest.raises(htt.CheckpointCorruptionError, match="missing chunk files"):
        htt.load_array_checkpoint(d)
    with pytest.raises(heat_tpu.CheckpointCorruptionError):
        heat_tpu.load_array_checkpoint(d)


def test_truncated_chunk_raises(tmp_path):
    d = str(tmp_path / "ck")
    htt.save_array_checkpoint(htt.array(X, split=0), d)
    chunk = os.path.join(d, "v0", "chunk_0.npy")
    raw = open(chunk, "rb").read()
    open(chunk, "wb").write(raw[:-8])
    with pytest.raises(htt.CheckpointCorruptionError, match="truncated"):
        htt.load_array_checkpoint(d)


def _tree(lib):
    if lib is heat_tpu:
        import jax.numpy as jnp

        arr = jnp.asarray
    else:
        arr = torch.from_numpy
    return {"layer": {"w": arr(X), "b": arr(V)}, "steps": [arr(I[0]), arr(I[1])], "a": {"z": arr(X[0])}}


def test_pytree_checkpoint_crosses_packages(tmp_path):
    a, b = str(tmp_path / "port.npz"), str(tmp_path / "ref.npz")
    htt.save_checkpoint(_tree(htt), a)
    heat_tpu.save_checkpoint(_tree(heat_tpu), b)
    assert json.loads(str(np.load(a)["__keys__"])) == json.loads(str(np.load(b)["__keys__"]))
    got = htt.load_checkpoint(_tree(htt), b)
    want = heat_tpu.load_checkpoint(_tree(heat_tpu), a)
    np.testing.assert_array_equal(got["layer"]["w"].numpy(), X)
    np.testing.assert_array_equal(np.asarray(want["layer"]["w"]), X)
    np.testing.assert_array_equal(got["steps"][1].numpy(), I[1])
    assert isinstance(got["steps"], list) and got["a"]["z"].dtype == torch.float32


def test_pytree_checkpoint_of_a_module_and_its_optimizer(tmp_path):
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(5, 4), torch.nn.BatchNorm1d(4), torch.nn.Linear(4, 2))
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    model(torch.from_numpy(X)).sum().backward()
    opt.step()
    tree = {"model": model.state_dict(), "opt": opt.state_dict()}
    path = str(tmp_path / "m")
    htt.save_checkpoint(tree, path)
    fresh = {"model": model.state_dict(), "opt": opt.state_dict()}
    back = htt.load_checkpoint(fresh, path)
    for k, v in tree["model"].items():
        assert torch.equal(back["model"][k], v)
    assert back["opt"]["param_groups"][0]["lr"] == 1e-2
    assert torch.equal(back["opt"]["state"][0]["exp_avg"], tree["opt"]["state"][0]["exp_avg"])
    reshaped = model.state_dict()
    reshaped["0.weight"] = torch.zeros(3, 3)
    with pytest.raises(ValueError, match="shape"):
        htt.load_checkpoint({"model": reshaped, "opt": fresh["opt"]}, path)


def test_pytree_checkpoint_corruption_and_structure_errors(tmp_path):
    path = str(tmp_path / "t.npz")
    htt.save_checkpoint({"a": torch.ones(3)}, path)
    with pytest.raises(ValueError, match="structure"):
        htt.load_checkpoint({"b": torch.ones(3)}, path)
    raw = open(path, "rb").read()
    open(path, "wb").write(raw[:40])
    with pytest.raises(htt.CheckpointCorruptionError):
        htt.load_checkpoint({"a": torch.ones(3)}, path)
    with pytest.raises(FileNotFoundError):
        htt.load_checkpoint({"a": torch.ones(3)}, str(tmp_path / "none"))


def test_partial_h5_dataset_streams_blocks(tmp_path):
    import h5py

    path = str(tmp_path / "p.h5")
    with h5py.File(path, "w") as f:
        f["data"] = X
        f["labels"] = I[:, 0]
    ds = htt.utils.data.PartialH5Dataset(path, dataset_names=["data", "labels"], initial_load=5)
    ref = heat_tpu.utils.data.PartialH5Dataset(path, dataset_names=["data", "labels"], initial_load=5)
    got, want = list(ds), list(ref)
    assert len(ds) == 13 and len(got) == len(want) == 3
    for g, w in zip(got, want):
        for n in ("data", "labels"):
            np.testing.assert_array_equal(g[n].numpy(), w[n].numpy())
            assert g[n].split == w[n].split == 0
    first = next(iter(htt.utils.data.PartialH5Dataset(path, initial_load=4)))  # abandoned early
    np.testing.assert_array_equal(first.numpy(), X[:4])


def test_retry_schedule_is_the_references():
    from heat_tpu.utils import faults as ref_faults
    from heat_tpu_torch.utils import faults

    assert list(faults.backoff_schedule(5, 0.02, 2.0, 0.5, 0.5, site="io.write")) == \
        list(ref_faults.backoff_schedule(5, 0.02, 2.0, 0.5, 0.5, site="io.write"))
    calls, slept = [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise faults.TransientFault("flaky disk")
        return "done"

    faults.reset_retry_counts()
    assert faults.call_with_retries(flaky, "io.write", sleep=slept.append) == "done"
    assert len(calls) == 3 and len(slept) == 2
    assert faults.retry_counts() == {"retry.io.write": 2}
    with pytest.raises(FileNotFoundError):
        faults.call_with_retries(lambda: open("/nonexistent/x"), "io.read", sleep=slept.append,
                                 retry_if=lambda e: not isinstance(e, FileNotFoundError))


def test_supports_flags():
    assert htt.supports_hdf5() is heat_tpu.supports_hdf5()
    assert htt.supports_netcdf() is heat_tpu.supports_netcdf()


def _daso_run(ckpt_dir, interrupt):
    """Five DASO steps at world size 1 (2 warmup steps, a skip of 2, one
    stale step); with ``interrupt`` the optimizer checkpoints at step 3 and
    a fresh one resumes.  Returns the losses and parameters after each step."""
    torch.manual_seed(3)
    rng = np.random.default_rng(5)
    xs = [torch.from_numpy(rng.standard_normal((8, 5)).astype(np.float32)) for _ in range(5)]
    ys = [torch.from_numpy(rng.integers(0, 3, 8)) for _ in range(5)]

    def build():
        model = torch.nn.Sequential(torch.nn.Linear(5, 6), torch.nn.ReLU(), torch.nn.Linear(6, 3))
        daso = htt.optim.DASO(htt.optim.DataParallelOptimizer("adam", lr=0.01), total_local_comm_size=1,
                              warmup_steps=2, global_skip=2, stale_steps=1,
                              checkpoint_every=3 if interrupt else None, checkpoint_dir=ckpt_dir)
        daso.init(model)
        return daso

    loss_fn = torch.nn.functional.cross_entropy
    daso = build()
    out = []
    for t in range(5):
        if interrupt and t == 3:
            torch.manual_seed(99)  # a fresh optimizer over other weights
            daso = build()
            assert daso.resume()
        loss = daso.step(loss_fn, xs[t], ys[t])
        out.append((float(loss), [p.detach().clone() for p in daso.parameters]))
    return out


def test_daso_resumes_bit_identical(tmp_path):
    plain = _daso_run(str(tmp_path / "a"), False)
    resumed = _daso_run(str(tmp_path / "b"), True)
    assert os.path.exists(tmp_path / "b" / "daso_state.npz")
    meta = json.load(open(tmp_path / "b" / "daso_state.meta.json"))
    assert (meta["step"], meta["n_groups"], meta["ici"], meta["devices"]) == (3, 1, 1, 1)
    for (la, pa), (lb, pb) in zip(plain, resumed):
        assert la == lb
        assert all(torch.equal(a, b) for a, b in zip(pa, pb))


def test_daso_resume_checks_the_world_and_falls_back(tmp_path):
    d = str(tmp_path / "ck")
    model = torch.nn.Linear(3, 2)
    daso = htt.optim.DASO(htt.optim.DataParallelOptimizer("sgd", lr=0.1), total_local_comm_size=1,
                          checkpoint_dir=d)
    assert daso.init(model) is model and daso.resume() is False
    daso.step(torch.nn.functional.mse_loss, torch.ones(4, 3), torch.zeros(4, 2))
    daso.checkpoint()
    w1 = model.weight.detach().clone()
    daso.step(torch.nn.functional.mse_loss, torch.ones(4, 3), torch.zeros(4, 2))
    daso.checkpoint()
    assert os.path.exists(os.path.join(d, "daso_state.prev.npz"))
    open(os.path.join(d, "daso_state.npz"), "wb").write(b"torn")
    with pytest.warns(UserWarning, match="falling back"):
        assert daso.resume()
    assert torch.equal(model.weight, w1) and daso.skip_stats()["steps"] == 1
    meta_path = os.path.join(d, "daso_state.meta.json")
    meta = json.load(open(meta_path))
    meta["n_groups"] = 2
    json.dump(meta, open(meta_path, "w"))
    with pytest.raises(ValueError, match="different world"):
        daso.resume()
    with pytest.raises(ValueError, match="checkpoint_dir"):
        htt.optim.DASO(htt.optim.DataParallelOptimizer("sgd", lr=0.1), checkpoint_every=2)
