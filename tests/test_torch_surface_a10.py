"""heat_tpu_torch's public surface against heat_tpu's, ``vmap``, and the
stragglers (``world``, ``use_comm``, the device counts, ``restart_epoch``,
``version``, ``axisspec``), at world size 1 on the CPU.

The names heat_tpu exports and the port lacks are exactly the recorded
divergences: ``make_mesh``, ``use_mesh`` and ``get_default_mesh`` name JAX
meshes; ``ht.parallel`` lacks nothing (the pipeline and the serving
tier are ported); ``ht.utils.data`` has no MNIST loader.  ``vmap``'s
values are held against the reference's within 1e-6 of the largest entry
(the same float32 operations), dtype, shape and split exactly.
"""

import os
import warnings

import numpy as np
import pytest
import torch

import heat_tpu
import heat_tpu_torch as htt

MESH = {"get_default_mesh", "make_mesh", "use_mesh"}


@pytest.fixture(autouse=True)
def on_cpu():
    prev = htt.get_device()
    htt.use_device("cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        yield
    htt.use_device(prev)


NAMES = """
import json, os
import jax
jax.config.update("jax_platforms", "cpu")
import heat_tpu, heat_tpu.fft, heat_tpu.sparse
import heat_tpu_torch
out = {}
for path in ("", "core", "parallel", "utils.data", "fft", "sparse"):
    ref, port = heat_tpu, heat_tpu_torch
    for part in filter(None, path.split(".")):
        ref, port = getattr(ref, part), getattr(port, part)
    out[path] = sorted({n for n in dir(ref) if not n.startswith("_")} - {n for n in dir(port) if not n.startswith("_")})
out["private"] = sorted(set(dir(heat_tpu)) - set(dir(heat_tpu_torch)))
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def missing():
    """The names heat_tpu has and the port lacks, from fresh imports of both
    (other tests import submodules, which adds them to a package's names)."""
    import json
    import pathlib
    import subprocess
    import sys

    repo = pathlib.Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, "-c", NAMES], cwd=repo, capture_output=True, text=True, timeout=300,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("path,allowed", [
    ("", MESH), ("core", MESH), ("parallel", set()), ("utils.data", {"mnist", "MNISTDataset"}),
    ("fft", set()), ("sparse", set())])
def test_missing_names_are_the_recorded_divergences(path, allowed, missing):
    assert set(missing[path]) == allowed


def test_private_names_of_the_top_level(missing):
    assert set(missing["private"]) - MESH == {"__getattr__"}
    assert htt.__version__ == heat_tpu.__version__ == htt.core.__version__ == htt.version.__version__


def test_world_and_use_comm():
    w = htt.world()
    assert isinstance(w, htt.Communication) and w is htt.world() and htt.get_comm() is w
    assert (w.size, w.rank) == (1, 0)
    other = htt.Communication()
    htt.use_comm(other)
    try:
        assert htt.get_comm() is other and htt.array([1, 2]).comm is other
    finally:
        htt.use_comm(None)
    assert htt.get_comm() is w
    with pytest.raises(TypeError):
        htt.use_comm("world")


def test_device_counts_and_restart_epoch(monkeypatch):
    want = torch.cuda.device_count() if torch.cuda.is_available() else 1
    assert htt.local_device_count() == want and htt.device_count() == want
    monkeypatch.delenv("HEAT_TPU_RESTART_EPOCH", raising=False)
    assert htt.restart_epoch() == heat_tpu.restart_epoch() == 0
    for value, epoch in (("3", 3), ("", 0), ("x", 0)):
        monkeypatch.setenv("HEAT_TPU_RESTART_EPOCH", value)
        assert htt.restart_epoch() == heat_tpu.restart_epoch() == epoch


def test_redistribution_budget_under_core():
    prev = htt.core.get_redistribution_budget()
    try:
        htt.core.set_redistribution_budget("64M")
        assert htt.get_redistribution_budget() == htt.core.get_redistribution_budget()
    finally:
        htt.core.set_redistribution_budget(prev)


@pytest.mark.parametrize("split", [None, 0, 1, 2])
@pytest.mark.parametrize("ndim", [1, 2, 3])
def test_axisspec_matches_the_reference(split, ndim):
    ours, ref = htt.axisspec, heat_tpu.axisspec
    if split is not None and split >= ndim:
        with pytest.raises(ValueError):
            ours.split_to_spec(split, ndim)
        return
    spec = ours.split_to_spec(split, ndim)
    assert spec == ref.split_to_spec(split, ndim)
    assert ours.spec_to_split(spec) == split
    n = ours.named(split)
    assert n == split and ours.is_named(n) == (split is not None)
    if split is not None:
        assert hash(n) == hash(split) and n.spec(ndim) == spec and n.axis_name == ref.DATA_AXIS


X = np.random.default_rng(8).standard_normal((9, 4)).astype(np.float32)
Y = np.random.default_rng(9).standard_normal((9, 4)).astype(np.float32)


def _row_fn(lib):
    return lambda r, s: lib.exp(r) * 2.0 + lib.sum(s) - r


@pytest.mark.parametrize("sx,sy", [(None, None), (0, 0), (0, None), (1, 0)])
def test_vmap_matches_the_reference(sx, sy):
    got = htt.vmap(_row_fn(htt))(htt.array(X, split=sx), htt.array(Y, split=sy))
    want = heat_tpu.vmap(_row_fn(heat_tpu))(heat_tpu.array(X, split=sx), heat_tpu.array(Y, split=sy))
    assert got.shape == want.shape and got.split == want.split
    assert got.dtype.__name__ == want.dtype.__name__
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6 * np.abs(want.numpy()).max())
    whole = np.exp(X) * 2.0 + Y.sum(1, keepdims=True) - X
    np.testing.assert_allclose(got.numpy(), whole, rtol=1e-5)


def test_vmap_out_dims_and_scalars():
    got = htt.vmap(lambda r: htt.sum(r * r), out_dims=0)(htt.array(X, split=0))
    np.testing.assert_allclose(got.numpy(), (X * X).sum(1), rtol=1e-6)
    assert got.shape == (9,) and got.split == 0
    t = htt.vmap(lambda r, c: r * c, out_dims=1)(htt.array(X), 3.0)
    np.testing.assert_allclose(t.numpy(), (X * 3.0).T, rtol=1e-6)
    with pytest.raises(TypeError):
        htt.vmap(lambda r: r)(X)


def test_vmap_refuses_a_host_sync_inside_func():
    """An op that reads a value on the host cannot run under torch.func."""
    with pytest.raises(RuntimeError):
        htt.vmap(lambda r: r * float(htt.sum(r)))(htt.array(X, split=0))


def test_ring_map_at_world_size_one():
    x = htt.array(X, split=0)
    res = htt.parallel.ring_map(lambda a, b, src: a @ b.T, x, x)
    np.testing.assert_allclose(res.numpy(), X @ X.T, rtol=1e-5)
    assert res.split == 0
    tot = htt.parallel.ring_map(lambda a, b, src: a * (src + 1), x, x, combine="sum")
    np.testing.assert_allclose(tot.numpy(), X, rtol=1e-6)
    with pytest.raises(ValueError):
        htt.parallel.ring_map(lambda a, b, s: a, x, x, combine="max")
