"""heat_tpu_torch core against heat_tpu: types, devices, the communicator's
shard math, DNDarray round trips, factories and random sampling.

Both packages get the same numpy input; results are compared as global
numpy arrays.  The port runs on the CPU (``device="cpu"``), world size 1;
the multi-rank layout is covered in ``test_torch_kmeans_mp.py``.
"""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import heat_tpu
import heat_tpu_torch as htt
from heat_tpu_torch.core.communication import Communication

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture
def on_cpu():
    prev = htt.get_device()
    htt.use_device("cpu")
    yield
    htt.use_device(prev)


class _FixedComm(Communication):
    """A communicator that reports a given size and rank (shard math only)."""

    def __init__(self, size, rank=0):
        super().__init__()
        self._size, self._rank = size, rank

    size = property(lambda self: self._size)
    rank = property(lambda self: self._rank)


# ---------------------------------------------------------------------- #
# no JAX in the port
# ---------------------------------------------------------------------- #
def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_sources_import_no_jax():
    files = sorted((REPO / "heat_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py",
                                                               REPO / "tests" / "test_torch_cuda_kernels.py"]
    assert len(files) > 10
    for f in files:
        for mod in _imports(f):
            root = mod.split(".")[0]
            assert root not in ("jax", "jaxlib", "heat_tpu"), f"{f} imports {mod}"


def test_port_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'heat_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import heat_tpu_torch as ht\n"
        "import heat_tpu_torch.utils.convert\n"
        "ht.use_device('cpu')\n"
        "print(ht.cluster.KMeans(n_clusters=2, init='random').fit(ht.random.rand(20, 3, split=0)).n_iter_ >= 1)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "True"


# ---------------------------------------------------------------------- #
# types
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("name", ["bool", "uint8", "int8", "int16", "int32", "int64",
                                  "bfloat16", "float16", "float32", "float64", "complex64", "complex128"])
def test_types_mirror_reference(name):
    t = getattr(htt, name)
    assert t.__name__ == getattr(heat_tpu, name).__name__
    assert t.torch_type() == getattr(torch, name)
    assert htt.canonical_heat_type(getattr(torch, name)) is t
    assert htt.canonical_heat_type(name) is t
    assert issubclass(t, htt.floating) == issubclass(getattr(heat_tpu, name), heat_tpu.floating)


@pytest.mark.parametrize("a,b", [("int32", "float32"), ("int8", "uint8"), ("bfloat16", "float16"),
                                 ("bool", "int16"), ("float32", "float64"), ("int64", "float32")])
def test_promote_types_matches_reference(a, b):
    got = htt.promote_types(getattr(htt, a), getattr(htt, b)).__name__
    assert got == heat_tpu.promote_types(getattr(heat_tpu, a), getattr(heat_tpu, b)).__name__


# ---------------------------------------------------------------------- #
# devices
# ---------------------------------------------------------------------- #
def test_default_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the default device resolves")
    prev = htt.get_device()
    htt.use_device("gpu")
    try:
        assert htt.get_device() == "gpu"
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            htt.zeros((2, 2))
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            htt.array(np.ones(3, np.float32))
    finally:
        htt.use_device(prev)


def test_explicit_cpu_device():
    x = htt.zeros((3, 2), device="cpu")
    assert x.device == "cpu" and x.larray.device.type == "cpu"
    assert htt.sanitize_device(torch.device("cpu")) is htt.cpu
    with pytest.raises(ValueError):
        htt.sanitize_device("tpu")


# ---------------------------------------------------------------------- #
# communicator shard math: HeAT's rule, covering the reference's global shape
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("n", [1, 7, 13, 1001])
@pytest.mark.parametrize("size", [1, 2, 3, 8])
def test_chunk_counts_displs_lshape_map(n, size):
    ref = heat_tpu.array(np.arange(n * 3, dtype=np.float32).reshape(n, 3), split=0)
    want_counts = [len(a) for a in np.array_split(np.arange(n), size)]  # first n % size ranks get one more
    comms = [_FixedComm(size, r) for r in range(size)]
    counts, displs = comms[0].counts_displs_shape(ref.shape, 0)
    assert list(counts) == want_counts
    assert list(displs) == list(np.concatenate([[0], np.cumsum(want_counts)[:-1]]))
    assert sum(counts) == ref.shape[0]
    lmap = comms[0].lshape_map(ref.shape, 0)
    assert lmap.tolist() == [[c, 3] for c in want_counts]
    # the ranks' slices tile the reference's global array
    glob = ref.numpy()
    parts = [glob[c.chunk(ref.shape, 0)[2]] for c in comms]
    np.testing.assert_array_equal(np.concatenate(parts), glob)
    for r, c in enumerate(comms):
        off, lshape, _ = c.chunk(ref.shape, 0)
        assert (off, lshape) == (displs[r], (counts[r], 3))
    assert comms[0].chunk((n, 3), None) == (0, (n, 3), (slice(0, n), slice(0, 3)))


def test_world_one_collectives_are_identity():
    comm = htt.get_comm()
    assert (comm.size, comm.rank, comm.is_distributed()) == (1, 0, False)
    t = torch.arange(4.0)
    assert comm.Allreduce(t) is t
    assert comm.Bcast(t) is t
    assert comm.Allgather(t)[0] is t
    assert comm.Allgatherv(t) is t
    with pytest.raises(ValueError):
        comm.Allreduce(t, op="xor")


# ---------------------------------------------------------------------- #
# DNDarray and factories against the reference's global values
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("split", [None, 0, 1])
def test_array_numpy_round_trip(split, on_cpu):
    X = np.random.default_rng(0).standard_normal((13, 5)).astype(np.float32)
    x = htt.array(X, split=split)
    ref = heat_tpu.array(X, split=split)
    assert x.shape == x.gshape == ref.shape == (13, 5)
    assert x.split == split and x.lshape == (13, 5)
    assert x.dtype is htt.float32
    np.testing.assert_array_equal(x.numpy(), ref.numpy())
    np.testing.assert_array_equal(x.lshape_map(), [[13, 5]])
    # the data is copied: the caller's buffer stays untouched
    x.larray[0, 0] = 99.0
    assert X[0, 0] != 99.0


def test_array_is_split_and_dtype(on_cpu):
    X = np.arange(12, dtype=np.int64).reshape(4, 3)
    x = htt.array(X, is_split=0)
    assert x.split == 0 and x.shape == (4, 3) and x.balanced
    assert htt.array([1.5, 2.5]).dtype is htt.float32
    assert htt.array(X, dtype=htt.bfloat16).numpy().dtype == np.float32
    assert htt.array(X, ndmin=3).shape == (1, 4, 3)
    with pytest.raises(ValueError):
        htt.array(X, split=0, is_split=0)
    y = htt.asarray(X).astype(htt.float64)
    assert y.dtype is htt.float64 and y.larray.dtype == torch.float64


@pytest.mark.parametrize("split", [None, 0])
def test_factories_match_reference(split, on_cpu):
    for fn in ("zeros", "ones"):
        np.testing.assert_array_equal(getattr(htt, fn)((7, 3), split=split).numpy(),
                                      getattr(heat_tpu, fn)((7, 3), split=split).numpy())
    np.testing.assert_array_equal(htt.full((5, 2), 3.5, split=split).numpy(),
                                  heat_tpu.full((5, 2), 3.5, split=split).numpy())
    assert htt.empty((4, 2), split=split).shape == (4, 2)
    for args in ((10,), (2, 11, 3), (0.0, 1.0, 0.25)):
        got, want = htt.arange(*args, split=split), heat_tpu.arange(*args, split=split)
        np.testing.assert_allclose(got.numpy(), want.numpy())
        assert got.dtype.__name__ == want.dtype.__name__


def test_row_indexing(on_cpu):
    X = np.random.default_rng(1).standard_normal((11, 4)).astype(np.float32)
    x, ref = htt.array(X, split=0), heat_tpu.array(X, split=0)
    np.testing.assert_array_equal(x[3].numpy(), ref[3].numpy())
    np.testing.assert_array_equal(x[-1].numpy(), X[-1])
    np.testing.assert_array_equal(x[[0, 5, 10]].numpy(), X[[0, 5, 10]])
    sl = x[2:9]
    assert sl.shape == (7, 4) and sl.split == 0
    np.testing.assert_array_equal(sl.numpy(), ref[2:9].numpy())
    np.testing.assert_array_equal(x[1:3, 1:].numpy(), X[1:3, 1:])
    with pytest.raises(IndexError):
        x[[11]]


def test_random_reproducible_and_distributed_right(on_cpu):
    htt.random.seed(5)
    a = htt.random.randn(2000, 3, split=0).numpy()
    htt.random.seed(5)
    b = htt.random.randn(2000, 3, split=0).numpy()
    np.testing.assert_array_equal(a, b)
    assert abs(a.mean()) < 0.1 and abs(a.std() - 1.0) < 0.1
    assert htt.random.get_state()[:3] == ("Threefry", 5, 1)
    u = htt.random.rand(1000).numpy()
    assert 0.0 <= u.min() and u.max() < 1.0
    r = htt.random.randint(3, 7, (500,)).numpy()
    assert r.min() >= 3 and r.max() < 7 and r.dtype == np.int32
    m = htt.random.normal(10.0, 2.0, (4000,)).numpy()
    assert abs(m.mean() - 10.0) < 0.2 and abs(m.std() - 2.0) < 0.2


def test_sanitation(on_cpu):
    from heat_tpu_torch.core.sanitation import sanitize_in, sanitize_out

    x = htt.zeros((3, 2), split=0)
    sanitize_in(x)
    with pytest.raises(TypeError):
        sanitize_in(np.zeros(3))
    sanitize_out(x, (3, 2), 0, "cpu")
    with pytest.raises(ValueError):
        sanitize_out(x, (3, 3), 0, "cpu")
    with pytest.raises(ValueError):
        sanitize_out(x, (3, 2), None, "cpu")


# default ingest of numpy and Python data narrows 64 bits as the reference
# does (JAX with x64 off): float64, int64 and Python ints and floats
INGEST = {"numpy float64": np.random.default_rng(0).random((5, 3)), "numpy int64": np.arange(6).reshape(2, 3),
          "python ints": [1, 2, 3], "python floats": [1.5, -2.5], "nested mixed": [[1, 2.5], [3, 4]],
          "numpy float32": np.ones((2, 2), np.float32), "numpy int32": np.arange(3, dtype=np.int32),
          "numpy bool": np.array([True, False])}


@pytest.mark.parametrize("name", list(INGEST))
def test_array_ingest_dtype_matches_reference(name, on_cpu):
    data = INGEST[name]
    x, ref = htt.array(data), heat_tpu.array(data)
    assert x.dtype.__name__ == ref.dtype.__name__
    assert x.larray.dtype == getattr(torch, ref.dtype.__name__)
    np.testing.assert_array_equal(x.numpy(), ref.numpy())


def test_array_keeps_an_explicit_float64(on_cpu):
    """An explicit float64 stays 64-bit (the reference, with x64 off, narrows
    it: a recorded divergence), and so does a float64 torch tensor."""
    X = np.random.default_rng(1).random((4, 3))
    for x in (htt.array(X, dtype=htt.float64), htt.array(X).astype(htt.float64),
              htt.array(torch.from_numpy(X))):
        assert x.dtype is htt.float64 and x.larray.dtype == torch.float64
    np.testing.assert_array_equal(htt.array(X, dtype=htt.float64).numpy(), X)
    assert htt.array(X).larray.dtype == torch.float32


def test_full_narrows_a_float64_fill_as_the_reference(on_cpu):
    x, ref = htt.full((3, 2), np.float64(1.5)), heat_tpu.full((3, 2), np.float64(1.5))
    assert x.dtype is htt.float32 and ref.dtype.__name__ == "float32"
    np.testing.assert_array_equal(x.numpy(), ref.numpy())
    assert htt.full((2,), np.int64(3)).dtype is htt.int32
    assert htt.full((2,), 1.5, dtype=htt.float64).dtype is htt.float64
