"""Parallel I/O (reference: ``heat/core/io.py``; the JAX package's ``core/io.py``).

``save``/``load`` dispatch by extension.  Every process writes and reads
only its own hyperslab, HeAT's rule: ``chunk`` rows of the split axis.
Writes to one file (HDF5, netCDF, CSV, ``.npy``) go in rank order, one
writer at a time: rank r waits for a token from rank r - 1, writes its
rows, and passes the token on (``Sendrecv``); a barrier ends the write.
zarr and the array checkpoint write one file a chunk, all ranks at once.
No rank reads the whole file: each reads its rows.  File I/O is the
reference's host route, so a tensor on the card is copied to the host one
chunk at a time, and never more than this rank's chunk is on the host.

HDF5 and netCDF go through h5py, imported where it is used (netCDF-4 files
are HDF5 containers with dimension scales; the netCDF4 library is taken
where it is installed).  ``supports_hdf5()`` is False where h5py is not
installed.  CSV is parsed with numpy.  zarr v2 is written by hand, in the
reference's layout.  Checkpoints are durable: every file and directory is
fsynced before the atomic flip that makes a version visible, and transient
write faults are retried with jittered backoff (``utils.faults``).  The
formats are the reference's, so files cross between the packages.

The runtime hooks are the JAX package's: the fault sites ``io.write``,
``io.fsync`` and ``io.read`` (fired with ``path=``, so ``corrupt`` flips a
byte of the file), the counters ``io.bytes_written`` and ``io.fsync.calls``,
the spans ``io.save_array_checkpoint``, ``io.load_array_checkpoint``,
``io.save_checkpoint`` and ``io.load_checkpoint``, the flight recorder's
``ckpt`` events, the memory ledger's ``param`` registrations of what a load
restores, and a deadline (``_IO_SYNC_DEADLINE``, or the caller's tighter
one) on the barrier that ends a collective write.
"""

from __future__ import annotations

import itertools
import json
import os
import shutil
import warnings
import zlib
from typing import List, Optional

import numpy as np
import torch

from . import devices, factories, types
from .communication import Communication, sanitize_comm
from .dndarray import DNDarray
from ..utils import faults as _faults
from ..utils import flightrec as _flightrec
from ..utils import health as _health
from ..utils import memledger as _memledger
from ..utils import telemetry as _telemetry

__all__ = [
    "load",
    "load_csv",
    "load_hdf5",
    "load_netcdf",
    "load_npy_from_path",
    "save",
    "save_csv",
    "save_hdf5",
    "save_zarr",
    "load_zarr",
    "save_netcdf",
    "supports_hdf5",
    "supports_netcdf",
    "load_checkpoint",
    "save_checkpoint",
    "save_array_checkpoint",
    "load_array_checkpoint",
    "CheckpointCorruptionError",
]


class CheckpointCorruptionError(RuntimeError):
    """A checkpoint failed integrity verification: checksum mismatch,
    missing or truncated chunk files, or unreadable metadata."""


# the retry policy of checkpoint writes and reads (the reference's)
IO_RETRY = {"retries": 4, "base_delay": 0.02, "max_delay": 0.5, "jitter": 0.5}

# bytes a streamed read or checksum takes at once
_BLOCK = 16 << 20


def _retry(fn, site: str, **over):
    return _faults.call_with_retries(fn, site, **{**IO_RETRY, **over})


def _fsync_dir(path: str) -> None:
    """fsync a directory, so that its entries (new files, renames) are durable."""
    fd = os.open(path, os.O_RDONLY)
    try:
        _faults.fire("io.fsync", path=path)
        os.fsync(fd)
        _telemetry.counter_inc("io.fsync.calls")
    finally:
        os.close(fd)


# a barrier that ends a collective write fails loudly instead of hanging the
# world on a dead peer: it runs under this deadline (seconds) unless the
# caller armed a tighter one
_IO_SYNC_DEADLINE = 600.0


def _bounded_sync(comm: Communication, tag: str) -> None:
    """``comm.Barrier()`` under a collective deadline: raises
    ``CollectiveTimeoutError`` (after a stack dump) instead of blocking
    forever.  An armed caller deadline governs (its remaining budget is
    re-armed, never loosened); otherwise the io default applies."""
    active = _health.active_deadline()
    budget = active.remaining() if active is not None else _IO_SYNC_DEADLINE
    with _health.deadline(budget):
        _health.guard_blocking(comm.Barrier, f"io.sync:{tag}")


class _Crc32Writer:
    """A file-like sink that counts and checksums what passes through it."""

    def __init__(self, fh):
        self.fh, self.crc, self.n = fh, 0, 0

    def write(self, b) -> int:
        b = memoryview(b).cast("B")
        self.crc = zlib.crc32(b, self.crc)
        self.n += len(b)
        return self.fh.write(b)


def _durable_write(path: str, emit) -> tuple:
    """Write ``emit(sink)``'s bytes to ``path`` and fsync the file, retrying
    the whole write on a transient fault.  Returns (crc32, bytes).  Fault
    sites ``io.write`` (after the bytes hit the file, before the fsync:
    ``corrupt`` flips a byte on disk there, after the checksum) and
    ``io.fsync``; a successful write counts under ``io.bytes_written`` and
    ``io.fsync.calls``."""

    def attempt():
        with open(path, "wb") as fh:
            sink = _Crc32Writer(fh)
            emit(sink)
            fh.flush()
            _faults.fire("io.write", path=path)
            _faults.fire("io.fsync", path=path)
            os.fsync(fh.fileno())
        return sink.crc, sink.n

    crc, n = _retry(attempt, "io.write")
    _telemetry.counter_inc("io.bytes_written", n)
    _telemetry.counter_inc("io.fsync.calls")
    return crc, n


def _file_crc(path: str) -> tuple:
    """(crc32, bytes) of a file, read in blocks, retried on transient faults
    (a missing file is a layout error, not retried)."""

    def attempt():
        _faults.fire("io.read", path=path)
        crc, n = 0, 0
        with open(path, "rb") as fh:
            while True:
                b = fh.read(_BLOCK)
                if not b:
                    return crc, n
                crc, n = zlib.crc32(b, crc), n + len(b)

    return _retry(attempt, "io.read", retry_if=lambda e: not isinstance(e, FileNotFoundError))


def _read_file(path: str) -> bytes:
    def attempt():
        _faults.fire("io.read", path=path)
        with open(path, "rb") as fh:
            return fh.read()

    return _retry(attempt, "io.read", retry_if=lambda e: not isinstance(e, FileNotFoundError))


# ---------------------------------------------------------------------- #
# hyperslabs
# ---------------------------------------------------------------------- #
def _comm_of(data) -> Communication:
    return data.comm if isinstance(data, DNDarray) else sanitize_comm(None)


def _ints(comm: Communication, values) -> torch.Tensor:
    """A small int64 control tensor where the communicator's collectives take one."""
    dev = comm._scratch_device() if comm.is_distributed() else torch.device("cpu")
    return torch.tensor(values, dtype=torch.int64, device=dev)


def _host(t: torch.Tensor) -> np.ndarray:
    """A local tensor on the host as numpy (bfloat16 has no numpy type)."""
    if t.dtype == torch.bfloat16:
        raise ValueError("bfloat16 has no numpy representation for a file; astype(float32) before saving")
    return t.detach().cpu().numpy()


def _my_hyperslab(x):
    """``(global slices, ndarray)`` of this rank's part of ``x``, or None
    where the rank holds no part to write (a replicated array's other
    ranks, a rank without rows)."""
    comm = _comm_of(x)
    if not isinstance(x, DNDarray):
        arr = np.asarray(x)
        return (tuple(slice(0, s) for s in arr.shape), arr) if comm.rank == 0 else None
    if not x.is_distributed():
        if comm.rank != 0:
            return None
        return tuple(slice(0, s) for s in x.shape), _host(x.larray)
    split = x.split
    counts, displs = x.counts_displs()
    lo, c = displs[comm.rank], counts[comm.rank]
    if c == 0:
        return None
    sl = tuple(slice(lo, lo + c) if i == split else slice(0, s) for i, s in enumerate(x.shape))
    return sl, _host(x.larray)


def _token_ring_write(data, body) -> None:
    """Writes in rank order, one writer at a time: ``body(first, slab)``
    writes this rank's ``(slices, ndarray)`` (``first``: rank 0, which
    creates or truncates the file).  Rank r waits for rank r - 1's token
    and passes it on; a writer that fails still passes it and re-raises
    after the closing barrier, so no rank hangs."""
    comm = _comm_of(data)
    slab = _my_hyperslab(data)
    if not comm.is_distributed():
        body(True, slab)
        return
    rank, p = comm.rank, comm.size
    token = _ints(comm, [0])
    if rank > 0:
        token = comm.Sendrecv(token, None, rank - 1)
    failure = None
    try:
        if slab is not None or rank == 0:
            body(rank == 0, slab)
    except Exception as e:  # noqa: BLE001 - re-raised after the ring
        failure = e
    if rank + 1 < p:
        comm.Sendrecv(token, rank + 1, None)
    _bounded_sync(comm, "token_ring")
    if failure is not None:
        raise failure


def _dtype_of(data) -> np.dtype:
    if isinstance(data, DNDarray):
        return types._np_dtype(data.dtype)
    return np.asarray(data).dtype


def _shape_of(data) -> tuple:
    return tuple(data.shape) if isinstance(data, DNDarray) else np.asarray(data).shape


def _tensor(arr: np.ndarray) -> torch.Tensor:
    """A CPU tensor of ``arr`` (its own copy where arr is not a writable C-order array)."""
    if not (arr.flags.c_contiguous and arr.flags.writeable):
        arr = np.array(arr, order="C")
    return torch.from_numpy(arr)


def _read_hyperslab(reader, gshape, dtype, split, device, comm) -> DNDarray:
    """A DNDarray of ``gshape`` where this process reads only its own
    ``chunk`` through ``reader(slices) -> ndarray`` (the whole array where
    ``split`` is None)."""
    comm = sanitize_comm(comm)
    gshape = tuple(int(s) for s in gshape)
    dtype = types.canonical_heat_type(dtype)
    if split is not None:
        split = split % max(len(gshape), 1)
    _, _, slices = comm.chunk(gshape, split)
    data = np.asarray(reader(slices))
    dev = devices.sanitize_device(device)
    t = _tensor(data).to(dev.torch_device)
    t = t.to(dtype.torch_type())
    return DNDarray(t, gshape, dtype, split, dev, comm, True)


# ---------------------------------------------------------------------- #
# HDF5
# ---------------------------------------------------------------------- #
def supports_hdf5() -> bool:
    """True where h5py can be imported."""
    try:
        import h5py  # noqa: F401

        return True
    except ImportError:
        return False


def supports_netcdf() -> bool:
    """netCDF-4 through the netCDF4 library or, failing that, through h5py
    (netCDF-4 files are HDF5 containers)."""
    try:
        import netCDF4  # noqa: F401

        return True
    except ImportError:
        return supports_hdf5()


def load_hdf5(path: str, dataset: str, dtype=types.float32, load_fraction: float = 1.0,
              split: Optional[int] = None, device=None, comm=None) -> DNDarray:
    """Load an HDF5 dataset; with ``split``, each process reads only its
    hyperslab.  ``load_fraction`` < 1 with ``split=0`` keeps that share of
    the leading rows."""
    import h5py

    with h5py.File(path, "r") as f:
        ds = f[dataset]
        gshape = tuple(ds.shape)
        if load_fraction < 1.0 and split == 0:
            gshape = (int(gshape[0] * load_fraction),) + gshape[1:]
        return _read_hyperslab(lambda s: ds[s], gshape, dtype, split, device, comm)


def save_hdf5(data: DNDarray, path: str, dataset: str, mode: str = "w", **kwargs) -> None:
    """Write a DNDarray to HDF5: the dataset is created at full shape by
    rank 0, then each rank writes its hyperslab in rank order."""
    import h5py

    shape = _shape_of(data)
    kwargs.setdefault("dtype", _dtype_of(data))

    def body(first, slab):
        with h5py.File(path, mode if first else "a") as f:
            if first:
                if dataset in f:
                    del f[dataset]
                ds = f.create_dataset(dataset, shape=shape, **kwargs)
            else:
                ds = f[dataset]
            if slab is not None:
                ds[slab[0]] = slab[1]

    _token_ring_write(data, body)


# ---------------------------------------------------------------------- #
# CSV
# ---------------------------------------------------------------------- #
def _parse_csv(lines: List[bytes], sep: str, encoding: str) -> np.ndarray:
    """Rows of numbers, one a line, as a 2-D float64 array (numpy's C
    parser; ``genfromtxt``'s rules, NaN for an empty field, where it fails)."""
    text = [ln.decode(encoding) for ln in lines if ln.strip()]
    if not text:
        return np.zeros((0, 0))
    try:
        return np.loadtxt(text, delimiter=sep, ndmin=2, dtype=np.float64)
    except ValueError:
        return np.atleast_2d(np.genfromtxt(text, delimiter=sep, dtype=np.float64))


def load_csv(path: str, header_lines: int = 0, sep: str = ",", dtype=types.float32, encoding: str = "utf-8",
             split: Optional[int] = None, device=None, comm=None) -> DNDarray:
    """Parallel CSV ingest.  With ``split=0`` on several processes, each
    reads a byte range of the file: a line belongs to the rank whose range
    holds its first byte, and the rows are then moved to ``chunk``'s
    layout.  Otherwise every process parses the file.  The shape follows
    ``genfromtxt``: several columns 2-D, one column 1-D, one value 0-D."""
    comm = sanitize_comm(comm)
    dev = devices.sanitize_device(device)
    dtype = types.canonical_heat_type(dtype)
    with open(path, "rb") as fh:
        for _ in range(header_lines):
            fh.readline()
        body_start = fh.tell()
        size = os.fstat(fh.fileno()).st_size
        if split == 0 and comm.is_distributed():
            p, r = comm.size, comm.rank
            span = size - body_start
            lo, hi = body_start + span * r // p, body_start + span * (r + 1) // p
            if lo > body_start:  # the line holding byte lo - 1 belongs to the rank before
                fh.seek(lo - 1)
                fh.readline()
                lo = fh.tell()
            lines = []
            fh.seek(lo)
            while fh.tell() < hi:
                ln = fh.readline()
                if not ln:
                    break
                lines.append(ln)
        else:
            fh.seek(body_start)
            lines = fh.read().splitlines()
        fh.seek(body_start)
        first = fh.readline()
    local = _parse_csv(lines, sep, encoding)
    ncols = len(first.decode(encoding).rstrip("\r\n").split(sep)) if first.strip() else 0
    if local.size == 0:
        local = np.zeros((0, max(ncols, 1)))
    if split == 0 and comm.is_distributed():
        t = torch.from_numpy(local).to(dev.torch_device).to(dtype.torch_type())
        if ncols == 1:
            t = t.reshape(-1)
        n = int(comm.Allreduce(_ints(comm, [t.shape[0]])).item())
        x = DNDarray(t, (n,) + tuple(t.shape[1:]), dtype, 0, dev, comm, False)
        x.balance_()
        return x
    if local.shape == (1, 1):
        data = local.reshape(())
    elif local.shape[1] > 1:
        data = local
    else:
        data = local.reshape(-1)
    return factories.array(data, dtype=dtype, split=split, device=dev, comm=comm)


def _csv_format(dtype: np.dtype, decimals: int) -> str:
    if decimals >= 0:
        return f"%.{decimals}f"
    if np.issubdtype(dtype, np.integer) or dtype == np.bool_:
        return "%d"
    # enough digits that every value reads back to the same bits
    return "%.9g" if dtype == np.float32 else "%.17g"


def _write_rows(fh, block: np.ndarray, sep: str, fmt: str) -> None:
    """``block``'s rows as text, formatted in blocks of rows at once."""
    block = block.reshape(-1, 1) if block.ndim == 1 else block
    if block.ndim == 0:
        block = block.reshape(1, 1)
    ncols = block.shape[1]
    row = sep.join([fmt] * ncols) + "\n"
    step = max(1, (1 << 20) // max(ncols, 1))
    for s in range(0, block.shape[0], step):
        part = block[s:s + step]
        vals = part.astype(np.int64 if fmt == "%d" else np.float64).ravel().tolist()
        fh.write(((row * part.shape[0]) % tuple(vals)).encode())


def save_csv(data: DNDarray, path: str, header_lines: Optional[List[str]] = None, sep: str = ",",
             decimals: int = -1, truncate: bool = True) -> None:
    """Write a 1-D or 2-D array as CSV, a row a line (a 1-D array one value
    a line), in rank order: each rank appends its rows."""
    if isinstance(data, DNDarray) and data.is_distributed() and data.split != 0:
        data = data.resplit(0)
    fmt = _csv_format(_dtype_of(data), decimals)

    def body(first, slab):
        with open(path, "wb" if first and truncate else "ab") as fh:
            if first and header_lines:
                fh.write(("\n".join(header_lines) + "\n").encode())
            if slab is not None:
                _write_rows(fh, slab[1], sep, fmt)

    _token_ring_write(data, body)


# ---------------------------------------------------------------------- #
# NPY
# ---------------------------------------------------------------------- #
def _npy_files(path: str) -> List[str]:
    if os.path.isdir(path):
        files = sorted(f for f in os.listdir(path) if f.endswith(".npy"))
        if not files:
            raise ValueError(f"no .npy files under {path}")
        return [os.path.join(path, f) for f in files]
    return [path]


def _rows_reader(mmaps, axis: int = 0):
    """``reader(slices)`` over arrays concatenated along ``axis``: each
    file contributes the rows of the slice it holds (memory-mapped, so only
    those rows are read)."""
    starts = np.concatenate([[0], np.cumsum([m.shape[axis] for m in mmaps])]).astype(np.int64)

    def reader(slices):
        lo, hi = slices[axis].start, slices[axis].stop
        parts = []
        for s, m in zip(starts.tolist(), mmaps):
            a, b = max(lo, s), min(hi, s + m.shape[axis])
            if a < b:
                sub = list(slices)
                sub[axis] = slice(a - s, b - s)
                parts.append(np.asarray(m[tuple(sub)]))
        if not parts:
            sub = list(slices)
            sub[axis] = slice(0, 0)
            return np.asarray(mmaps[0][tuple(sub)])
        return parts[0] if len(parts) == 1 else np.concatenate(parts, axis=axis)

    return reader, int(starts[-1])


def load_npy_from_path(path: str, dtype=types.float32, split: int = 0, device=None, comm=None) -> DNDarray:
    """Load a ``.npy`` file, or every ``.npy`` file of a directory (sorted by
    name) concatenated along axis 0; each process reads its rows."""
    mmaps = [np.load(f, mmap_mode="r") for f in _npy_files(path)]
    reader, n = _rows_reader(mmaps, 0)
    gshape = (n,) + tuple(mmaps[0].shape[1:])
    return _read_hyperslab(reader, gshape, dtype, split, device, comm)


def _save_npy(data, path: str) -> None:
    shape, dt = _shape_of(data), _dtype_of(data)

    def body(first, slab):
        if first:  # the header and the whole file, then each rank's rows
            np.lib.format.open_memmap(path, mode="w+", dtype=dt, shape=shape).flush()
        if slab is None:
            return
        mm = np.lib.format.open_memmap(path, mode="r+")
        mm[slab[0]] = slab[1]
        mm.flush()
        del mm

    _token_ring_write(data, body)


# ---------------------------------------------------------------------- #
# netCDF
# ---------------------------------------------------------------------- #
def load_netcdf(path: str, variable: str, dtype=types.float32, split: Optional[int] = None,
                device=None, comm=None) -> DNDarray:
    """Load a variable of a netCDF file, each process its hyperslab: through
    the netCDF4 library where it is installed, else through h5py (netCDF-4
    files are HDF5 files; classic CDF-1/2 files need netCDF4)."""
    try:
        import netCDF4
    except ImportError:
        with open(path, "rb") as fh:
            magic = fh.read(4)
        if magic[:3] == b"CDF":
            raise RuntimeError("classic-format netCDF (CDF-1/2) needs the netCDF4 library, which is not "
                               "available; re-save as netCDF-4/HDF5")
        return load_hdf5(path, variable, dtype=dtype, split=split, device=device, comm=comm)
    with netCDF4.Dataset(path, "r") as f:
        var = f.variables[variable]
        return _read_hyperslab(lambda s: var[s], tuple(var.shape), dtype, split, device, comm)


def save_netcdf(data: DNDarray, path: str, variable: str, mode: str = "w", dimension_names=None,
                **kwargs) -> None:
    """Write a DNDarray as a netCDF variable, each rank its hyperslab in
    rank order: through netCDF4 where it is installed, else an HDF5 file with
    dimension scales attached (readable as netCDF-4)."""
    shape, np_dtype = _shape_of(data), _dtype_of(data)
    ndim = len(shape)
    if dimension_names is None:
        dimension_names = [f"{variable}_dim{i}" for i in range(ndim)]
    elif len(dimension_names) != ndim:
        raise ValueError(f"need {ndim} dimension names, got {len(dimension_names)}")
    if mode not in ("w", "a", "r+"):
        raise ValueError(f"invalid save mode {mode!r}; use 'w', 'a' or 'r+'")
    if mode in ("a", "r+") and not os.path.exists(path):
        mode = "w"

    def check_existing(eshape, dt):
        if tuple(eshape) != tuple(shape) or np.dtype(dt) != np_dtype:
            raise ValueError(f"variable {variable!r} exists with shape {tuple(eshape)} dtype {dt}, "
                             f"cannot re-save with shape {tuple(shape)} dtype {np_dtype}")

    try:
        import netCDF4
    except ImportError:
        netCDF4 = None

    def body(first, slab):
        eff_mode = mode if first else "a"
        if netCDF4 is None:
            import h5py

            with h5py.File(path, eff_mode) as f:
                if variable in f:
                    check_existing(f[variable].shape, f[variable].dtype)
                    ds = f[variable]
                else:
                    kwargs.setdefault("dtype", np_dtype)
                    ds = f.create_dataset(variable, shape=shape, **kwargs)
                    for i, dname in enumerate(dimension_names):
                        if dname not in f:
                            scale = f.create_dataset(dname, data=np.arange(shape[i], dtype=np.float64))
                            scale.make_scale(dname)
                        ds.dims[i].attach_scale(f[dname])
                if slab is not None:
                    ds[slab[0]] = slab[1]
            return
        with netCDF4.Dataset(path, eff_mode) as f:
            if variable in f.variables:
                var = f.variables[variable]
                check_existing(var.shape, var.dtype)
            else:
                for i, dname in enumerate(dimension_names):
                    if dname not in f.dimensions:
                        f.createDimension(dname, shape[i])
                var = f.createVariable(variable, np_dtype, tuple(dimension_names), **kwargs)
            if slab is not None:
                var[slab[0]] = slab[1]

    _token_ring_write(data, body)


# ---------------------------------------------------------------------- #
# zarr v2, written by hand in the reference's layout
# ---------------------------------------------------------------------- #
# A ``.zarray`` JSON descriptor and one raw C-order file a chunk, named by
# its dot-separated chunk indices; an edge chunk is stored at its full
# nominal size, padded with ``fill_value``.  Along the split axis the chunk
# extent is ceil(n / p), the largest of HeAT's chunks, so the rows are
# first moved to that grid (ranks past the last row hold none) and every
# rank then writes its one chunk file.


def _zarr_dtype(np_dtype) -> str:
    s = np.dtype(np_dtype).str
    if s[1] == "V":
        raise ValueError(f"dtype {np.dtype(np_dtype)} has no zarr v2 representation; astype(float32) first")
    return s


def save_zarr(data: DNDarray, path: str) -> None:
    """Write ``data`` as a zarr v2 array directory (``path`` ends .zarr)."""
    if not isinstance(data, DNDarray):
        data = factories.array(data)
    if data.ndim == 0:
        raise ValueError("zarr save requires ndim >= 1")
    comm = data.comm
    split = data.split if data.is_distributed() else None
    if split is not None:
        n, p = data.shape[split], comm.size
        extent = -(-n // p)
        grid = [min(extent, max(n - r * extent, 0)) for r in range(p)]
        data = DNDarray(data.larray.clone(), data.shape, data.dtype, split, data.device, comm, data.balanced)
        tmap = np.tile(np.asarray(data.shape, dtype=np.int64), (p, 1))
        tmap[:, split] = grid
        data.redistribute_(target_map=tmap)
        chunks = [extent if i == split else s for i, s in enumerate(data.shape)]
    else:
        chunks = list(data.shape)
    meta = {"zarr_format": 2, "shape": list(data.shape), "chunks": chunks,
            "dtype": _zarr_dtype(_dtype_of(data)), "compressor": None, "fill_value": 0, "order": "C",
            "filters": None}
    if comm.rank == 0:
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, ".zarray"), "w") as f:
            json.dump(meta, f)
    _bounded_sync(comm, "zarr:descriptor")
    np_dtype = _dtype_of(data)
    if split is None:
        if comm.rank == 0:
            arr = np.ascontiguousarray(_host(data.larray), dtype=np_dtype)
            arr.tofile(os.path.join(path, ".".join("0" * data.ndim)))
    elif data.lshape[split] > 0:
        c = chunks[split]
        arr = _host(data.larray)
        if arr.shape[split] != c:
            pad = [(0, 0)] * data.ndim
            pad[split] = (0, c - arr.shape[split])
            arr = np.pad(arr, pad)
        idx = ["0"] * data.ndim
        idx[split] = str(comm.rank)
        np.ascontiguousarray(arr, dtype=np_dtype).tofile(os.path.join(path, ".".join(idx)))
    _bounded_sync(comm, "zarr:chunks-written")


def load_zarr(path: str, dtype=None, split: Optional[int] = None, device=None, comm=None) -> DNDarray:
    """Load an uncompressed C-order zarr v2 array directory; each process
    reads only the chunk files that overlap its hyperslab."""
    with open(os.path.join(path, ".zarray")) as f:
        meta = json.load(f)
    if meta.get("zarr_format") != 2:
        raise ValueError(f"unsupported zarr_format {meta.get('zarr_format')}")
    if meta.get("compressor") is not None or meta.get("filters"):
        raise ValueError("compressed/filtered zarr arrays are not supported (save_zarr writes raw C-order chunks)")
    if meta.get("order", "C") != "C":
        raise ValueError("only C-order zarr arrays are supported")
    gshape = tuple(meta["shape"])
    chunks = tuple(max(int(c), 1) for c in meta["chunks"])
    np_dtype = np.dtype(meta["dtype"])
    fill = meta.get("fill_value")
    fill = 0 if fill is None else fill

    def reader(slices):
        out = np.full(tuple(s.stop - s.start for s in slices), fill, dtype=np_dtype)
        if out.size == 0:
            return out
        lo = [s.start // c for s, c in zip(slices, chunks)]
        hi = [(s.stop - 1) // c for s, c in zip(slices, chunks)]
        for idx in itertools.product(*(range(a, b + 1) for a, b in zip(lo, hi))):
            f = os.path.join(path, ".".join(str(i) for i in idx))
            if not os.path.exists(f):
                continue  # an absent chunk holds fill_value
            chunk = np.memmap(f, dtype=np_dtype, mode="r", shape=chunks)
            src, dst = [], []
            for d, (i, s, c) in enumerate(zip(idx, slices, chunks)):
                c0 = i * c
                a, b = max(s.start, c0), min(s.stop, c0 + c, gshape[d])
                src.append(slice(a - c0, b - c0))
                dst.append(slice(a - s.start, b - s.start))
            out[tuple(dst)] = chunk[tuple(src)]
            del chunk
        return out

    ht_dtype = types.canonical_heat_type(dtype) if dtype is not None else types.canonical_heat_type(np_dtype)
    return _read_hyperslab(reader, gshape, ht_dtype, split, device, comm)


# ---------------------------------------------------------------------- #
# dispatch
# ---------------------------------------------------------------------- #
def load(path: str, *args, **kwargs) -> DNDarray:
    """Load by extension: .h5/.hdf5, .csv, .npy, .nc/.nc4/.netcdf, .zarr."""
    ext = os.path.splitext(path)[-1].lower()
    if ext in (".h5", ".hdf5"):
        return load_hdf5(path, *args, **kwargs)
    if ext == ".csv":
        return load_csv(path, *args, **kwargs)
    if ext == ".npy":
        return load_npy_from_path(path, *args, **kwargs)
    if ext in (".nc", ".nc4", ".netcdf"):
        return load_netcdf(path, *args, **kwargs)
    if ext == ".zarr":
        return load_zarr(path, *args, **kwargs)
    raise ValueError(f"Unsupported file extension {ext}")


def save(data: DNDarray, path: str, *args, **kwargs) -> None:
    """Save by extension: .h5/.hdf5, .csv, .npy, .nc/.nc4/.netcdf, .zarr."""
    ext = os.path.splitext(path)[-1].lower()
    if ext in (".h5", ".hdf5"):
        return save_hdf5(data, path, *args, **kwargs)
    if ext == ".csv":
        return save_csv(data, path, *args, **kwargs)
    if ext == ".npy":
        return _save_npy(data, path)
    if ext in (".nc", ".nc4", ".netcdf"):
        return save_netcdf(data, path, *args, **kwargs)
    if ext == ".zarr":
        return save_zarr(data, path, *args, **kwargs)
    raise ValueError(f"Unsupported file extension {ext}")


# ---------------------------------------------------------------------- #
# chunked array checkpoints
# ---------------------------------------------------------------------- #
def _versions(directory: str) -> List[int]:
    return [int(d[1:]) for d in os.listdir(directory)
            if d.startswith("v") and d[1:].isdigit() and os.path.isdir(os.path.join(directory, d))]


@_telemetry.traced("io.save_array_checkpoint")
def save_array_checkpoint(x: DNDarray, directory: str, donate: bool = False, keep_versions: int = 1) -> None:
    """Checkpoint a DNDarray as one ``chunk_<start>.npy`` a rank (its rows,
    ``start`` their first global row) and a ``meta.json`` with the global
    shape, dtype, split, the chunks' starts, CRC32s and sizes.

    Every chunk file, ``meta.json`` and the version directory ``v<k>`` are
    fsynced before the atomic ``LATEST`` rename makes the version visible,
    and the parent directory after it: a crash leaves the previous complete
    version or the new one.  ``keep_versions`` complete versions stay after
    the flip, so :func:`load_array_checkpoint` can fall back to an older
    one.  ``donate=True`` releases x's local tensor once the write is
    durable.  Each rank holds at most its chunk on the host.  Collective."""
    if not isinstance(x, DNDarray):
        x = factories.array(x)
    comm = x.comm
    _flightrec.record_event("ckpt", op="save_array", path=directory)
    keep_versions = max(int(keep_versions), 1)
    if comm.rank == 0:
        os.makedirs(directory, exist_ok=True)
        existing = _versions(directory)
        version = max(existing, default=-1) + 1
    else:
        existing, version = [], 0
    if comm.is_distributed():
        v = comm.Bcast(_ints(comm, [version]), root=0)
        version = int(v.item())
    vdir = os.path.join(directory, f"v{version}")
    os.makedirs(vdir, exist_ok=True)
    slab = _my_hyperslab(x)
    mine = [-1, -1, -1]
    if slab is not None:
        start = slab[0][x.split].start if x.is_distributed() else 0
        arr = slab[1]
        crc, nbytes = _durable_write(os.path.join(vdir, f"chunk_{start}.npy"), lambda fh: np.save(fh, arr))
        mine = [start, crc, nbytes]
        del arr, slab
    rows = comm.Allgather(_ints(comm, mine)) if comm.is_distributed() else [torch.tensor(mine)]
    if comm.rank == 0:
        written = [r.tolist() for r in rows if int(r[0]) >= 0]
        meta = {"gshape": list(x.shape), "dtype": str(_dtype_of(x).name), "split": x.split,
                "starts": sorted(int(s) for s, _, _ in written),
                "checksums": {str(s): int(c) for s, c, _ in written},
                "chunk_bytes": {str(s): int(b) for s, _, b in written}}
        payload = json.dumps(meta).encode()
        _durable_write(os.path.join(vdir, "meta.json"), lambda fh: fh.write(payload))
        _fsync_dir(vdir)
        tmp = os.path.join(directory, ".LATEST.tmp")
        _durable_write(tmp, lambda fh: fh.write(f"v{version}".encode()))
        _fsync_dir(directory)
        os.replace(tmp, os.path.join(directory, "LATEST"))
        _fsync_dir(directory)
        for old in sorted(existing, reverse=True)[keep_versions - 1:]:
            shutil.rmtree(os.path.join(directory, f"v{old}"), ignore_errors=True)
        for legacy in os.listdir(directory):  # the pre-versioned flat layout goes after the flip
            if (legacy.startswith("chunk_") and legacy.endswith(".npy")) or legacy == "meta.json":
                try:
                    os.remove(os.path.join(directory, legacy))
                except OSError:
                    pass
    _bounded_sync(comm, "array_checkpoint")
    if donate:
        x.larray.resize_(0)


def _read_meta(vdir: str) -> dict:
    meta_path = os.path.join(vdir, "meta.json")
    if not os.path.exists(meta_path):
        raise CheckpointCorruptionError(f"no meta.json under {vdir!r}")
    try:
        meta = json.loads(_read_file(meta_path).decode())
    except (ValueError, UnicodeDecodeError) as e:
        raise CheckpointCorruptionError(f"unreadable meta.json under {vdir!r}: {e}") from e
    for key in ("gshape", "dtype", "starts"):
        if key not in meta:
            raise CheckpointCorruptionError(f"meta.json under {vdir!r} lacks {key!r}")
    expected = {f"chunk_{s}.npy" for s in meta["starts"]}
    present = {f for f in os.listdir(vdir) if f.startswith("chunk_") and f.endswith(".npy")}
    missing = sorted(expected - present)
    if missing:
        raise CheckpointCorruptionError(f"checkpoint {vdir!r} is missing chunk files {missing} "
                                        f"(meta lists starts {meta['starts']}, found {sorted(present)})")
    return meta


def _verify_chunk(vdir: str, meta: dict, s: int) -> None:
    checksums = meta.get("checksums")
    if not checksums:
        return  # a version written before checksums: its layout only
    path = os.path.join(vdir, f"chunk_{s}.npy")
    crc, n = _file_crc(path)
    want_n = meta.get("chunk_bytes", {}).get(str(s))
    if want_n is not None and n != int(want_n):
        raise CheckpointCorruptionError(f"chunk {path!r} is truncated: {n} bytes on disk, {want_n} recorded at save time")
    if crc != int(checksums[str(s)]):
        raise CheckpointCorruptionError(f"chunk {path!r} fails its checksum: crc32 {crc:#010x} != recorded "
                                        f"{int(checksums[str(s)]):#010x}")


def _verify_version(vdir: str, comm: Communication) -> dict:
    """Integrity check of one version directory, the same verdict on every
    rank: the metadata and chunk set on each, each chunk's CRC32 on one rank
    (chunk i on rank i % p, read in blocks)."""
    err = None
    meta = None
    try:
        meta = _read_meta(vdir)
        for i, s in enumerate(meta["starts"]):
            if i % comm.size == comm.rank:
                _verify_chunk(vdir, meta, s)
    except CheckpointCorruptionError as e:
        err = e
    if comm.is_distributed():
        bad = comm.Allreduce(_ints(comm, [int(err is not None)]), "max")
        if int(bad.item()) and err is None:
            err = CheckpointCorruptionError(f"checkpoint {vdir!r} failed verification on another rank")
    if err is not None:
        raise err
    return meta


def _checkpoint_candidates(directory: str):
    """The versions to try, most preferred first: the one ``LATEST`` names,
    the others newest first, then the pre-versioned flat layout."""
    latest_target = None
    latest = os.path.join(directory, "LATEST")
    if os.path.exists(latest):
        latest_target = _read_file(latest).decode().strip()
    out = []
    if latest_target is not None and os.path.isdir(os.path.join(directory, latest_target)):
        out.append((os.path.join(directory, latest_target), latest_target))
    for v in sorted(_versions(directory), reverse=True):
        if f"v{v}" != latest_target:
            out.append((os.path.join(directory, f"v{v}"), f"v{v}"))
    if os.path.exists(os.path.join(directory, "meta.json")):
        out.append((directory, "<legacy flat layout>"))
    return out


@_telemetry.traced("io.load_array_checkpoint")
def load_array_checkpoint(directory: str, device=None, comm=None) -> DNDarray:
    """Restore a DNDarray saved by :func:`save_array_checkpoint`, at any
    world size: each rank reads, memory-mapped, the rows of its ``chunk``
    from the chunk files that overlap them.  Every candidate version is
    verified first (chunk set, CRC32s); where the one ``LATEST`` names fails,
    the newest older version that verifies is loaded, with a warning, and
    :class:`CheckpointCorruptionError` names every failure where none does."""
    comm = sanitize_comm(comm)
    if not os.path.isdir(directory):
        raise FileNotFoundError(f"checkpoint directory {directory!r} does not exist")
    _flightrec.record_event("ckpt", op="load_array", path=directory)
    candidates = _checkpoint_candidates(directory)
    if not candidates:
        raise FileNotFoundError(f"no checkpoint versions under {directory!r} (no LATEST, no v<k>/ directories, "
                                "no legacy meta.json)")
    meta, chosen, failures = None, None, []
    for vdir, label in candidates:
        try:
            meta = _verify_version(vdir, comm)
            chosen = (vdir, label)
            break
        except CheckpointCorruptionError as e:
            failures.append(f"{label}: {e}")
    if chosen is None:
        raise CheckpointCorruptionError(f"no loadable checkpoint under {directory!r}; every version failed "
                                        "verification: " + " | ".join(failures))
    if failures:
        warnings.warn(f"checkpoint version {candidates[0][1]} under {directory!r} failed verification "
                      f"({failures[0]}); falling back to {chosen[1]}", stacklevel=2)
    vdir = chosen[0]
    gshape = tuple(meta["gshape"])
    split = meta["split"]
    np_dtype = np.dtype(meta["dtype"])
    if split is None:
        return _registered_param(_read_hyperslab(lambda s: np.load(os.path.join(vdir, "chunk_0.npy")).reshape(gshape),
                                                 gshape, np_dtype, None, device, comm), "load_array_checkpoint")
    starts = sorted(meta["starts"])
    mmaps = [np.load(os.path.join(vdir, f"chunk_{s}.npy"), mmap_mode="r") for s in starts]

    def reader(slices):
        lo, hi = slices[split].start, slices[split].stop
        out = np.zeros(tuple(s.stop - s.start for s in slices), dtype=np_dtype)
        for s, mm in zip(starts, mmaps):
            a, b = max(lo, s), min(hi, s + mm.shape[split])
            if a < b:
                src = tuple(slice(a - s, b - s) if i == split else slice(None) for i in range(len(gshape)))
                dst = tuple(slice(a - lo, b - lo) if i == split else slice(None) for i in range(len(gshape)))
                out[dst] = mm[src]
        return out

    return _registered_param(_read_hyperslab(reader, gshape, np_dtype, split, device, comm), "load_array_checkpoint")


def _registered_param(x, op: str):
    """``x``'s local tensor registered in the memory ledger as a ``param``
    minted by a checkpoint load (a no-op while the ledger is disarmed)."""
    t = x.larray if isinstance(x, DNDarray) else x
    if isinstance(t, torch.Tensor):
        _memledger.register(t, op=op, site="ckpt", category="param")
    return x


# ---------------------------------------------------------------------- #
# pytree checkpoints
# ---------------------------------------------------------------------- #
# A tree is nested dicts (keys sorted, as jax.tree_util flattens them;
# an OrderedDict, such as a state_dict(), keeps its order), lists and
# tuples, whose leaves are tensors, DNDarrays, numpy arrays, numbers or
# strings; None is an empty subtree.  The key strings are
# ``jax.tree_util.keystr``'s (``['a']['b']``, ``[0]``), so that the files
# cross between the packages.
_NP_OF_TORCH = {torch.bool: np.bool_, torch.uint8: np.uint8, torch.int8: np.int8, torch.int16: np.int16,
                torch.int32: np.int32, torch.int64: np.int64, torch.float16: np.float16,
                torch.float32: np.float32, torch.float64: np.float64, torch.complex64: np.complex64,
                torch.complex128: np.complex128}


def _np_dtype_of(like):
    dt = getattr(like, "dtype", None)
    if dt is None:
        return None
    if isinstance(dt, torch.dtype):
        return np.dtype(_NP_OF_TORCH[dt]) if dt in _NP_OF_TORCH else None
    if isinstance(like, DNDarray):
        return _dtype_of(like)
    return np.dtype(dt)


def _flatten(tree, path: str = ""):
    """[(keystr, leaf)] in jax.tree_util's order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        keys = list(tree) if type(tree) is not dict else sorted(tree)
        out = []
        for k in keys:
            out += _flatten(tree[k], f"{path}[{k!r}]")
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += _flatten(v, f"{path}[{i}]")
        return out
    return [(path, tree)]


def _unflatten(tree, leaves):
    if tree is None:
        return None
    if isinstance(tree, dict):
        keys = list(tree) if type(tree) is not dict else sorted(tree)
        vals = {k: _unflatten(tree[k], leaves) for k in keys}
        return type(tree)((k, vals[k]) for k in tree)
    if isinstance(tree, (list, tuple)):
        vals = [_unflatten(v, leaves) for v in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") else type(tree)(vals)
    return next(leaves)


def _host_leaf(leaf) -> np.ndarray:
    if isinstance(leaf, DNDarray):
        if leaf.dtype is types.bfloat16:
            raise ValueError("bfloat16 leaves have no numpy representation; astype(float32) before saving")
        return leaf.numpy()
    if isinstance(leaf, torch.Tensor):
        return _host(leaf)
    return np.asarray(leaf)


@_telemetry.traced("io.save_checkpoint")
def save_checkpoint(tree, path: str) -> None:
    """Save a pytree of arrays (parameters, optimizer state) as an ``.npz``
    with ``__keys__`` (the leaves' key strings) and ``leaf_<i>``.  Atomic:
    the archive is written to a per-process ``<path>.tmp.<pid>``, fsynced
    and renamed over the destination, then the directory is fsynced.  A
    DNDarray leaf is gathered (every rank calls save together)."""
    final = path if path.endswith(".npz") else path + ".npz"
    _flightrec.record_event("ckpt", op="save_tree", path=final)
    flat = _flatten(tree)
    keys = [k for k, _ in flat]
    arrays = {f"leaf_{i}": _host_leaf(leaf) for i, (_, leaf) in enumerate(flat)}
    tmp = f"{final}.tmp.{os.getpid()}"

    def attempt():
        with open(tmp, "wb") as fh:
            np.savez(fh, __keys__=np.asarray(json.dumps(keys)), **arrays)
            fh.flush()
            _faults.fire("io.write", path=tmp)
            _faults.fire("io.fsync", path=tmp)
            os.fsync(fh.fileno())

    _retry(attempt, "io.write")
    _telemetry.counter_inc("io.bytes_written", os.path.getsize(tmp))
    _telemetry.counter_inc("io.fsync.calls")
    os.replace(tmp, final)
    _fsync_dir(os.path.dirname(os.path.abspath(final)))


def _restore_leaf(arr: np.ndarray, like):
    if isinstance(like, DNDarray):
        t = _tensor(arr).to(like.larray.device)
        if like.is_distributed():
            t = t[like.comm.chunk(like.shape, like.split)[2]].contiguous()
        return DNDarray(t, like.shape, like.dtype, like.split, like.device, like.comm, True)
    if isinstance(like, torch.Tensor):
        return _tensor(arr).to(like.device)
    if isinstance(like, np.ndarray):
        return arr
    if isinstance(like, (bool, int, float, complex, str)):
        return type(like)(arr.item() if arr.ndim == 0 else arr)
    return arr


@_telemetry.traced("io.load_checkpoint")
def load_checkpoint(tree_like, path: str):
    """Restore a pytree saved by :func:`save_checkpoint` into the structure
    of ``tree_like``, each leaf of its kind there (a tensor on that tensor's
    device, a DNDarray with its split, a number).  An unreadable archive
    raises :class:`CheckpointCorruptionError`; other key paths, shapes or
    dtypes than ``tree_like``'s raise ``ValueError``."""
    import zipfile

    p = path if path.endswith(".npz") else path + ".npz"
    if not os.path.exists(p):
        raise FileNotFoundError(f"checkpoint file {p!r} does not exist" + (f" (given path {path!r})" if p != path else ""))
    _flightrec.record_event("ckpt", op="load_tree", path=p)
    try:
        data = np.load(p, allow_pickle=False)
        saved_keys = json.loads(str(data["__keys__"]))
    except KeyError as e:
        raise CheckpointCorruptionError(f"checkpoint {p!r} has no '__keys__' entry: not a pytree checkpoint, "
                                        "or truncated mid-write") from e
    except (zipfile.BadZipFile, OSError, ValueError, EOFError) as e:
        raise CheckpointCorruptionError(f"checkpoint {p!r} is unreadable (truncated or corrupt): {e}") from e
    flat = _flatten(tree_like)
    live_keys = [k for k, _ in flat]
    if saved_keys != live_keys:
        raise ValueError(f"checkpoint structure mismatch: saved paths {saved_keys[:3]}... != target paths "
                         f"{live_keys[:3]}...")
    leaves = []
    for i, (name, like) in enumerate(flat):
        try:
            arr = data[f"leaf_{i}"]
        except KeyError as e:
            raise CheckpointCorruptionError(f"checkpoint {p!r} lacks leaf_{i} ({name}): truncated archive") from e
        except (zipfile.BadZipFile, zlib.error, OSError) as e:
            raise CheckpointCorruptionError(f"checkpoint {p!r}: leaf_{i} ({name}) is corrupt: {e}") from e
        want_shape = getattr(like, "shape", None)
        if want_shape is not None and tuple(arr.shape) != tuple(want_shape):
            raise ValueError(f"checkpoint {p!r}: leaf {name} has shape {tuple(arr.shape)} but the target tree "
                             f"expects {tuple(want_shape)}: refusing to load a reshaped parameter")
        want_dtype = _np_dtype_of(like)
        if want_dtype is not None and np.dtype(arr.dtype) != want_dtype:
            raise ValueError(f"checkpoint {p!r}: leaf {name} has dtype {np.dtype(arr.dtype)} but the target tree "
                             f"expects {want_dtype}")
        leaves.append(_registered_param(_restore_leaf(arr, like), "load_checkpoint"))
    data.close()
    return _unflatten(tree_like, iter(leaves))
