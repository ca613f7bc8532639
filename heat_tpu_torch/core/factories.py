"""Array factories (reference: ``heat/core/factories.py``).

Each factory builds only this process's chunk of the array, directly on the
target device.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from . import types
from .communication import Communication, sanitize_comm
from .devices import sanitize_device
from .dndarray import DNDarray
from .stride_tricks import sanitize_axis, sanitize_shape

__all__ = [
    "arange",
    "array",
    "asarray",
    "empty",
    "empty_like",
    "eye",
    "from_partitioned",
    "full",
    "full_like",
    "linspace",
    "logspace",
    "meshgrid",
    "ones",
    "ones_like",
    "zeros",
    "zeros_like",
]


# The 64-bit types and what the reference makes of them on ingest: JAX with
# x64 off keeps none (jnp.asarray in heat_tpu/core/factories.py::array; full's
# float64 fill), so default ingest of numpy and Python data narrows them.
_NARROWED = {types.float64: types.float32, types.int64: types.int32, types.complex128: types.complex64}


def narrow_64bit(npa: np.ndarray) -> np.ndarray:
    """``npa`` with a float64, int64 or complex128 dtype narrowed to 32 bits, as the reference ingests it."""
    narrow = _NARROWED.get(types.canonical_heat_type(npa.dtype)) if npa.dtype.kind in "fic" else None
    return npa if narrow is None else npa.astype(narrow._name)


def _sanitize(device, comm):
    device = sanitize_device(device)
    return device, device.torch_device, sanitize_comm(comm)


def array(
    obj,
    dtype=None,
    copy: Optional[bool] = None,
    ndmin: int = 0,
    order: str = "C",
    split: Optional[int] = None,
    is_split: Optional[int] = None,
    device=None,
    comm: Optional[Communication] = None,
) -> DNDarray:
    """Create a DNDarray from array-like data.

    ``split=k`` treats ``obj`` as the GLOBAL array and keeps this rank's
    chunk of axis ``k``; ``is_split=k`` treats ``obj`` as this rank's LOCAL
    chunk along ``k`` and derives the global shape from all ranks.
    Without ``dtype``, numpy and Python data of 64 bits is narrowed as the
    reference ingests it (float64 to float32, int64 to int32, complex128 to
    complex64); an explicit ``dtype`` is kept, float64 too, and so is the
    dtype of a ``torch.Tensor`` or DNDarray given as it is.
    """
    if split is not None and is_split is not None:
        raise ValueError("split and is_split are mutually exclusive")
    if isinstance(obj, DNDarray):
        device = obj.device if device is None else device
        comm = obj.comm if comm is None else comm
        if split is None and is_split is None:
            split = obj.split
        if obj.is_distributed() and split != obj.split:
            raise NotImplementedError("changing the split of a distributed array (resplit) is not ported yet")
        t = obj.larray
        if obj.is_distributed():
            is_split, split = obj.split, None
    elif isinstance(obj, torch.Tensor):
        t = obj
    else:
        npa = np.asarray(obj)
        if npa.dtype == object:
            raise TypeError("invalid data of type object")
        if dtype is None:
            npa = narrow_64bit(npa)
        t = torch.from_numpy(np.array(npa, order="C", copy=None if npa.flags.writeable else True))
    device, tdev, comm = _sanitize(device, comm)
    if dtype is not None:
        dtype = types.canonical_heat_type(dtype)
        t = t.to(dtype.torch_type())
    while t.ndim < ndmin:
        t = t.unsqueeze(0)

    if is_split is not None:
        is_split = sanitize_axis(tuple(t.shape), is_split)
        t = t.to(device=tdev, copy=copy is not False).contiguous()
        size = torch.tensor([t.shape[is_split]], dtype=torch.int64, device=tdev)
        counts = [int(c.item()) for c in comm.Allgather(size)]
        gshape = tuple(t.shape[:is_split]) + (sum(counts),) + tuple(t.shape[is_split + 1 :])
        balanced = tuple(counts) == comm.counts_displs_shape(gshape, is_split)[0]
        return DNDarray(t, gshape, types.canonical_heat_type(t.dtype), is_split, device, comm, balanced)

    split = sanitize_axis(tuple(t.shape), split)
    gshape = tuple(t.shape)
    if split is not None:
        t = t[comm.chunk(gshape, split)[2]]
    t = t.to(device=tdev, copy=copy is not False).contiguous()
    return DNDarray(t, gshape, types.canonical_heat_type(t.dtype), split, device, comm, True)


def asarray(obj, dtype=None, copy=None, order="C", is_split=None, device=None) -> DNDarray:
    return array(obj, dtype=dtype, copy=copy, order=order, is_split=is_split, device=device)


def _filled(fill, shape, dtype, split, device, comm) -> DNDarray:
    shape = sanitize_shape(shape)
    split = sanitize_axis(shape, split)
    dtype = types.canonical_heat_type(dtype)
    device, tdev, comm = _sanitize(device, comm)
    lshape = comm.chunk(shape, split)[1]
    t = fill(lshape, dtype=dtype.torch_type(), device=tdev)
    return DNDarray(t, shape, dtype, split, device, comm, True)


def zeros(shape, dtype=types.float32, split=None, device=None, comm=None, order="C") -> DNDarray:
    return _filled(torch.zeros, shape, dtype, split, device, comm)


def ones(shape, dtype=types.float32, split=None, device=None, comm=None, order="C") -> DNDarray:
    return _filled(torch.ones, shape, dtype, split, device, comm)


def empty(shape, dtype=types.float32, split=None, device=None, comm=None, order="C") -> DNDarray:
    return _filled(torch.empty, shape, dtype, split, device, comm)


def full(shape, fill_value, dtype=None, split=None, device=None, comm=None, order="C") -> DNDarray:
    if dtype is None:  # a 64-bit fill narrowed as array() narrows data
        dtype = types.heat_type_of(fill_value)
        dtype = _NARROWED.get(dtype, dtype)

    def fill(lshape, dtype, device):
        return torch.full(lshape, fill_value, dtype=dtype, device=device)

    return _filled(fill, shape, dtype, split, device, comm)


def arange(*args, dtype=None, split=None, device=None, comm=None) -> DNDarray:
    """``arange([start,] stop[, step])`` with only this rank's chunk built."""
    if not 1 <= len(args) <= 3:
        raise TypeError(f"arange takes 1 to 3 positional arguments, got {len(args)}")
    start, stop, step = (0, args[0], 1) if len(args) == 1 else (args + (1,))[:3]
    if step == 0:
        raise ValueError("arange: step must not be 0")
    num = max(int(math.ceil((stop - start) / step)), 0)
    if dtype is None:
        exact = all(isinstance(a, (int, np.integer)) for a in (start, stop, step))
        dtype = types.int32 if exact else types.float32
    dtype = types.canonical_heat_type(dtype)
    device, tdev, comm = _sanitize(device, comm)
    split = sanitize_axis((num,), split)
    off, (cnt,), _ = comm.chunk((num,), split)
    idx = torch.arange(off, off + cnt, device=tdev, dtype=torch.float64)
    t = (start + idx * step).to(dtype.torch_type())
    return DNDarray(t, (num,), dtype, split, device, comm, True)


def _like(proto, factory, dtype, split, device, comm, **kw) -> DNDarray:
    if not isinstance(proto, DNDarray):
        proto = array(proto)
    return factory(
        proto.shape,
        dtype=dtype if dtype is not None else proto.dtype,
        split=split if split is not None else proto.split,
        device=device if device is not None else proto.device,
        comm=comm if comm is not None else proto.comm,
        **kw,
    )


def zeros_like(a, dtype=None, split=None, device=None, comm=None, order="C") -> DNDarray:
    return _like(a, zeros, dtype, split, device, comm)


def ones_like(a, dtype=None, split=None, device=None, comm=None, order="C") -> DNDarray:
    return _like(a, ones, dtype, split, device, comm)


def empty_like(a, dtype=None, split=None, device=None, comm=None, order="C") -> DNDarray:
    return _like(a, empty, dtype, split, device, comm)


def full_like(a, fill_value, dtype=None, split=None, device=None, comm=None, order="C") -> DNDarray:
    return _like(a, full, dtype, split, device, comm, fill_value=fill_value)


def _spaced(start, stop, num: int, endpoint: bool, split, device, comm):
    """This rank's chunk of ``num`` evenly spaced float64 values (the last
    exactly ``stop`` with ``endpoint``), and its metadata."""
    num = int(num)
    if num < 0:
        raise ValueError(f"Number of samples, {num}, must be non-negative")
    device, tdev, comm = _sanitize(device, comm)
    split = sanitize_axis((num,), split)
    off, (cnt,), _ = comm.chunk((num,), split)
    div = (num - 1) if endpoint else num
    step = (float(stop) - float(start)) / div if div > 0 else 0.0
    idx = torch.arange(off, off + cnt, device=tdev, dtype=torch.float64)
    t = float(start) + idx * step
    if endpoint and num > 1 and off + cnt == num:
        t[-1] = float(stop)
    return t, step, split, device, comm


def linspace(start, stop, num: int = 50, endpoint: bool = True, retstep: bool = False, dtype=None, split=None,
             device=None, comm=None):
    """``num`` evenly spaced values over [start, stop] (float32 unless
    ``dtype``); each rank computes its own chunk."""
    t, step, split, device, comm = _spaced(start, stop, num, endpoint, split, device, comm)
    dtype = types.canonical_heat_type(types.float32 if dtype is None else dtype)
    res = DNDarray(t.to(dtype.torch_type()), (int(num),), dtype, split, device, comm, True)
    return (res, step) if retstep else res


def logspace(start, stop, num=50, endpoint=True, base=10.0, dtype=None, split=None, device=None, comm=None) -> DNDarray:
    """``base ** linspace(start, stop, num)``; each rank computes its own chunk."""
    t, _, split, device, comm = _spaced(start, stop, num, endpoint, split, device, comm)
    dtype = types.canonical_heat_type(types.float32 if dtype is None else dtype)
    return DNDarray(torch.pow(float(base), t).to(dtype.torch_type()), (int(num),), dtype, split, device, comm, True)


def eye(shape, dtype=types.float32, split=None, device=None, comm=None) -> DNDarray:
    """The (n, m) identity; each rank builds its chunk of rows or columns."""
    if isinstance(shape, (int, np.integer)):
        n, m = int(shape), int(shape)
    else:
        shape = sanitize_shape(shape)
        n, m = (shape[0], shape[0]) if len(shape) == 1 else shape[:2]
    dtype = types.canonical_heat_type(dtype)
    device, tdev, comm = _sanitize(device, comm)
    split = sanitize_axis((n, m), split)
    _, _, (rows, cols) = comm.chunk((n, m), split)
    r = torch.arange(rows.start, rows.stop, device=tdev)
    c = torch.arange(cols.start, cols.stop, device=tdev)
    t = (r[:, None] == c[None, :]).to(dtype.torch_type())
    return DNDarray(t, (n, m), dtype, split, device, comm, True)


def meshgrid(*arrays, indexing: str = "xy") -> list:
    """Coordinate matrices from vectors.  Where an input is split, every
    output is split along the axis along which that input varies (the JAX
    package's rule); each rank builds its chunk from its slice of that
    vector and the other vectors whole."""
    if indexing not in ("xy", "ij"):
        raise ValueError(f"indexing must be 'xy' or 'ij', got {indexing!r}")
    proto = next((a for a in arrays if isinstance(a, DNDarray)), None)
    device = proto.device if proto is not None else None
    comm = proto.comm if proto is not None else None
    vecs = [a if isinstance(a, DNDarray) else array(a, device=device, comm=comm) for a in arrays]
    n = len(vecs)

    def out_axis(i):
        return 1 - i if indexing == "xy" and n >= 2 and i in (0, 1) else i

    split_in = next((i for i, a in enumerate(arrays) if isinstance(a, DNDarray) and a.split is not None), None)
    out_split = None if split_in is None else out_axis(split_in)
    shape = [0] * n
    for i, v in enumerate(vecs):
        shape[out_axis(i)] = v.shape[0]
    locals_ = []
    for i, v in enumerate(vecs):
        t = v.larray if not v.is_distributed() else torch.as_tensor(v.numpy(), device=v.larray.device)
        if out_split is not None and out_axis(i) == out_split:
            if v.is_distributed() and v.balanced:
                t = v.larray
            else:
                t = t[vecs[0].comm.chunk(tuple(shape), out_split)[2][out_split]]
        locals_.append(t.reshape(-1))
    lshape = [0] * n
    for i, t in enumerate(locals_):
        lshape[out_axis(i)] = t.numel()
    ref, outs = vecs[0], []
    for i, t in enumerate(locals_):  # each output keeps its vector's dtype
        view = [1] * n
        view[out_axis(i)] = -1
        o = t.reshape(view).expand(lshape).contiguous()
        outs.append(DNDarray(o, tuple(shape), types.canonical_heat_type(o.dtype), out_split, ref.device, ref.comm,
                             True))
    return outs


def from_partitioned(x, comm=None) -> DNDarray:
    """The DNDarray of an object exposing ``__partitioned__`` (the inverse
    of :attr:`DNDarray.__partitioned__`).  Split along the axis that the
    partition tiling divides (none: replicated).  Where every partition
    carries its data, they are put together and this rank keeps its chunk;
    where only this process's do (as a distributed DNDarray's), each rank
    takes its own as its local part."""
    parts = x.__partitioned__
    shape = tuple(parts["shape"])
    tiling = tuple(parts.get("partition_tiling", (1,) * len(shape)))
    split = next((i for i, t in enumerate(tiling) if t > 1), None)
    get = parts.get("get", lambda v: v)
    partitions = parts["partitions"]
    if split is None:
        pos = next(iter(parts.get("locals", partitions)))
        return array(get(partitions[pos]["data"]), comm=comm)
    order = sorted(partitions, key=lambda p: partitions[p]["start"][split])
    if all(partitions[p]["data"] is not None for p in order):
        data = [np.asarray(get(partitions[p]["data"]).cpu() if isinstance(partitions[p]["data"], torch.Tensor)
                           else get(partitions[p]["data"])) for p in order]
        return array(np.concatenate(data, axis=split).reshape(shape), split=split, comm=comm)
    local = get(partitions[tuple(parts["locals"][0])]["data"])
    return array(local, is_split=split, comm=comm)


def identity(n: int, dtype=types.float32, split=None, device=None, comm=None) -> DNDarray:
    """The (n, n) identity matrix."""
    return eye(int(n), dtype=dtype, split=split, device=device, comm=comm)


def geomspace(start, stop, num: int = 50, endpoint: bool = True, dtype=None, split=None, device=None,
              comm=None) -> DNDarray:
    """``num`` samples spaced evenly on a log scale from ``start`` to ``stop``
    (both kept exactly); each rank computes its own chunk."""
    if start == 0 or stop == 0:
        raise ValueError("Geometric sequence cannot include zero")
    t, _, split, device, comm = _spaced(0.0, 1.0, num, endpoint, split, device, comm)
    if (start < 0) != (stop < 0):
        raise ValueError("geomspace across zero needs complex samples, which are not supported")
    vals = float(start) * torch.pow(float(stop) / float(start), t)
    num = int(num)
    off, (cnt,), _ = comm.chunk((num,), split)
    if cnt and off == 0:
        vals[0] = float(start)
    if cnt and endpoint and num > 1 and off + cnt == num:
        vals[-1] = float(stop)
    dtype = types.canonical_heat_type(types.float32 if dtype is None else dtype)
    return DNDarray(vals.to(dtype.torch_type()), (num,), dtype, split, device, comm, True)


def tri(N: int, M=None, k: int = 0, dtype=types.float32, split=None, device=None, comm=None) -> DNDarray:
    """The (N, M) matrix of ones at and below the ``k``-th diagonal; each rank
    builds its chunk."""
    n, m = int(N), int(N if M is None else M)
    dtype = types.canonical_heat_type(dtype)
    device, tdev, comm = _sanitize(device, comm)
    split = sanitize_axis((n, m), split)
    _, _, (rows, cols) = comm.chunk((n, m), split)
    r = torch.arange(rows.start, rows.stop, device=tdev)
    c = torch.arange(cols.start, cols.stop, device=tdev)
    t = (c[None, :] <= r[:, None] + int(k)).to(dtype.torch_type())
    return DNDarray(t, (n, m), dtype, split, device, comm, True)


def vander(x, N=None, increasing: bool = False) -> DNDarray:
    """The Vandermonde matrix of the 1-D ``x``: column j holds ``x`` to the
    power N - 1 - j (j with ``increasing``).  The rows follow ``x``'s split:
    each rank raises its own elements."""
    if not isinstance(x, DNDarray):
        x = array(x)
    if x.ndim != 1:
        raise ValueError("x must be a one-dimensional array")
    n = x.gshape[0] if N is None else int(N)
    t = x.larray
    powers = torch.arange(n, device=t.device, dtype=t.dtype if t.dtype != torch.bool else torch.int32)
    if not increasing:
        powers = powers.flip(0)
    v = torch.pow(t[:, None], powers[None, :])
    split = 0 if x.split is not None else None
    return DNDarray(v, (x.gshape[0], n), types.canonical_heat_type(v.dtype), split, x.device, x.comm, x.balanced)


def indices(dimensions, dtype=types.int32, sparse: bool = False):
    """The grid's index arrays (numpy's ``indices``), replicated: one array
    of shape (len(dimensions), *dimensions), or with ``sparse`` a tuple of
    arrays each varying along its own axis."""
    dims = tuple(int(d) for d in dimensions)
    dtype = types.canonical_heat_type(dtype)
    device, tdev, comm = _sanitize(None, None)
    nd = len(dims)
    axes = [torch.arange(d, device=tdev, dtype=dtype.torch_type()) for d in dims]
    views = [a.reshape([-1 if i == j else 1 for j in range(nd)]) for i, a in enumerate(axes)]
    if sparse:
        return tuple(DNDarray(v.contiguous(), tuple(v.shape), dtype, None, device, comm, True) for v in views)
    t = torch.stack([v.expand(dims) for v in views]) if nd else torch.empty((0,), dtype=dtype.torch_type(), device=tdev)
    return DNDarray(t, tuple(t.shape), dtype, None, device, comm, True)


def ix_(*args):
    """Open-mesh index arrays of the 1-D sequences ``args`` (numpy's ``ix_``),
    replicated: the i-th varies along axis i."""
    nd = len(args)
    out = []
    for i, a in enumerate(args):
        v = (a.resplit(None) if a.is_distributed() else a) if isinstance(a, DNDarray) else array(a)
        t = v.larray
        if t.dtype == torch.bool:
            t = t.nonzero().reshape(-1).to(torch.int32)
        t = t.reshape([-1 if j == i else 1 for j in range(nd)])
        out.append(DNDarray(t, tuple(t.shape), types.canonical_heat_type(t.dtype), None, v.device, v.comm, True))
    return tuple(out)


def diag_indices(n: int, ndim: int = 2):
    """The indices of the main diagonal of an n x ... x n array of ``ndim``
    axes: ``ndim`` copies of ``arange(n)``, replicated."""
    return tuple(arange(int(n)) for _ in range(int(ndim)))


def diag_indices_from(arr) -> tuple:
    """:func:`diag_indices` of the square ``arr``."""
    if arr.ndim < 2 or len(set(arr.shape)) != 1:
        raise ValueError("input must be square along every axis")
    return diag_indices(arr.shape[0], arr.ndim)


def tril_indices_from(arr, k: int = 0):
    """The indices of the lower triangle of the 2-D ``arr``."""
    from .indexing import tril_indices

    if arr.ndim != 2:
        raise ValueError("input must be 2-D")
    return tril_indices(arr.shape[0], k=k, m=arr.shape[1])


def triu_indices_from(arr, k: int = 0):
    """The indices of the upper triangle of the 2-D ``arr``."""
    from .indexing import triu_indices

    if arr.ndim != 2:
        raise ValueError("input must be 2-D")
    return triu_indices(arr.shape[0], k=k, m=arr.shape[1])


def _indices_like(t: torch.Tensor, proto: Optional[DNDarray]) -> DNDarray:
    """Index tensor ``t``, computed from ``proto``'s local part, as a
    DNDarray of ``proto``'s split and layout (replicated without one)."""
    if proto is None:
        device, _, comm = _sanitize(None, None)
        return DNDarray(t, tuple(t.shape), types.canonical_heat_type(t.dtype), None, device, comm, True)
    gshape = proto.gshape
    return DNDarray(t, gshape, types.canonical_heat_type(t.dtype), proto.split, proto.device, proto.comm,
                    proto.balanced)


def unravel_index(idx, shape):
    """The coordinates in an array of ``shape`` of the flat indices ``idx``,
    one array per axis, of ``idx``'s shape, split and dtype.  As in the
    reference, a negative index counts from the end and one out of range is
    clipped."""
    proto = idx if isinstance(idx, DNDarray) else None
    t = (proto if proto is not None else array(idx)).larray
    dims = tuple(int(s) for s in shape)
    size = int(np.prod(dims, dtype=np.int64))
    flat = torch.where(t < 0, t + size, t).clamp(0, max(size - 1, 0)).to(torch.int64)
    out = []
    for d in reversed(dims):
        out.append(flat % d)
        flat = flat // d
    return tuple(_indices_like(c.to(t.dtype), proto) for c in reversed(out))


def ravel_multi_index(multi_index, dims, mode: str = "raise", order: str = "C"):
    """The flat indices in an array of shape ``dims`` of the coordinates
    ``multi_index`` (one sequence an axis): ``mode`` 'raise' refuses a
    coordinate out of range, 'clip' clips it, 'wrap' wraps it; ``order`` 'C'
    (row-major) or 'F'.  Of the first DNDarray coordinate's split, else
    replicated; int32, the reference's dtype."""
    proto = next((m for m in multi_index if isinstance(m, DNDarray)), None)
    coords = [(m if isinstance(m, DNDarray) else array(m)).larray.to(torch.int64) for m in multi_index]
    dims = tuple(int(d) for d in dims)
    if mode == "raise":
        for c, d in zip(coords, dims):
            if c.numel() and bool(((c < 0) | (c >= d)).any()):
                raise ValueError(f"invalid entry in coordinates array (dim {d})")
    elif mode == "clip":
        coords = [c.clamp(0, d - 1) for c, d in zip(coords, dims)]
    elif mode == "wrap":
        coords = [c % d for c, d in zip(coords, dims)]
    else:
        raise ValueError(f"clipmode must be one of 'clip', 'raise', or 'wrap', got {mode!r}")
    pairs = list(zip(coords, dims))
    if order == "F":
        pairs = pairs[::-1]
    elif order != "C":
        raise ValueError(f"order must be 'C' or 'F', got {order!r}")
    flat = torch.zeros_like(pairs[0][0])
    for c, d in pairs:
        flat = flat * d + c
    return _indices_like(flat.to(torch.int32), proto)


def _window(values: np.ndarray) -> DNDarray:
    """A window (numpy's, in float64) as a replicated float32 DNDarray, the
    reference's dtype."""
    return array(values.astype(np.float32))


def bartlett(M: int) -> DNDarray:
    """The Bartlett (triangular) window of ``M`` points."""
    return _window(np.bartlett(int(M)))


def blackman(M: int) -> DNDarray:
    """The Blackman window of ``M`` points."""
    return _window(np.blackman(int(M)))


def hamming(M: int) -> DNDarray:
    """The Hamming window of ``M`` points."""
    return _window(np.hamming(int(M)))


def hanning(M: int) -> DNDarray:
    """The Hann window of ``M`` points."""
    return _window(np.hanning(int(M)))


def kaiser(M: int, beta: float) -> DNDarray:
    """The Kaiser window of ``M`` points and shape ``beta``."""
    return _window(np.kaiser(int(M), float(beta)))


__all__ += [
    "bartlett",
    "blackman",
    "diag_indices",
    "diag_indices_from",
    "geomspace",
    "hamming",
    "hanning",
    "identity",
    "indices",
    "ix_",
    "kaiser",
    "ravel_multi_index",
    "tri",
    "tril_indices_from",
    "triu_indices_from",
    "unravel_index",
    "vander",
]
