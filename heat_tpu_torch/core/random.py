"""Random sampling (reference: ``heat_tpu/core/random.py``).

The reference's contract: every value is a function of the seed, the call
counter and the element's flat global index, so a draw is the same at every
world size and every split.  The key of a draw is ``fold_in(key(seed),
counter)`` (``batchparallel`` mode also folds in the rank), and the bits of
element ``i`` are the Threefry-2x32 hash of ``i``'s high and low 32-bit words
under that key, the two output words xor-ed: jax's partitionable
``threefry2x32``, here in torch integer ops (int32 holding uint32 words).
Each rank hashes only the flat indices of its own chunk, in slices of
``_CHUNK`` elements, so the temporaries stay bounded.  The uniform
family and ``randint`` are jax's to the bit; the normal family is
``sqrt(2) * erfinv(u)`` of jax's ``u``, within float32 rounding of
``erfinv``.  ``permutation`` is jax's ``_shuffle``: stable sorts of the
range by fresh random 32-bit keys, each distributed over the ranks by
:func:`heat_tpu_torch.parallel.sample_sort.sample_sort_1d`.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from . import types
from .communication import sanitize_comm
from .devices import sanitize_device
from .dndarray import DNDarray
from .stride_tricks import sanitize_shape

__all__ = [
    "derive_seed",
    "get_state",
    "host_rng",
    "normal",
    "permutation",
    "rand",
    "randint",
    "randn",
    "random",
    "random_integer",
    "random_sample",
    "randperm",
    "ranf",
    "sample",
    "seed",
    "set_state",
    "standard_normal",
    "uniform",
]

# global RNG state: (mode, seed, counter)
__seed: int = 0
__counter: int = 0
__mode: str = "threefry"

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# flat indices hashed at once: bounds the int64 temporaries of a draw
_CHUNK = 1 << 24


def seed(seed: Optional[int] = None) -> None:
    """(Re-)seed the global generator; ``None`` takes fresh entropy, rank
    0's on every rank."""
    global __seed, __counter
    if seed is None:
        seed = int(np.random.SeedSequence().entropy % (2**63))
        comm = sanitize_comm(None)
        if comm.is_distributed():
            t = torch.tensor([seed], dtype=torch.int64, device=comm._scratch_device())
            seed = int(comm.Bcast(t).item())
    __seed = int(seed)
    __counter = 0


def get_state() -> Tuple[str, int, int, int, float]:
    """Reference-compatible state tuple (name, seed, counter, _, _)."""
    return ("Threefry" if __mode == "threefry" else "Batchparallel", __seed, __counter, 0, 0.0)


def set_state(state: Tuple) -> None:
    global __seed, __counter, __mode
    if state[0] not in ("Threefry", "Batchparallel"):
        raise ValueError(f"unknown RNG type {state[0]}")
    __mode = state[0].lower()
    __seed = int(state[1])
    __counter = int(state[2]) if len(state) > 2 else 0


def host_rng(seed: int) -> np.random.Generator:
    """Host-side numpy ``Generator`` for an explicitly seeded draw: the
    caller supplies a seed that is the same on every rank (a literal, a
    broadcast value, or :func:`derive_seed`)."""
    return np.random.default_rng(seed)


def derive_seed() -> int:
    """Rank-uniform 63-bit seed derived from the global ``(seed, counter)``
    state, which it advances like a draw: every rank in lockstep derives the
    same value with no communication."""
    global __counter
    ss = np.random.SeedSequence(entropy=__seed, spawn_key=(__counter,))
    __counter += 1
    return int(ss.generate_state(1, dtype=np.uint64)[0] >> 1)


def generator(seed: int, *stream: int, device=None) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from ``seed`` and ``stream``
    (for host-side draws that need no split invariance)."""
    ss = np.random.SeedSequence(entropy=int(seed), spawn_key=tuple(int(s) for s in stream))
    g = torch.Generator(device=device if device is not None else "cpu")
    g.manual_seed(int(ss.generate_state(1, dtype=np.uint64)[0] >> 1))
    return g


# ---------------------------------------------------------------------- #
# Threefry-2x32 (jax/_src/prng.py), on int32 tensors holding uint32 words
# ---------------------------------------------------------------------- #
def _i32(v: int) -> int:
    """The uint32 word ``v`` as the int32 of the same bits."""
    v &= _M32
    return v - (1 << 32) if v >> 31 else v


def _threefry(k1: int, k2: int, x0: torch.Tensor, x1: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash of the word pairs ``(x0, x1)`` under the key
    ``(k1, k2)``: 20 rounds, a key injection every 4.  ``x0`` and ``x1`` are
    int32 tensors holding the words' bits, overwritten: sums wrap modulo
    2^32 as two's-complement int32 sums do, and a right shift is masked to
    its logical bits."""
    ks = (k1, k2, (k1 ^ k2 ^ 0x1BD11BDA) & _M32)
    x0.add_(_i32(ks[0]))
    x1.add_(_i32(ks[1]))
    tmp = torch.empty_like(x1)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0.add_(x1)
            torch.bitwise_left_shift(x1, r, out=tmp)
            x1.bitwise_right_shift_(32 - r).bitwise_and_((1 << r) - 1).bitwise_or_(tmp).bitwise_xor_(x0)
        x0.add_(_i32(ks[(i + 1) % 3]))
        x1.add_(_i32(ks[(i + 2) % 3] + i + 1))
    return x0, x1


def _words(idx: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The high and low 32-bit words of the int64 flat indices, as int32 bits."""
    lo = idx & _M32
    return (idx >> 32).to(torch.int32), torch.where(lo > 0x7FFFFFFF, lo - (1 << 32), lo).to(torch.int32)


def _hash_pair(key: Tuple[int, int], a: int, b: int) -> Tuple[int, int]:
    x0, x1 = _threefry(key[0], key[1], torch.tensor([_i32(a)], dtype=torch.int32),
                       torch.tensor([_i32(b)], dtype=torch.int32))
    return int(x0.item()) & _M32, int(x1.item()) & _M32


def _key(seed: int) -> Tuple[int, int]:
    """``jax.random.key(seed)`` with 64-bit types off: the seed's low word."""
    return (0, int(seed) & _M32)


def _fold_in(key: Tuple[int, int], data: int) -> Tuple[int, int]:
    """``jax.random.fold_in``: the hash of the counter pair ``(0, data)``."""
    return _hash_pair(key, 0, int(data) & _M32)


def _split(key: Tuple[int, int]) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """``jax.random.split(key)`` (partitionable): the hashes of the counters
    0 and 1, each one key."""
    x0, x1 = _threefry(key[0], key[1], torch.zeros(2, dtype=torch.int32), torch.tensor([0, 1], dtype=torch.int32))
    w0, w1 = [int(v) & _M32 for v in x0.tolist()], [int(v) & _M32 for v in x1.tolist()]
    return (w0[0], w1[0]), (w0[1], w1[1])


def _next_key(comm) -> Tuple[int, int]:
    global __counter
    key = _fold_in(_key(__seed), __counter)
    __counter += 1
    if __mode == "batchparallel":
        key = _fold_in(key, comm.rank)
    return key


def _chunk_indices(gshape, split: Optional[int], offset: int, count: int, device):
    """The flat global indices of a rank's chunk (``count`` entries of the
    split axis from ``offset``) in row-major order of the local tensor, in
    pieces of about ``_CHUNK`` elements: (start in the local flat order,
    int64 index tensor)."""
    gshape = tuple(gshape)
    if split is None or split == 0 or not gshape:
        inner = math.prod(gshape[1:]) if gshape else 1
        lo = offset * inner
        total = count * inner if gshape else 1
        for s in range(0, total, _CHUNK):
            yield s, torch.arange(lo + s, lo + min(s + _CHUNK, total), dtype=torch.int64, device=device)
        return
    outer, n, inner = math.prod(gshape[:split]), gshape[split], math.prod(gshape[split + 1:])
    block = max(count * inner, 1)
    rows = max(_CHUNK // block, 1)
    j = torch.arange(offset, offset + count, dtype=torch.int64, device=device)[None, :, None]
    i = torch.arange(inner, dtype=torch.int64, device=device)[None, None, :]
    for o0 in range(0, outer, rows):
        o = torch.arange(o0, min(o0 + rows, outer), dtype=torch.int64, device=device)[:, None, None]
        yield o0 * block, ((o * n + j) * inner + i).reshape(-1)


def _bits(key: Tuple[int, int], idx: torch.Tensor, width: int = 32) -> torch.Tensor:
    """jax's partitionable random bits of the flat indices ``idx`` (int64):
    ``width`` 32 the xor of the two hashed words (int32 bits), 8 and 16 its
    low bits (non-negative int32), 64 the words joined (int64 bits)."""
    x0, x1 = _threefry(key[0], key[1], *_words(idx))
    if width == 64:
        return ((x0.to(torch.int64) & _M32) << 32) | (x1.to(torch.int64) & _M32)
    bits = x0.bitwise_xor_(x1)
    return bits if width == 32 else bits.bitwise_and_((1 << width) - 1)


def _u32(bits: torch.Tensor) -> torch.Tensor:
    """32 random bits (int32) as the non-negative int64 word."""
    return bits.to(torch.int64) & _M32


def _fill(shape, split, comm, device, dtype: torch.dtype, fn) -> torch.Tensor:
    """This rank's chunk of a draw of global ``shape``: ``fn(idx)`` of every
    slice of its flat global indices, written into a tensor of ``dtype``."""
    off, lshape, _ = comm.chunk(shape, split)
    count = lshape[split] if split is not None else (shape[0] if shape else 1)
    out = torch.empty(lshape, dtype=dtype, device=device)
    flat = out.view(-1)
    for start, idx in _chunk_indices(shape, split, off, count, device):
        flat[start:start + idx.numel()] = fn(idx)
    return out


def _uniform_of_bits(bits: torch.Tensor, dtype: torch.dtype, lo, hi) -> torch.Tensor:
    """jax's ``_uniform`` from the random bits: the mantissa bits under an
    exponent of 1, minus 1, scaled to [lo, hi) and held at lo from below."""
    if dtype == torch.float64:
        mant = ((bits >> 12) & ((1 << 52) - 1)) | 0x3FF0000000000000
        f = mant.view(torch.float64)
    elif dtype == torch.float32:
        f = (bits >> 9).bitwise_and_(0x7FFFFF).bitwise_or_(0x3F800000).view(torch.float32)
    elif dtype == torch.float16:
        f = ((bits >> 6) | 0x3C00).to(torch.int16).view(torch.float16)
    elif dtype == torch.bfloat16:
        f = ((bits >> 1) | 0x3F80).to(torch.int16).view(torch.bfloat16)
    else:
        raise TypeError(f"uniform only accepts floating point dtypes, got {dtype}")
    f = f - torch.tensor(1.0, dtype=dtype, device=bits.device)
    lo_t = torch.tensor(lo, dtype=dtype, device=bits.device)
    if (lo, hi) == (0.0, 1.0):
        return torch.maximum(lo_t, f)
    span = torch.tensor(hi, dtype=dtype, device=bits.device) - lo_t
    if dtype != torch.float64:  # jax's compiled scale-and-shift fuses to one rounding: an exact float64 one
        return torch.maximum(lo_t, (f.double() * span.double() + lo_t.double()).to(dtype))
    return torch.maximum(lo_t, f * span + lo_t)


def _width(dtype: torch.dtype) -> int:
    """The random bits jax draws per value of a float ``dtype``."""
    return {torch.float64: 64, torch.float32: 32, torch.float16: 16, torch.bfloat16: 8}[dtype]


def _draw(shape, dtype, split, device, comm, fn, key=None) -> DNDarray:
    """A DNDarray of global ``shape`` whose elements are ``fn(key, idx,
    torch dtype)`` of their flat global indices."""
    shape = sanitize_shape(shape)
    dtype = types.canonical_heat_type(dtype)
    comm = sanitize_comm(comm)
    device = sanitize_device(device)
    if split is not None:
        split = split % len(shape)
    key = _next_key(comm) if key is None else key
    tdt = dtype.torch_type()
    t = _fill(shape, split, comm, device.torch_device, tdt, lambda idx: fn(key, idx, tdt))
    return DNDarray(t, shape, dtype, split, device, comm, True)


def _uniform_fn(lo, hi):
    def fn(key, idx, dt):
        return _uniform_of_bits(_bits(key, idx, _width(dt)), dt, lo, hi)

    return fn


def _normal_fn(key, idx, dt):
    lo = -1.0 + torch.finfo(dt).eps / 2  # nextafter(-1, 0) in dt
    u = _uniform_of_bits(_bits(key, idx, _width(dt)), dt, lo, 1.0)
    return torch.erfinv(u).mul_(torch.tensor(math.sqrt(2), dtype=dt, device=u.device))


def _shape(d) -> Tuple[int, ...]:
    if len(d) == 1 and isinstance(d[0], (tuple, list)):
        return tuple(d[0])
    return tuple(d) if d else (1,)


def rand(*d, dtype=types.float32, split=None, device=None, comm=None) -> DNDarray:
    """Uniform samples in [0, 1) of the given shape."""
    return _draw(_shape(d), dtype, split, device, comm, _uniform_fn(0.0, 1.0))


def random_sample(shape=(1,), dtype=types.float32, split=None, device=None, comm=None) -> DNDarray:
    return _draw(shape, dtype, split, device, comm, _uniform_fn(0.0, 1.0))


random = random_sample
ranf = random_sample
sample = random_sample


def uniform(low=0.0, high=1.0, size=(1,), dtype=types.float32, split=None, device=None, comm=None) -> DNDarray:
    """Uniform samples in [low, high)."""
    return _draw(size, dtype, split, device, comm, _uniform_fn(float(low), float(high)))


def randn(*d, dtype=types.float32, split=None, device=None, comm=None) -> DNDarray:
    """Standard-normal samples of the given shape."""
    return _draw(_shape(d), dtype, split, device, comm, _normal_fn)


def standard_normal(shape=(1,), dtype=types.float32, split=None, device=None, comm=None) -> DNDarray:
    return _draw(shape, dtype, split, device, comm, _normal_fn)


def normal(mean=0.0, std=1.0, shape=(1,), dtype=types.float32, split=None, device=None, comm=None) -> DNDarray:
    """Normal(mean, std) samples; ``mean`` and ``std`` may be DNDarrays that
    broadcast against ``shape``."""
    base = _draw(shape, dtype, split, device, comm, _normal_fn)
    if np.isscalar(mean) and np.isscalar(std):
        if float(std) < 0:
            raise ValueError("std must be non-negative")
        base.larray.mul_(float(std)).add_(float(mean))
        return base
    from . import arithmetics

    return arithmetics.add(arithmetics.mul(base, std), mean)


def _mulmod32(a: torch.Tensor, b) -> torch.Tensor:
    """``a * b`` modulo 2^32 for words below 2^32, from 16-bit halves (the
    full product would overflow int64)."""
    b = int(b)
    bl, bh = b & 0xFFFF, b >> 16
    return (((a >> 16) * bl + (a & 0xFFFF) * bh) << 16).add_((a & 0xFFFF) * bl).bitwise_and_(_M32)


def _randint_fn(low: int, high: int, dt: torch.dtype):
    """jax's ``randint``: integers narrower than 32 bits are drawn as int32
    in the dtype's range and cast, int64 as int32 (the reference's, 64-bit
    types off); two streams of random words from the key's split are
    combined modulo the span, so that a span below 2^32 takes 64 bits of
    randomness."""
    info = torch.iinfo(dt)
    if info.bits < 32:
        low, high = min(max(low, info.min), info.max), min(max(high, info.min), info.max + 1)
    i32 = torch.iinfo(torch.int32)
    out_of_range = high > i32.max
    lo, hi = min(max(low, i32.min), i32.max), min(max(high, i32.min), i32.max)
    span = (hi - lo) & _M32
    if hi <= lo:
        span = 1
    elif out_of_range:
        span = (span + 1) & _M32
    mult = (1 << 16) % span if span else 0
    mult = ((mult * mult) & _M32) % span if span else 0  # the square wraps, as jax's uint32 product does

    def fn(key, idx, _):
        k1, k2 = _split(key)
        higher, lower = _u32(_bits(k1, idx)), _u32(_bits(k2, idx))
        if span == 0:  # the full range: the low word alone
            off = lower
        else:
            off = ((_mulmod32(higher % span, mult) + lower % span) & _M32) % span
        res = (off + lo) & _M32
        res = torch.where(res > i32.max, res - (1 << 32), res)
        return res.to(dt)

    return fn


def randint(low, high=None, size=None, dtype=types.int32, split=None, device=None, comm=None) -> DNDarray:
    """Random integers in [low, high)."""
    if high is None:
        low, high = 0, low
    if size is None:
        size = (1,)
    if high <= low:
        raise ValueError("low >= high")
    if isinstance(size, int):
        size = (size,)
    tdt = types.canonical_heat_type(dtype).torch_type()
    return _draw(size, dtype, split, device, comm, _randint_fn(int(low), int(high), tdt))


random_integer = randint


def _shuffled_range(n: int, split, device, comm, key) -> DNDarray:
    """jax's ``_shuffle`` of ``arange(n)`` (int32): ``ceil(3 ln n / ln(2^32 -
    1))`` rounds, each a stable sort of the current array by fresh random
    32-bit keys of its positions; across ranks by the sample sort."""
    from ..parallel.sample_sort import sample_sort_1d

    tdev = device.torch_device
    off, lshape, _ = comm.chunk((n,), split)
    vals = torch.arange(off, off + lshape[0], dtype=torch.int32, device=tdev)
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(np.uint32).max)))
    dist = split is not None and comm.is_distributed()
    for _ in range(rounds):
        key, sub = _split(key)
        counts = comm.counts_displs_shape((n,), 0)[0] if dist else (n,)
        keys = _fill((n,), 0 if dist else None, comm, tdev, torch.int64, lambda idx: _u32(_bits(sub, idx)))
        if dist:
            _, (vals,) = sample_sort_1d(comm, keys, [vals], counts)
        else:
            vals = vals[torch.sort(keys, stable=True).indices]
    return DNDarray(vals, (n,), types.int32, split, device, comm, True)


def permutation(x, split=None, device=None, comm=None) -> DNDarray:
    """A random permutation of ``arange(x)``, or of the rows of the array
    ``x`` (along axis 0), jax's from the same key."""
    if isinstance(x, DNDarray):
        key = _next_key(x.comm)
        split0 = 0 if x.split == 0 else None
        perm = _shuffled_range(x.shape[0], split0, x.device, x.comm, key)
        return x[perm]
    if isinstance(x, (int, np.integer)):
        comm = sanitize_comm(comm)
        key = _next_key(comm)
        return _shuffled_range(int(x), split if split is None else 0, sanitize_device(device), comm, key)
    raise TypeError(f"x must be int or DNDarray, got {type(x)}")


def randperm(n: int, dtype=types.int32, split=None, device=None, comm=None) -> DNDarray:
    """Random permutation of range(n)."""
    return permutation(int(n), split=split, device=device, comm=comm).astype(dtype, copy=False)


seed()
