"""Random sampling (reference: ``heat/core/random.py``).

Every draw takes a fresh ``torch.Generator`` on the target device, seeded
from ``(seed, counter, rank)``: the counter advances once per draw, and each
rank draws only its own chunk of a split array.  A replicated draw
(``split=None``) is seeded as rank 0's on every rank, so that every rank
holds the same array.  The numbers differ from ``jax.random``'s from the
same seed, and a split draw depends on the world size (it is not
split-invariant); tests make their inputs with numpy instead.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from . import types
from .communication import sanitize_comm
from .devices import sanitize_device
from .dndarray import DNDarray
from .stride_tricks import sanitize_axis, sanitize_shape

__all__ = ["get_state", "normal", "rand", "randint", "randn", "seed"]

# global RNG state: (seed, counter)
__seed: int = 0
__counter: int = 0


def seed(seed: Optional[int] = None) -> None:
    """(Re-)seed the global generator."""
    global __seed, __counter
    if seed is None:
        seed = int(np.random.SeedSequence().entropy % (2**63))
    __seed = int(seed)
    __counter = 0


def get_state() -> Tuple[str, int, int, int, float]:
    """Reference-compatible state tuple (name, seed, counter, _, _)."""
    return ("Philox", __seed, __counter, 0, 0.0)


def generator(seed: int, *stream: int, device=None) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from ``seed`` and ``stream``."""
    ss = np.random.SeedSequence(entropy=int(seed), spawn_key=tuple(int(s) for s in stream))
    g = torch.Generator(device=device if device is not None else "cpu")
    g.manual_seed(int(ss.generate_state(1, dtype=np.uint64)[0] >> 1))
    return g


def _generate(sampler, shape, dtype, split, device, comm) -> DNDarray:
    global __counter
    shape = sanitize_shape(shape)
    split = sanitize_axis(shape, split)
    dtype = types.canonical_heat_type(dtype)
    comm = sanitize_comm(comm)
    device = sanitize_device(device)
    tdev = device.torch_device
    g = generator(__seed, __counter, comm.rank if split is not None else 0, device=tdev)
    __counter += 1
    lshape = comm.chunk(shape, split)[1]
    t = sampler(lshape, dtype=dtype.torch_type(), device=tdev, generator=g)
    return DNDarray(t, shape, dtype, split, device, comm, True)


def _shape(d) -> Tuple[int, ...]:
    if len(d) == 1 and isinstance(d[0], (tuple, list)):
        return tuple(d[0])
    return tuple(d) if d else (1,)


def rand(*d, dtype=types.float32, split=None, device=None, comm=None) -> DNDarray:
    """Uniform samples in [0, 1)."""
    return _generate(torch.rand, _shape(d), dtype, split, device, comm)


def randn(*d, dtype=types.float32, split=None, device=None, comm=None) -> DNDarray:
    """Standard normal samples."""
    return _generate(torch.randn, _shape(d), dtype, split, device, comm)


def normal(mean=0.0, std=1.0, shape=(1,), dtype=types.float32, split=None, device=None, comm=None) -> DNDarray:
    """Normal samples with scalar ``mean`` and ``std``."""

    def sampler(lshape, **kw):
        return torch.randn(lshape, **kw).mul_(std).add_(mean)

    return _generate(sampler, shape, dtype, split, device, comm)


def randint(low, high=None, size=None, dtype=types.int32, split=None, device=None, comm=None) -> DNDarray:
    """Random integers in [low, high)."""
    if high is None:
        low, high = 0, low
    if size is None:
        size = (1,)
    if high <= low:
        raise ValueError("low >= high")

    def sampler(lshape, **kw):
        return torch.randint(int(low), int(high), lshape, **kw)

    return _generate(sampler, size, dtype, split, device, comm)


seed()
