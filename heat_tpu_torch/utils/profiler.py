"""Profiling shim (the reference's ``utils/profiler.py`` over the port).

Counters and their providers, a wall-clock :func:`timer` that forces the
card to finish (``torch.cuda.synchronize``) before it stops, :func:`trace`
over ``torch.profiler`` and :func:`annotate` (``record_function``).

The port has no program cache (PyTorch runs eagerly), so
:func:`cache_stats` is empty, :func:`cache_hit_rate` is 1.0 (no program was
missed) and no ``cache.*`` provider is registered.
"""

from __future__ import annotations

import contextlib
import time
import weakref
from typing import Callable, Dict, Optional

import torch
import torch.profiler

__all__ = [
    "trace",
    "timer",
    "sync",
    "annotate",
    "timeit_min",
    "cache_stats",
    "reset_cache_stats",
    "cache_hit_rate",
    "counter_inc",
    "counter_max",
    "counters",
    "reset_counters",
    "register_counter_provider",
]


# ---------------------------------------------------------------------- #
# generic event counters (retry attempts, skipped train steps, ...)
# ---------------------------------------------------------------------- #
# Two sources merge in counters(): plain incremented counters (retry.<site>
# from utils.faults) and registered *providers* — callbacks polled at read
# time so device-resident counters (a tensor updated asynchronously with
# NO host sync on the step path) only
# materialize when somebody actually asks.
_counters: Dict[str, int] = {}
_providers: Dict[str, Callable[[], Dict[str, int]]] = {}


def counter_inc(name: str, n: int = 1) -> None:
    """Increment a named event counter (host-side, cheap)."""
    _counters[name] = _counters.get(name, 0) + int(n)


def counter_max(name: str, value: int) -> None:
    """High-water-mark counter: keep the MAX of all observed values (e.g.
    ``comm.resplit.peak_tile_bytes`` — additive semantics would be a lie
    for a peak).  Reads/resets/exports exactly like any other counter."""
    v = int(value)
    if v > _counters.get(name, 0):
        _counters[name] = v


def register_counter_provider(name: str, fn: Callable[[], Dict[str, int]]) -> str:
    """Register a callback polled by :func:`counters`.  Bound methods are
    held weakly so registering does not pin the owning object alive (a dead
    provider is pruned at the next :func:`counters` read).  ``name`` is
    de-duplicated with a numeric suffix — a second registrant never silently
    replaces the first — and the effective name is returned."""
    if hasattr(fn, "__self__"):
        ref = weakref.WeakMethod(fn)

        def fn():  # noqa: F811 — the weak indirection replaces the strong ref
            m = ref()
            return m() if m is not None else None  # None: owner was collected

    base, k = name, 2
    while name in _providers:
        name = f"{base}{k}"
        k += 1
    _providers[name] = fn
    return name


def counters() -> Dict[str, int]:
    """Snapshot of all counters: incremented ones plus every provider's
    current values.  May sync device-resident counters — call it at
    reporting boundaries, not inside the hot loop.

    Provider values are namespaced unambiguously under ``<provider>.<key>``
    (a key already carrying that exact dotted prefix is kept as-is).  The
    earlier rule — any key merely *starting with* the provider name passed
    through un-prefixed — let a provider key like ``daso_total`` silently
    overwrite an identically-named plain counter."""
    out = dict(_counters)
    for name, fn in list(_providers.items()):
        vals = fn()
        if vals is None:  # provider's owner was garbage collected
            _providers.pop(name, None)
            continue
        prefix = name + "."
        for k, v in vals.items():
            out[k if k.startswith(prefix) else f"{name}.{k}"] = int(v)
    return out


def reset_counters() -> None:
    """Clear the incremented counters (providers re-report on next read)."""
    _counters.clear()


def cache_stats() -> Dict[str, int]:
    """Program-cache statistics: none, the port caches no programs."""
    return {}


def reset_cache_stats() -> None:
    """Nothing to reset: the port caches no programs."""


def cache_hit_rate() -> float:
    """Hit rate of the program caches since ``reset_cache_stats()``: 1.0,
    as the reference gives for a run that missed no program (the port
    caches none)."""
    return 1.0


def timeit_min(fn, reps: int = 3) -> float:
    """Best-of-``reps`` wall-clock seconds of ``fn()``, forcing completion of
    its result (the benchmark harness's shared timing methodology)."""
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        sync(out)
        best = min(best, time.perf_counter() - t0)
    return best


def sync(x=None) -> None:
    """Wait until the card has finished the work that makes ``x`` (a tensor
    or a DNDarray; ``torch.cuda.synchronize`` of its device).  Nothing to
    wait for on the CPU or for None."""
    if x is None:
        return
    t = getattr(x, "larray", x)
    if isinstance(t, torch.Tensor) and t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


@contextlib.contextmanager
def timer(label: str = "", result_holder: Optional[dict] = None, sync_on=None):
    """Wall-clock a block; forces completion of ``sync_on`` before stopping.

    Exception-safe: a raising block still records its elapsed time into
    ``result_holder`` (and still syncs) — the exception propagates, but the
    measurement of the partial work is not lost."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        sync(sync_on)
        dt = time.perf_counter() - t0
        if result_holder is not None:
            result_holder[label or "elapsed"] = dt


@contextlib.contextmanager
def trace(logdir: str = "heat_tpu_torch_trace"):
    """A ``torch.profiler`` trace of the block (host, and the card's kernels
    where CUDA is available), written to ``logdir`` as a Chrome trace
    (``tensorboard_trace_handler``); yields the profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts,
                                on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir)) as prof:
        yield prof


annotate = torch.profiler.record_function
