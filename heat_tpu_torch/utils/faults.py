"""Bounded retry with jittered exponential backoff (the reference's
``utils/faults.py``: ``jitter_unit``, ``backoff_schedule``,
``call_with_retries`` and ``TransientFault``, with the same schedule).

The reference's fault-injection sites (``fire``) and its profiler counters
belong to the runtime plane, which is not ported yet; here each retry and
each give-up counts in :func:`retry_counts` (``retry.<site>``,
``retry.<site>.exhausted``).
"""

from __future__ import annotations

import hashlib
import time
from typing import Callable, Dict, Iterator, Optional, Tuple

__all__ = ["TransientFault", "backoff_schedule", "call_with_retries", "jitter_unit", "reset_retry_counts",
           "retry_counts"]


class TransientFault(OSError):
    """A failure that models a transient condition (a flaky disk); the retry
    layer treats it as retryable."""


_counts: Dict[str, int] = {}


def retry_counts() -> Dict[str, int]:
    """Retries and give-ups per site since :func:`reset_retry_counts`."""
    return dict(_counts)


def reset_retry_counts() -> None:
    _counts.clear()


def _count(name: str) -> None:
    _counts[name] = _counts.get(name, 0) + 1


def jitter_unit(site: str, attempt: int) -> float:
    """A uniform draw in [0, 1) derived deterministically from ``(site,
    attempt)``: ranks in lockstep sleep alike after the same fault, and
    distinct sites and attempts still decorrelate.  sha256 is stable across
    processes, platforms and ``PYTHONHASHSEED``."""
    digest = hashlib.sha256(f"backoff|{site}|{int(attempt)}".encode()).digest()
    return int.from_bytes(digest[:8], "big") / 2.0**64


def backoff_schedule(retries: int, base_delay: float = 0.05, factor: float = 2.0, max_delay: float = 2.0,
                     jitter: float = 0.5, rand: Optional[Callable[[], float]] = None,
                     site: str = "") -> Iterator[float]:
    """The delays slept between attempts: ``min(max_delay, base*factor**i)``
    stretched by up to ``jitter`` times a uniform draw (:func:`jitter_unit`
    unless ``rand`` is given)."""
    for i in range(retries):
        u = rand() if rand is not None else jitter_unit(site, i)
        yield min(max_delay, base_delay * factor**i) * (1.0 + jitter * u)


def call_with_retries(fn: Callable, site: str, retries: int = 4, base_delay: float = 0.05, factor: float = 2.0,
                      max_delay: float = 2.0, jitter: float = 0.5,
                      retry_on: Tuple[type, ...] = (TransientFault, OSError),
                      retry_if: Optional[Callable[[BaseException], bool]] = None,
                      sleep: Callable[[float], None] = time.sleep, rand: Optional[Callable[[], float]] = None,
                      deadline: Optional[float] = None, clock: Callable[[], float] = time.monotonic):
    """Run ``fn()`` with up to ``retries`` backoff retries on the exceptions
    of ``retry_on`` that ``retry_if`` (if given) accepts.  ``deadline`` caps
    the total time in seconds: a sleep that would overrun it is not taken
    and the last failure re-raises.  ``sleep``, ``rand`` and ``clock`` are
    injectable for tests."""
    delays = None
    attempt = 0
    t0 = clock()
    while True:
        try:
            return fn()
        except retry_on as e:
            if retry_if is not None and not retry_if(e):
                raise
            if attempt >= retries:
                _count(f"retry.{site}.exhausted")
                raise
            if delays is None:
                delays = list(backoff_schedule(retries, base_delay, factor, max_delay, jitter, rand, site=site))
            if deadline is not None and clock() - t0 + delays[attempt] >= deadline:
                _count(f"retry.{site}.exhausted")
                raise
            _count(f"retry.{site}")
            sleep(delays[attempt])
            attempt += 1
