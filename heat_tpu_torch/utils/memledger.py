"""Device-memory ledger: per-buffer provenance for the resource that kills jobs.

A registry of live device tensors (the reference's ``utils/memledger.py``
over torch tensors), each entry carrying

- ``nbytes``: the bytes of the tensor's storage (a view registers its whole
  storage, once: entries are keyed by the storage, not the tensor);
- the **minting site**: the op name, the registration choke point
  (``bucket`` for the bucketed gradient sync's flat buffers, ``ckpt`` for a
  checkpoint load, or the caller's own), the enclosing telemetry span (when
  armed) and the ambient trace id;
- a **category**: ``param`` / ``opt-state`` / ``activation`` /
  ``transient``, inferred from the span and site, overridable with the
  explicit ``category=`` kwarg or scoped via :func:`category`.

**Lifecycle.**  An entry leaves the ledger when the tensor that registered
it dies (a weakref callback, drained at the next locked operation), when it
is consumed (:func:`consume`), or when it moves to a new tensor that
aliases its storage (:func:`transfer`).

**Gauges.**  ``live_bytes()`` and ``peak_bytes()`` ride ``utils.profiler``
(a counter provider and ``counter_max``), per category too.
:func:`device_memory_stats` is the caching allocator's own view
(``torch.cuda.memory_stats``), with ``bytes_in_use`` and
``peak_bytes_in_use`` as the reference names them; :func:`snapshot` puts
it beside the ledger.  :func:`peak_window` measures a block's incremental
peak: on a card by the allocator's peak (every tensor the block allocates,
registered or not), elsewhere by the ledger's registrations.

**OOM post-mortem.**  :func:`alloc_check` fires the ``mem.alloc`` fault
site ahead of an allocation; a catch site that finds :func:`is_oom` (a
``torch.cuda.OutOfMemoryError``, the allocator's message, or an injected
``mem.alloc`` fault) calls :func:`note_oom`, which writes the failed
request and the top-K live buffers into the crash-durable flight ring
(``mem`` + ``membuf`` records, the reference's layout) before the error
re-raises.

**Overhead contract.**  Disarmed (the default), every instrumentation site
reduces to ONE module-global load: :func:`enable`/:func:`disable` poke
``_MEMLEDGER`` into the consumer modules (``core.collectives``,
``core.io``).

Arming: ``memledger.enable()`` in-process or ``HEAT_TPU_MEMLEDGER=1`` in
the environment (checked once at import).

Stdlib-only at module level on purpose: torch is resolved through
``sys.modules`` at enable time, so the module stays loadable from tooling
that never imports torch.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import sys
import threading
import time
import weakref
from typing import Dict, List, Optional

__all__ = [
    "enable",
    "disable",
    "enabled",
    "register",
    "register_dispatch",
    "set_dispatch_threshold",
    "reclassify",
    "consume",
    "transfer",
    "category",
    "category_of",
    "live_bytes",
    "peak_bytes",
    "live_by_category",
    "peak_by_category",
    "top_buffers",
    "counters",
    "snapshot",
    "reset_peak",
    "peak_window",
    "alloc_check",
    "is_oom",
    "note_oom",
    "dump_to_ring",
    "CATEGORIES",
    "OOM_TOP_K",
]

CATEGORIES = ("param", "opt-state", "activation", "transient")
OOM_TOP_K = 5

# dispatch-tier registration threshold (bytes): a per-op hot path may not
# afford a weakref + entry per µs-scale intermediate, so register_dispatch
# coalesces outputs BELOW this size into the ``mem.dispatch.small_*``
# counters (volume visible, never silently dropped) and only buffers of
# consequence pay for full provenance.
DISPATCH_MIN_DEFAULT = 1 << 20  # 1 MiB

# a new peak is mirrored into the flight ring as a ``mem`` watermark record
# when it exceeds the last recorded one by this fraction — bounds the record
# volume without losing the shape of the high-water timeline
WATERMARK_FRACTION = 0.05

_ENABLED = False
_lock = threading.Lock()
_entries: Dict[int, "_Entry"] = {}
_live = 0
_peak = 0
_live_cat: Dict[str, int] = {}
_peak_cat: Dict[str, int] = {}
# open peak_window() scopes: each dict tracks the max live bytes seen
# while the window was open (updated under the lock on every live
# increase — BEFORE the global-peak early return, since a window opened
# below the all-time high must still see its own local maximum)
_windows: List[dict] = []
_registered_total = 0
_oom_dumps = 0
_last_ring_peak = 0
# coalesced under-threshold dispatch volume: [count, bytes] — the hot
# tier takes no lock (see register_dispatch for the lost-increment trade)
_small = [0, 0]
_dispatch_min = DISPATCH_MIN_DEFAULT

# torch.Tensor, resolved at enable() via sys.modules (never imported here)
_TENSOR: Optional[type] = None

_provider_registered = False

# scoped category default (the ergonomic override: ``with
# memledger.category("param"): load_checkpoint(...)``)
_CATEGORY: contextvars.ContextVar[Optional[str]] = contextvars.ContextVar(
    "heat_tpu_mem_category", default=None
)


class _Entry:
    __slots__ = ("ref", "key", "nbytes", "op", "site", "cat", "span", "tid", "t")

    def __init__(self, ref, key, nbytes, op, site, cat, span, tid, t):
        self.ref = ref
        self.key = key
        self.nbytes = nbytes
        self.op = op
        self.site = site
        self.cat = cat
        self.span = span
        self.tid = tid
        self.t = t


# ---------------------------------------------------------------------- #
# provenance helpers (cheap, armed-only)
# ---------------------------------------------------------------------- #
def _telemetry():
    return sys.modules.get("heat_tpu_torch.utils.telemetry")


def _flightrec():
    fr = sys.modules.get("heat_tpu_torch.utils.flightrec")
    if fr is not None and fr.enabled():
        return fr
    return None


def _current_span_name() -> Optional[str]:
    tel = _telemetry()
    if tel is None or not getattr(tel, "_ENABLED", False):
        return None
    try:
        stack = tel._stack()
        return stack[-1].name if stack else None
    except Exception:
        return None


def _current_trace_id() -> Optional[str]:
    tel = _telemetry()
    if tel is None:
        return None
    try:
        return tel.current_trace_id()
    except Exception:
        return None


def _nbytes_of(arr) -> int:
    """Bytes of the tensor's storage: metadata only, no device sync."""
    try:
        return int(arr.untyped_storage().nbytes())
    except Exception:
        return 0


def _key(arr):
    """The ledger key of a tensor: its storage (device and address), so
    every view of one storage is one entry.  None for what is no tensor."""
    if arr is None or _TENSOR is None or not isinstance(arr, _TENSOR):
        return None
    try:
        dev = arr.device
        return (dev.type, dev.index, int(arr.untyped_storage().data_ptr()))
    except Exception:
        return None


def _is_concrete(arr) -> bool:
    """True for a tensor with real storage (not on the meta device)."""
    return _key(arr) is not None and arr.device.type != "meta"


def _live_entry(key):
    """The entry at ``key`` while the tensor that registered it lives."""
    e = _entries.get(key) if key is not None else None
    return e if e is not None and e.ref() is not None else None


def _infer_category(site: str, span: Optional[str]) -> str:
    """The category taxonomy, applied when no override is in scope:
    checkpoint loads mint ``param``, resplit tiles mint ``transient``,
    buffers minted inside an optimizer/DASO step span are ``opt-state``,
    everything else is ``activation`` (the honest default for dispatch
    intermediates and bare factory outputs)."""
    if site == "ckpt":
        return "param"
    if site == "resplit.tile":
        return "transient"
    if span:
        if span.startswith(("optim.", "daso.")):
            return "opt-state"
        if span.startswith(("io.", "ckpt")):
            return "param"
    return "activation"


# ---------------------------------------------------------------------- #
# core registry operations
# ---------------------------------------------------------------------- #
# deferred finalizer queue: weakref callbacks can fire on ANY thread at
# ANY allocation point — including while THIS module holds the
# (non-reentrant) _lock, where taking it again would self-deadlock — so
# the callback only records the death (list.append is GIL-atomic) and the
# decrement happens at the next locked operation via _drain_locked()
_dead: List = []


def _on_collect(wr, key):
    """Weakref finalizer: the registering tensor died.  Deferred — see
    ``_dead`` above; the identity check (a reused storage address must never
    pop a later tensor's entry) happens at drain time."""
    try:
        _dead.append((key, wr))
    except Exception:  # interpreter shutdown: module globals may be gone
        pass


def _drain_locked() -> None:
    """Apply the deferred finalizer decrements.  Caller holds ``_lock``."""
    global _live
    while _dead:
        try:
            key, wr = _dead.pop()
        except IndexError:
            return
        e = _entries.get(key)
        if e is None or e.ref is not wr:
            continue  # stale callback for a reused address — not our entry
        del _entries[key]
        _live -= e.nbytes
        _bump_cat_locked(e.cat, -e.nbytes)


def _drain() -> None:
    """Take the lock and drain iff there is anything pending — the read
    APIs call this so gauges never lag behind dead buffers."""
    if _dead:
        with _lock:
            _drain_locked()


def _bump_peak_locked() -> None:
    """Called under the lock after a live-bytes increase: update the peak
    high-water marks, mirror the total into ``profiler.counter_max``, and
    emit a ``mem`` watermark record into the flight ring when the new peak
    clears the hysteresis threshold."""
    global _peak, _last_ring_peak
    for w in _windows:
        if not w.get("allocator") and _live > w["peak"]:
            w["peak"] = _live
    if _live <= _peak:
        return
    _peak = _live
    prof = sys.modules.get("heat_tpu_torch.utils.profiler")
    if prof is not None:
        try:
            prof.counter_max("mem.peak_bytes", _peak)
        except Exception:
            pass
    fr = _flightrec()
    if fr is not None and _peak > _last_ring_peak * (1.0 + WATERMARK_FRACTION):
        _last_ring_peak = _peak
        try:
            fr.record_event(
                "mem",
                live=int(_live),
                peak=int(_peak),
                by={c: int(v) for c, v in _live_cat.items() if v > 0},
            )
        except Exception:
            pass


def _bump_cat_locked(cat: str, delta: int) -> None:
    """Adjust one category's live bytes (under the lock) and keep its own
    independent high-water mark."""
    v = _live_cat.get(cat, 0) + delta
    _live_cat[cat] = v
    if v > _peak_cat.get(cat, 0):
        _peak_cat[cat] = v


def set_dispatch_threshold(nbytes: int) -> int:
    """Set the dispatch-tier full-registration threshold (bytes); returns
    the previous value.  0 registers every dispatch output with full
    provenance — the reconciliation tests run that way; production keeps
    the default so µs-scale intermediates stay one coalesced counter."""
    global _dispatch_min
    prev = _dispatch_min
    _dispatch_min = int(nbytes)
    return prev


def register_dispatch(arr, op: Optional[str] = None) -> None:
    """The per-op recorder, the leanest path here: a tensor below the
    dispatch threshold bumps one coalesced counter, and only tensors of
    consequence pay for the full provenance entry."""
    if not _ENABLED:
        return
    n = _nbytes_of(arr)
    if n < _dispatch_min:
        # lock-free slot bumps: a cross-thread interleave can lose one
        # count; the volume stays a visible counter either way
        _small[0] += 1
        _small[1] += n
        return
    register(arr, op=op, site="dispatch", nbytes=n)


def register(
    arr,
    op: Optional[str] = None,
    site: str = "dispatch",
    category: Optional[str] = None,
    nbytes: Optional[int] = None,
) -> None:
    """Register a live tensor's storage (idempotent per storage: a second
    registration of it, through the same tensor or a view, is a cheap
    no-op, so choke points may overlap).

    ``category`` overrides the inference (the resplit call sites pass their
    source's category through explicitly — captured BEFORE the source is
    consumed, which is why there is no implicit inherit-from parameter
    here)."""
    global _live, _registered_total
    if not _ENABLED:
        return
    if not _provider_registered:
        # env-armed processes enable() at memledger import, BEFORE
        # utils.profiler exists in sys.modules — retry the gauge-provider
        # registration here (one bool check once it has succeeded), so the
        # documented profiler gauge contract holds however arming happened
        _ensure_provider()
    # already-registered fast path FIRST (one dict probe): overlapping
    # choke points cost a lookup, not a duplicate entry
    key = _key(arr)
    if key is None or _live_entry(key) is not None or not _is_concrete(arr):
        return
    if nbytes is None:
        nbytes = _nbytes_of(arr)
    span = _current_span_name()
    if category is None:
        category = _CATEGORY.get() or _infer_category(site, span)
    if op is None:
        # frame peek: the nearest PUBLIC function up-stack is the minting
        # op (``add`` above ``_binary_op`` above ``_from_parts``); only
        # paid when the caller had nothing better, and only for
        # full-provenance registrations
        try:
            op = "?"
            for depth in (1, 2, 3, 4, 5, 6):
                name = sys._getframe(depth).f_code.co_name
                if name in ("register", "register_dispatch") or name.startswith("<"):
                    continue  # our own shims and <listcomp>/<genexpr> frames
                op = name
                if not name.startswith("_"):
                    break
        except Exception:
            pass
    tid = _current_trace_id()
    entry = _Entry(None, key, nbytes, op, site, category, span, tid, time.time())
    wr = weakref.ref(arr, lambda r, k=key: _on_collect(r, k))
    entry.ref = wr
    with _lock:
        _drain_locked()
        old = _entries.get(key)
        if old is not None and old.ref() is not None:
            return  # lost the race to a registration of the same storage
        if old is not None:
            # stale entry whose callback never ran (shouldn't happen under
            # refcounting, but never let it corrupt the ledger)
            _live -= old.nbytes
            _bump_cat_locked(old.cat, -old.nbytes)
        _entries[key] = entry
        _live += nbytes
        _bump_cat_locked(category, nbytes)
        _registered_total += 1
        _bump_peak_locked()


def reclassify(arr, op: Optional[str] = None, category: Optional[str] = None,
               site: Optional[str] = None) -> None:
    """Update an existing entry's provenance in place (the tiled-resplit
    output stops being 'transient' once it IS the destination array)."""
    global _live
    if not _ENABLED:
        return
    with _lock:
        _drain_locked()
        e = _live_entry(_key(arr))
        if e is None:
            return
        if op is not None:
            e.op = op
        if site is not None:
            e.site = site
        if category is not None and category != e.cat:
            _bump_cat_locked(e.cat, -e.nbytes)
            _bump_cat_locked(category, e.nbytes)
            e.cat = category


def consume(arr) -> None:
    """Deletion decrement: the storage is released (freed or handed over)
    even though a Python handle may linger.  Safe to call for unregistered
    or already-consumed tensors."""
    global _live
    if not _ENABLED or arr is None:
        return
    with _lock:
        _drain_locked()
        e = _live_entry(_key(arr))
        if e is None:
            return
        del _entries[e.key]
        _live -= e.nbytes
        _bump_cat_locked(e.cat, -e.nbytes)


def transfer(old, new, op: Optional[str] = None) -> None:
    """Move a registration from ``old`` to ``new`` WITHOUT the transient
    double-count: an in-place update that hands the storage to a new tensor
    must swap atomically against the peak tracking."""
    global _live
    if not _ENABLED:
        return
    if not _is_concrete(new):
        consume(old)
        return
    with _lock:
        _drain_locked()
        e = _live_entry(_key(old))
        if e is not None:
            del _entries[e.key]
        new_bytes = _nbytes_of(new)
        if e is None:
            # nothing to move: fall through to a plain registration
            span = _current_span_name()
            cat = _CATEGORY.get() or _infer_category("dispatch", span)
            e = _Entry(None, 0, 0, op or "transfer", "dispatch", cat, span,
                       _current_trace_id(), time.time())
            _live_cat[e.cat] = _live_cat.get(e.cat, 0)
        # net live delta is new - old (0 for the aliased same-shape update)
        _live += new_bytes - e.nbytes
        _bump_cat_locked(e.cat, new_bytes - e.nbytes)
        key = _key(new)
        stale = _entries.get(key)
        if stale is not None:
            # a predecessor at the same storage (dead, its deferred callback
            # not drained yet, or another tensor of it): decrement it HERE
            # or its bytes count twice
            _live -= stale.nbytes
            _bump_cat_locked(stale.cat, -stale.nbytes)
        wr = weakref.ref(new, lambda r, k=key: _on_collect(r, k))
        moved = _Entry(wr, key, new_bytes, op or e.op, e.site, e.cat, e.span,
                       e.tid, e.t)
        _entries[key] = moved
        _bump_peak_locked()


@contextlib.contextmanager
def category(name: str):
    """Scope a default category for every registration in the block —
    the explicit-override story for call sites that cannot pass the kwarg
    through (``with memledger.category("param"): model.init(...)``)."""
    token = _CATEGORY.set(str(name))
    try:
        yield
    finally:
        _CATEGORY.reset(token)


def category_of(arr) -> Optional[str]:
    """The registered category of ``arr``'s storage, or None when unregistered."""
    e = _live_entry(_key(arr))
    return e.cat if e is not None else None


# ---------------------------------------------------------------------- #
# readout
# ---------------------------------------------------------------------- #
def live_bytes() -> int:
    _drain()
    return max(_live, 0)


def peak_bytes() -> int:
    return _peak


def live_by_category() -> Dict[str, int]:
    _drain()
    return {c: v for c, v in sorted(_live_cat.items()) if v > 0}


def peak_by_category() -> Dict[str, int]:
    return {c: v for c, v in sorted(_peak_cat.items()) if v > 0}


def top_buffers(k: int = OOM_TOP_K) -> List[dict]:
    """The K largest live buffers with full minting provenance, largest
    first — the OOM dump's payload and the report's table."""
    with _lock:
        _drain_locked()
        rows = [
            {
                "nbytes": e.nbytes,
                "op": e.op,
                "site": e.site,
                "category": e.cat,
                "span": e.span,
                "tid": e.tid,
                "age_s": round(time.time() - e.t, 3),
            }
            for e in _entries.values()
            if e.ref() is not None
        ]
    rows.sort(key=lambda r: -r["nbytes"])
    return rows[:k]


def counters() -> Dict[str, int]:
    """The gauge view: live/peak totals + per-category — read by the
    ``utils.profiler`` provider, the ``/metrics`` endpoint and the
    heartbeat beacon."""
    if not _provider_registered:
        _ensure_provider()
    out = {
        "mem.live_bytes": live_bytes(),
        "mem.peak_bytes": _peak,
        "mem.buffers": len(_entries),
        "mem.registered.total": _registered_total,
    }
    if _small[0]:
        # cumulative under-threshold dispatch volume (count, bytes): the
        # hot tier coalesces these instead of minting entries — visible
        # here so the cap is never silent
        out["mem.dispatch.small.count"] = _small[0]
        out["mem.dispatch.small.bytes"] = _small[1]
    if _oom_dumps:
        out["mem.oom.dumps"] = _oom_dumps
    for c, v in live_by_category().items():
        out[f"mem.live_bytes.{c}"] = v
    for c, v in peak_by_category().items():
        out[f"mem.peak_bytes.{c}"] = v
    return out


def _cuda():
    """``torch.cuda`` where torch is loaded and a card has been used, else None."""
    torch_mod = sys.modules.get("torch")
    if torch_mod is None:
        return None
    try:
        return torch_mod.cuda if torch_mod.cuda.is_initialized() else None
    except Exception:
        return None


def device_memory_stats() -> Optional[dict]:
    """The caching allocator's own view of the current card
    (``torch.cuda.memory_stats``), with ``bytes_in_use`` and
    ``peak_bytes_in_use`` added under the reference's names; None where no
    card has been used (the CPU).  The ledger's cross-check, never its
    source of truth (the allocator sees every tensor, the ledger only the
    registered ones)."""
    cuda = _cuda()
    if cuda is None:
        return None
    try:
        stats = dict(cuda.memory_stats())
    except Exception:
        return None
    stats["bytes_in_use"] = int(stats.get("allocated_bytes.all.current", 0))
    stats["peak_bytes_in_use"] = int(stats.get("allocated_bytes.all.peak", 0))
    return stats


def snapshot() -> dict:
    """One structured view of everything: totals, categories, top buffers,
    and the allocator cross-check when the backend provides it."""
    out = {
        "live_bytes": live_bytes(),
        "peak_bytes": _peak,
        "buffers": len(_entries),
        "live_by_category": live_by_category(),
        "peak_by_category": peak_by_category(),
        "top_buffers": top_buffers(),
    }
    dev = device_memory_stats()
    if dev is not None:
        out["device_bytes_in_use"] = int(dev.get("bytes_in_use", 0))
        if "peak_bytes_in_use" in dev:
            out["device_peak_bytes_in_use"] = int(dev["peak_bytes_in_use"])
    return out


def reset_peak() -> None:
    """Re-anchor the high-water marks at the current live set (benchmark
    and reconciliation-test boundary)."""
    global _peak, _last_ring_peak
    with _lock:
        _drain_locked()
        _peak = _live
        _peak_cat.clear()
        for c, v in _live_cat.items():
            if v > 0:
                _peak_cat[c] = v
        _last_ring_peak = 0


def _fold_allocator_peak_locked(cuda) -> None:
    """Every open allocator-mode window saw the allocator's peak since the
    last fold: raise each to it, then restart the allocator's peak at what
    is allocated now.  Caller holds ``_lock``."""
    peak = int(cuda.max_memory_allocated())
    for w in _windows:
        if w.get("allocator") and peak > w["peak"]:
            w["peak"] = peak
    cuda.reset_peak_memory_stats()


@contextlib.contextmanager
def peak_window():
    """Scoped incremental-peak measurement: yields a dict whose ``base``
    is the bytes live at entry and whose ``peak`` the most live while the
    block runs; ``peak - base`` is the block's incremental device-memory
    footprint, what the federation admission predictor records per job
    kind (``serving.make_executor`` brackets each batch in one of these).
    On a card the bytes are the caching allocator's (``memory_allocated``
    and its peak, which this window restarts at entry and folds into every
    open window at each entry and exit, so windows nest); elsewhere they
    are the ledger's registrations, as in the reference.  Concurrent
    allocations from other threads inflate the window: an over-estimate
    for admission, never an under-estimate."""
    cuda = _cuda()
    with _lock:
        _drain_locked()
        if cuda is not None:
            _fold_allocator_peak_locked(cuda)
            base = int(cuda.memory_allocated())
            w = {"base": base, "peak": base, "allocator": True}
        else:
            w = {"base": _live, "peak": _live}
        _windows.append(w)
    try:
        yield w
    finally:
        with _lock:
            _drain_locked()
            if w.get("allocator") and cuda is not None:
                _fold_allocator_peak_locked(cuda)
            try:
                _windows.remove(w)
            except ValueError:
                pass


# ---------------------------------------------------------------------- #
# allocation-failure path: the mem.alloc fault site + the OOM dump
# ---------------------------------------------------------------------- #
# the most recent alloc_check request: [nbytes, where] — lock-free slots
# (GIL-atomic single-slot stores); dump_oom falls back to it when its
# caller could not size the failed request itself, provided the dump is
# for the SAME site (a stale request from another path must not lie)
_pending_alloc: List = [None, None]


def alloc_check(nbytes: Optional[int], where: str) -> None:
    """Record the pending allocation (``nbytes`` at ``where``) and fire
    the ``mem.alloc`` fault site ahead of it (the resplit/tile staging
    points) — chaos CI injects a deterministic allocation failure here;
    the surrounding catch treats it exactly like a real allocation
    failure, and the recorded request sizes the dump when the catch site
    cannot."""
    _pending_alloc[0] = nbytes
    _pending_alloc[1] = where
    from . import faults as _flt

    _flt.fire("mem.alloc")


def is_oom(exc: BaseException) -> bool:
    """True when ``exc`` is an allocation failure: a
    ``torch.cuda.OutOfMemoryError`` (or the caching allocator's message
    for one), or an injected ``mem.alloc`` fault (whose message names the
    site)."""
    torch_mod = sys.modules.get("torch")
    oom_type = getattr(getattr(torch_mod, "cuda", None), "OutOfMemoryError", None)
    if oom_type is not None and isinstance(exc, oom_type):
        return True
    text = str(exc)
    return "CUDA out of memory" in text or "mem.alloc" in text


def note_oom(exc: BaseException, where: str, nbytes: Optional[int]) -> bool:
    """Called from a catch block with the failure in hand: when it is OOM-shaped, render the ledger dump into the flight
    ring (and return True); any other failure passes through untouched.
    The caller ALWAYS re-raises — this only explains, never swallows."""
    if not is_oom(exc):
        return False
    dump_oom(where=where, req_bytes=nbytes, err=type(exc).__name__)
    return True


def dump_oom(where: str, req_bytes: Optional[int], err: str = "") -> None:
    """The post-mortem payload: one ``mem`` record with ``oom=1`` (failed
    request size, site, live/peak at failure) followed by one ``membuf``
    record per top-K live buffer with its minting provenance — all into
    the crash-durable ring, so the account survives the death that usually
    follows."""
    global _oom_dumps
    _oom_dumps += 1
    if req_bytes is None and _pending_alloc[1] == where:
        # the caller could not size the request; the alloc_check that
        # preceded the failure AT THIS SITE could
        req_bytes = _pending_alloc[0]
    fr = _flightrec()
    if fr is None:
        return
    try:
        fr.record_event(
            "mem",
            oom=1,
            where=where,
            req=int(req_bytes or 0),
            live=int(live_bytes()),
            peak=int(_peak),
            err=err,
        )
        for i, b in enumerate(top_buffers(OOM_TOP_K)):
            fr.record_event(
                "membuf",
                i=i,
                op=b["op"],
                nb=int(b["nbytes"]),
                cat=b["category"],
                **({"span": b["span"]} if b["span"] else {}),
                **({"tid": b["tid"]} if b["tid"] else {}),
            )
        fr.sync()
    except Exception:
        pass


def dump_to_ring() -> None:
    """Write the current watermark + top buffers into the flight ring on
    demand (the mp dryrun worker's end-of-run attestation)."""
    fr = _flightrec()
    if fr is None:
        return
    try:
        # att=1 marks a DUMP header (vs a mid-burst watermark record):
        # the post-mortem membuf collectors stop at it
        fr.record_event(
            "mem",
            att=1,
            live=int(live_bytes()),
            peak=int(_peak),
            by={c: int(v) for c, v in live_by_category().items()},
        )
        for i, b in enumerate(top_buffers(OOM_TOP_K)):
            fr.record_event(
                "membuf", i=i, op=b["op"], nb=int(b["nbytes"]),
                cat=b["category"],
            )
    except Exception:
        pass


# ---------------------------------------------------------------------- #
# enable / disable — the telemetry-hook poking pattern
# ---------------------------------------------------------------------- #
_CONSUMER_MODULES = (
    "heat_tpu_torch.core.collectives",
    "heat_tpu_torch.core.io",
)


def _poke_hooks(on: bool) -> None:
    me = sys.modules.get(__name__) if on else None
    for name in _CONSUMER_MODULES:
        mod = sys.modules.get(name)
        if mod is not None:
            mod._MEMLEDGER = me


def _ensure_provider() -> None:
    """Register the pre-prefixed ``mem`` provider with ``utils.profiler``
    iff it is already loaded (importing it pulls torch)."""
    global _provider_registered
    if _provider_registered:
        return
    prof = sys.modules.get("heat_tpu_torch.utils.profiler")
    if prof is None:
        return
    prof.register_counter_provider("mem", counters)
    _provider_registered = True


def enabled() -> bool:
    return _ENABLED


def enable() -> None:
    """Arm the ledger: resolve torch.Tensor, poke the consumer-module
    hooks, register the profiler gauge provider."""
    global _ENABLED, _TENSOR
    torch_mod = sys.modules.get("torch")
    if torch_mod is None:
        try:
            import torch as torch_mod  # the runtime always has it; tooling never calls enable()
        except ImportError:
            torch_mod = None
    if torch_mod is not None:
        _TENSOR = torch_mod.Tensor
    _ENABLED = True
    _poke_hooks(True)
    _ensure_provider()


def disable() -> None:
    """Disarm: the registry keeps its entries (a re-enable resumes), but
    every hook reverts to the one-global-load no-op."""
    global _ENABLED
    _ENABLED = False
    _poke_hooks(False)


def _reset_for_tests() -> None:
    """Drop every entry and zero the ledger (test isolation only)."""
    global _live, _peak, _registered_total, _oom_dumps, _last_ring_peak
    with _lock:
        _entries.clear()
        _live = 0
        _peak = 0
        _live_cat.clear()
        _peak_cat.clear()
        _registered_total = 0
        _oom_dumps = 0
        _last_ring_peak = 0
        _small[0] = _small[1] = 0
        del _dead[:]


# env arming: one check at import (``core.io`` imports this module at
# package import, so HEAT_TPU_MEMLEDGER takes effect process-wide).  Gated
# on __package__ like telemetry/flightrec: a STANDALONE load of this file
# is tooling and must not resolve torch or poke hooks.
try:
    _dispatch_min = int(
        os.environ.get("HEAT_TPU_MEMLEDGER_DISPATCH_MIN", "")
        or DISPATCH_MIN_DEFAULT
    )
except ValueError:
    _dispatch_min = DISPATCH_MIN_DEFAULT

if __package__ and os.environ.get(
    "HEAT_TPU_MEMLEDGER", ""
).strip().lower() in ("1", "true", "on", "yes"):
    enable()
