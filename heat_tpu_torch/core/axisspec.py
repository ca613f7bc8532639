"""split <-> named-axis-spec view (the reference's ``core/axisspec.py``).

Call sites keep passing ``split=``; a site may pass :func:`named`, whose
:class:`AxisSpec` return value **is** the int (a subclass) and also names
the logical axis it splits (:data:`DATA_AXIS`).  So ``named(k) == k``,
``hash(named(k)) == hash(k)``, and arithmetic, formatting and JSON are the
raw int's; ``spec_to_split(split_to_spec(s, ndim)) == s`` for every valid
axis and for ``None`` (replicated).  In the port the split axis is the
process axis of the communicator: one named axis, as in the reference.
"""

from __future__ import annotations

from typing import Optional, Tuple

__all__ = [
    "DATA_AXIS",
    "AxisSpec",
    "named",
    "split_to_spec",
    "spec_to_split",
    "is_named",
]

# the one process axis every split indexes into
DATA_AXIS = "data"


class AxisSpec(int):
    """A split axis index that also speaks the named-spec vocabulary.

    Subclasses :class:`int` so equality, hashing, arithmetic, slicing,
    formatting and serialization are EXACTLY the raw index's — migrated
    ``split=`` call sites are behavior-identical by construction, not by
    testing alone (the tests prove the construction holds).
    """

    __slots__ = ()

    @property
    def axis_name(self) -> str:
        """Logical name of the mesh axis this split maps onto."""
        return DATA_AXIS

    def spec(self, ndim: int) -> Tuple[Optional[str], ...]:
        """PartitionSpec-style view for an ``ndim``-rank array."""
        return split_to_spec(int(self), ndim)

    # deliberately NO __repr__ override: on an int subclass, object.__str__
    # delegates to __repr__, so a custom repr would change str()/f-string/
    # format() output — exactly the kind of silent behavior drift the shim
    # promises cannot happen.  Debug identity comes from is_named()/axis_name.


def named(split: Optional[int]) -> Optional[AxisSpec]:
    """The named view of a split axis; ``None`` (replicated) stays ``None``.

    ``split=named(0)`` behaves exactly as ``split=0``.
    """
    if split is None:
        return None
    if isinstance(split, bool) or not isinstance(split, int):
        raise TypeError(f"split must be an int axis or None, got {split!r}")
    return AxisSpec(split)


def split_to_spec(split: Optional[int], ndim: int) -> Tuple[Optional[str], ...]:
    """``split=1, ndim=3`` → ``(None, 'data', None)``; replicated → all-None."""
    if ndim < 0:
        raise ValueError(f"ndim must be non-negative, got {ndim}")
    if split is None:
        return (None,) * ndim
    ax = int(split)
    if ax < 0:
        ax += ndim
    if not 0 <= ax < ndim:
        raise ValueError(f"split {split} out of range for ndim {ndim}")
    return tuple(DATA_AXIS if i == ax else None for i in range(ndim))


def spec_to_split(spec: Tuple[Optional[str], ...]) -> Optional[int]:
    """Inverse of :func:`split_to_spec`; raises on specs the single-axis
    world cannot express (more than one named axis) instead of guessing."""
    hits = [i for i, name in enumerate(spec) if name is not None]
    if not hits:
        return None
    if len(hits) > 1:
        raise ValueError(
            f"spec {spec!r} names {len(hits)} axes — not expressible as a "
            "single split (that is the refactor's destination, not the shim's)"
        )
    if spec[hits[0]] != DATA_AXIS:
        raise ValueError(f"unknown mesh axis {spec[hits[0]]!r} (have {DATA_AXIS!r})")
    return hits[0]


def is_named(split) -> bool:
    """True when a split value already carries the named view."""
    return isinstance(split, AxisSpec)
