"""Input/output validation (reference: ``heat/core/sanitation.py``)."""

from __future__ import annotations

from typing import Optional, Sequence

from .devices import sanitize_device
from .dndarray import DNDarray

__all__ = ["sanitize_in", "sanitize_out"]


def sanitize_in(x) -> None:
    """Raise if ``x`` is not a DNDarray."""
    if not isinstance(x, DNDarray):
        raise TypeError(f"Input must be a DNDarray, got {type(x)}")


def sanitize_out(
    out: DNDarray,
    output_shape: Sequence[int],
    output_split: Optional[int],
    output_device,
    output_comm=None,
) -> None:
    """Validate an ``out=`` buffer against the expected result metadata.

    A buffer whose split differs is refused here; the ops' ``out=`` path
    resplits it first, with the reference's warning."""
    sanitize_in(out)
    if tuple(out.shape) != tuple(output_shape):
        raise ValueError(f"Expecting output buffer of shape {tuple(output_shape)}, got {out.shape}")
    if out.split != output_split:
        raise ValueError(f"Expecting output buffer with split {output_split}, got {out.split}")
    if out.device != sanitize_device(output_device):
        raise ValueError(f"Expecting output buffer on {output_device}, got {out.device}")
    if output_comm is not None and out.comm.size != output_comm.size:
        raise ValueError("output buffer lives on another communicator")
