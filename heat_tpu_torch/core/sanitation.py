"""Input/output validation (reference: ``heat/core/sanitation.py``).

The metadata checks (``validate_metadata`` and the switches around it) test
what the port's layout can break: the local tensor against the global shape,
the split axis, the chunk of a balanced array, the dtype and the device.
They read no array values.  ``assert_cross_rank_consistent`` compares the
metadata across the ranks with one Allgather.  The checks at the dispatch
tail and after ``resplit_`` are off unless ``enable_checks()`` (or
``HEAT_TPU_CHECKS=1`` in the environment at import) turns them on.
"""

from __future__ import annotations

import os
import sys
import zlib
from typing import Optional, Sequence, Union

import numpy as np
import torch

from . import types
from .devices import sanitize_device
from .dndarray import DNDarray

__all__ = [
    "sanitize_in",
    "sanitize_infinity",
    "sanitize_in_tensor",
    "sanitize_lshape",
    "sanitize_out",
    "sanitize_distribution",
    "sanitize_sequence",
    "scalar_to_1d",
    "MetadataError",
    "checks_enabled",
    "enable_checks",
    "disable_checks",
    "validate_metadata",
    "validate_dispatch",
    "check",
    "check_placement",
    "assert_cross_rank_consistent",
]


def sanitize_in(x) -> None:
    """Raise if ``x`` is not a DNDarray."""
    if not isinstance(x, DNDarray):
        raise TypeError(f"Input must be a DNDarray, got {type(x)}")


def sanitize_infinity(x) -> Union[int, float]:
    """The largest value of ``x``'s dtype (what stands in for infinity)."""
    dtype = x.dtype if isinstance(x, DNDarray) else types.canonical_heat_type(x.dtype)
    if types.heat_type_is_exact(dtype):
        return types.iinfo(dtype).max if dtype is not types.bool else True
    return types.finfo(dtype).max


def sanitize_in_tensor(x) -> torch.Tensor:
    """``x`` as a tensor: a DNDarray's local tensor, anything else
    ``torch.as_tensor``'s."""
    if isinstance(x, DNDarray):
        return x.larray
    return torch.as_tensor(x)


def sanitize_lshape(array: DNDarray, tensor) -> None:
    """Raise unless ``tensor``'s shape could be a local part of ``array``:
    the global shape, but along the split axis."""
    tshape = tuple(tensor.shape)
    if array.split is None:
        if tshape != array.gshape:
            raise ValueError(f"local tensor shape {tshape} inconsistent with {array.gshape}")
        return
    if len(tshape) != array.ndim or any(t != g for i, (t, g) in enumerate(zip(tshape, array.gshape))
                                          if i != array.split):
        raise ValueError(f"local tensor shape {tshape} inconsistent with {array.gshape}")


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


def sanitize_distribution(*args, target: DNDarray, diff_map=None):
    """Each DNDarray of ``args`` on ``target``'s split (resplit where it
    differs); one array, or a tuple of them."""
    out = []
    for a in args:
        sanitize_in(a)
        if a.split != target.split:
            a = a.resplit(target.split)
        out.append(a)
    return out[0] if len(out) == 1 else tuple(out)


def sanitize_sequence(seq) -> list:
    """``seq`` as a list: a list as it is, a tuple's items, or a replicated
    DNDarray's rows."""
    if isinstance(seq, list):
        return seq
    if isinstance(seq, tuple):
        return list(seq)
    if isinstance(seq, DNDarray):
        if seq.split is None:
            return [seq[i] for i in range(len(seq))]
        raise TypeError("seq must not be distributed")
    raise TypeError(f"seq must be a list, tuple or DNDarray, got {type(seq)}")


def scalar_to_1d(x: DNDarray) -> DNDarray:
    """A 0-d DNDarray as shape (1,); any other as it is."""
    if x.ndim == 0:
        return DNDarray(x.larray.reshape(1), (1,), x.dtype, None, x.device, x.comm, True)
    return x


# ---------------------------------------------------------------------- #
# metadata checks (off by default; HEAT_TPU_CHECKS=1 or enable_checks())
# ---------------------------------------------------------------------- #
_CHECKS_ENABLED = False


class MetadataError(ValueError):
    """A DNDarray's metadata disagrees with its local tensor or across ranks."""


def checks_enabled() -> bool:
    return _CHECKS_ENABLED


def _poke_hooks(on: bool) -> None:
    """Arm or disarm the hooks: the dispatch tail (``_operations._CHECKS``)
    and ``resplit_`` (``dndarray._CHECKS``) each read one module global."""
    for name in ("heat_tpu_torch.core._operations", "heat_tpu_torch.core.dndarray"):
        module = sys.modules.get(name)
        if module is not None:
            module._CHECKS = validate_dispatch if on else None


def enable_checks() -> None:
    """Turn the metadata checks on (as ``HEAT_TPU_CHECKS=1``)."""
    global _CHECKS_ENABLED
    _CHECKS_ENABLED = True
    _poke_hooks(True)


def disable_checks() -> None:
    global _CHECKS_ENABLED
    _CHECKS_ENABLED = False
    _poke_hooks(False)


def validate_metadata(x, where: str = "") -> DNDarray:
    """Raise :class:`MetadataError` unless ``x``'s metadata agrees with its
    local tensor: ``gshape`` a tuple of non-negative ints, ``split`` in
    range, the local tensor of ``gshape``'s rank and extents (but along the
    split axis, where a balanced array holds its ``chunk``), of ``x``'s dtype
    and on ``x``'s device.  Local, no communication; returns ``x``."""
    tag = f" [{where}]" if where else ""
    if not isinstance(x, DNDarray):
        raise MetadataError(f"expected DNDarray, got {type(x)}{tag}")
    gshape, split, t = x.gshape, x.split, x.larray
    if not isinstance(gshape, tuple) or not all(isinstance(s, (int, np.integer)) and s >= 0 for s in gshape):
        raise MetadataError(f"gshape {gshape!r} is not a tuple of non-negative ints{tag}")
    if split is not None and not (0 <= split < len(gshape)):
        raise MetadataError(f"split {split} out of range for gshape {gshape}{tag}")
    check_placement(x, x.comm, split, where)
    if t.dtype != x.dtype.torch_type():
        raise MetadataError(f"dtype metadata {x.dtype.__name__} != local tensor dtype {t.dtype}{tag}")
    if t.device.type != ("cuda" if x.device.device_type == "gpu" else "cpu"):
        raise MetadataError(f"local tensor on {t.device}, the array on {x.device}{tag}")
    return x


def validate_dispatch(x, where: str = "") -> DNDarray:
    """The hook of the dispatch tail and of ``resplit_``."""
    return validate_metadata(x, where)


def check(x, where: str = "") -> DNDarray:
    """:func:`validate_metadata` where the checks are on; ``x`` otherwise."""
    if not _CHECKS_ENABLED:
        return x
    return validate_metadata(x, where)


def check_placement(array: DNDarray, comm, split: Optional[int], where: str = "") -> DNDarray:
    """Raise :class:`MetadataError` unless ``array``'s local tensor is the
    part ``split`` gives this rank of ``comm``: the global shape but along
    the split axis, where a balanced array holds ``comm.chunk``'s extent and
    an unbalanced one at most the global extent.  Returns ``array``."""
    tag = f" [{where}]" if where else ""
    gshape, lshape = array.gshape, tuple(array.larray.shape)
    if len(lshape) != len(gshape):
        raise MetadataError(f"local tensor of shape {lshape} for an array of shape {gshape}{tag}")
    if split is None or not comm.is_distributed():
        want = gshape
    elif array.balanced:
        want = comm.chunk(gshape, split)[1]
    else:
        want = gshape[:split] + (min(lshape[split], gshape[split]),) + gshape[split + 1 :]
    if lshape != want:
        raise MetadataError(f"local tensor of shape {lshape}, but split {split} of {gshape} over {comm.size} ranks "
                            f"gives this rank {want}{tag}")
    return array


def assert_cross_rank_consistent(x, tag: str = "") -> DNDarray:
    """Raise :class:`MetadataError` on every rank unless every rank passes
    :func:`validate_metadata`, holds the same metadata for ``x`` (gshape,
    split, dtype, balance), and the ranks' extents along the split axis add
    up to the global one (for a balanced array, the chunks).  Collective:
    one Allgather of each rank's verdict, a checksum and its extent, so a
    rank that fails raises together with the others."""
    comm = x.comm
    try:
        validate_metadata(x, where=tag or "cross-rank")
        local_error = None
    except MetadataError as e:
        local_error = e
    if not comm.is_distributed():
        if local_error is not None:
            raise local_error
        return x
    desc = repr((x.gshape, x.split, x.dtype.__name__, x.balanced)).encode()
    extent = x.lshape[x.split] if x.split is not None and x.larray.ndim == x.ndim else 0
    mine = torch.tensor([local_error is None, zlib.crc32(desc), extent], dtype=torch.int64,
                        device=comm._scratch_device())
    table = torch.stack(comm._raw_allgather(mine)).tolist()
    if local_error is not None:
        raise local_error
    failed = [r for r, row in enumerate(table) if not row[0]]
    if failed:
        raise MetadataError(f"metadata check failed on rank(s) {failed} [{tag or 'array'}]")
    digests, extents = [row[1] for row in table], [row[2] for row in table]
    if len(set(digests)) != 1:
        raise MetadataError(f"cross-rank metadata disagreement for {tag or 'array'}: digests {digests} (this "
                            f"rank: gshape={x.gshape}, split={x.split}, dtype={x.dtype.__name__}, "
                            f"balanced={x.balanced})")
    if x.split is not None:
        want = list(comm.counts_displs_shape(x.gshape, x.split)[0]) if x.balanced else None
        if sum(extents) != x.gshape[x.split] or (want is not None and extents != want):
            raise MetadataError(f"the ranks' extents {extents} along split {x.split} do not make "
                                f"{x.gshape[x.split]}{' as chunk does: ' + str(want) if want else ''} "
                                f"[{tag or 'array'}]")
    return x


if os.environ.get("HEAT_TPU_CHECKS", "").strip().lower() in ("1", "true", "on", "yes"):
    enable_checks()


# ---------------------------------------------------------------------- #
# layouts the estimators take their inputs in
# ---------------------------------------------------------------------- #
def whole(a: DNDarray) -> torch.Tensor:
    """All of ``a`` on every rank: gathered where it is distributed."""
    return (a.resplit(None) if a.is_distributed() else a).larray


def on_rows(x: DNDarray) -> DNDarray:
    """``x`` with its samples on this rank's rows: a distributed array split
    along another axis is resplit to split 0 (one Alltoall)."""
    return x.resplit(0) if x.is_distributed() and x.split != 0 else x


def rows_of(y: DNDarray, x: DNDarray) -> torch.Tensor:
    """The values of ``y`` (flattened) that go with this rank's rows of ``x``
    (split 0 or replicated): y's own rows where they are laid out alike, else
    moved there or sliced from the whole."""
    if not x.is_distributed():
        return whole(y).reshape(-1)
    if y.is_distributed() and y.split == 0:
        yl = y.larray.reshape(-1)
        counts, rows = list(y.counts_displs()[0]), list(x.counts_displs()[0])
        return yl if counts == rows else x.comm.redistribute(yl, 0, counts, rows)
    off = x.counts_displs()[1][x.comm.rank]
    return whole(y).reshape(-1)[off: off + x.lshape[0]]
