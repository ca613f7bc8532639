"""The distributed N-D array (reference: ``heat/core/dndarray.py``).

A :class:`DNDarray` holds this process's LOCAL ``torch.Tensor`` together
with the global shape, the split axis, the device and the communicator.
With ``split=None`` every process holds the whole array; with ``split=k``
process ``r`` holds the ``comm.chunk(gshape, k, r)`` slice of axis ``k``.
An array made by slicing a split array may be unbalanced
(``balanced=False``): its ranks' extents then come from the ranks, not from
``chunk``.  ``redistribute_`` moves rows to any chunk map, ``balance_`` to
``chunk``'s, and ``resplit_`` to another split axis (by the communicator's
Alltoall), in place.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from . import types
from .communication import Communication
from .devices import Device
from .stride_tricks import sanitize_axis

__all__ = ["DNDarray"]

# the metadata check after ``resplit_``: None (one global load) unless
# ``sanitation.enable_checks()`` sets it
_CHECKS = None


class DNDarray:
    """Distributed N-D array: a local tensor plus its global metadata."""

    def __init__(
        self,
        array: torch.Tensor,
        gshape: Tuple[int, ...],
        dtype,
        split: Optional[int],
        device: Device,
        comm: Communication,
        balanced: bool = True,
    ):
        self.__array = array
        self.__gshape = tuple(int(s) for s in gshape)
        self.__dtype = types.canonical_heat_type(dtype)
        self.__split = split
        self.__device = device
        self.__comm = comm
        self.__balanced = balanced

    # ------------------------------------------------------------------ #
    # metadata
    # ------------------------------------------------------------------ #
    @property
    def larray(self) -> torch.Tensor:
        """This process's local tensor."""
        return self.__array

    @property
    def gshape(self) -> Tuple[int, ...]:
        return self.__gshape

    @property
    def shape(self) -> Tuple[int, ...]:
        return self.__gshape

    @property
    def lshape(self) -> Tuple[int, ...]:
        return tuple(self.__array.shape)

    @property
    def ndim(self) -> int:
        return len(self.__gshape)

    @property
    def size(self) -> int:
        return int(np.prod(self.__gshape, dtype=np.int64))

    @property
    def split(self) -> Optional[int]:
        return self.__split

    @property
    def dtype(self):
        return self.__dtype

    @property
    def device(self) -> Device:
        return self.__device

    @property
    def comm(self) -> Communication:
        return self.__comm

    @property
    def balanced(self) -> bool:
        return self.__balanced

    def is_distributed(self) -> bool:
        return self.__split is not None and self.__comm.is_distributed()

    def counts_displs(self) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
        """Every rank's extent and offset along the split axis."""
        if self.__split is None:
            raise ValueError("a non-split array has no counts/displacements")
        if self.__balanced:
            return self.__comm.counts_displs_shape(self.__gshape, self.__split)
        local = torch.tensor([self.lshape[self.__split]], dtype=torch.int64, device=self.__array.device)
        counts = tuple(int(c.item()) for c in self.__comm.Allgather(local))
        displs = tuple(int(d) for d in np.concatenate([[0], np.cumsum(counts)[:-1]]))
        return counts, displs

    def lshape_map(self, force_check: bool = False) -> np.ndarray:
        """(size, ndim) array of every rank's local shape: ``chunk``'s for a
        balanced array, else (or with ``force_check``) the ranks' extents
        gathered, as the reference's method."""
        if self.__split is None or (self.__balanced and not force_check):
            return self.__comm.lshape_map(self.__gshape, self.__split)
        counts = self.__comm._extents(self.__array, self.__split) if force_check else self.counts_displs()[0]
        out = np.tile(np.asarray(self.__gshape, dtype=np.int64), (len(counts), 1))
        out[:, self.__split] = counts
        return out

    @property
    def gnumel(self) -> int:
        """Number of elements of the global array."""
        return self.size

    @property
    def lnumel(self) -> int:
        """Number of elements of this rank's local tensor."""
        return self.__array.numel()

    @property
    def nbytes(self) -> int:
        """Bytes of the global array."""
        return self.size * self.__array.element_size()

    gnbytes = nbytes

    @property
    def lnbytes(self) -> int:
        """Bytes of this rank's local tensor."""
        return self.lnumel * self.__array.element_size()

    @property
    def real(self) -> "DNDarray":
        from . import complex_math

        return complex_math.real(self)

    @property
    def imag(self) -> "DNDarray":
        from . import complex_math

        return complex_math.imag(self)

    @property
    def stride(self) -> Tuple[int, ...]:
        """Row-major strides of the global shape, in elements (the
        reference's; each local tensor is contiguous)."""
        return tuple(int(s) for s in np.cumprod((1,) + self.__gshape[:0:-1])[::-1]) if self.__gshape else ()

    @property
    def strides(self) -> Tuple[int, ...]:
        """:attr:`stride` in bytes."""
        return tuple(s * self.__array.element_size() for s in self.stride)

    @property
    def lloc(self) -> "LocalIndex":
        """Indexing of this rank's local tensor (HeAT's ``x.lloc[...]``)."""
        return LocalIndex(self)

    @property
    def __partitioned__(self) -> dict:
        """The partitioned-array protocol: one partition a rank along the split
        axis (``partition_tiling`` has the rank count there and 1 elsewhere),
        each with its ``start``, ``shape`` and location; ``data`` is this
        rank's local tensor for its own partition and None for the others,
        which live in other processes.  :func:`from_partitioned` inverts it."""
        comm, split, nd = self.__comm, self.__split, self.ndim
        ranks = comm.size if split is not None else 1
        starts = self.counts_displs()[1] if split is not None else (0,)
        parts = {}
        for r, lshape in enumerate(self.lshape_map()[:ranks]):
            pos = tuple(r if i == split else 0 for i in range(nd))
            parts[pos] = {
                "start": tuple(starts[r] if i == split else 0 for i in range(nd)),
                "shape": tuple(int(s) for s in lshape),
                "data": self.__array if r == (comm.rank if split is not None else 0) else None,
                "location": [r if split is not None else comm.rank],
                "dtype": self.__dtype,
            }
        mine = tuple(comm.rank if i == split else 0 for i in range(nd))
        return {
            "shape": self.__gshape,
            "partition_tiling": tuple(ranks if i == split else 1 for i in range(nd)),
            "partitions": parts,
            "locals": [mine],
            "get": lambda x: x,
        }

    # ------------------------------------------------------------------ #
    # conversion
    # ------------------------------------------------------------------ #
    def numpy(self) -> np.ndarray:
        """The GLOBAL array as numpy, gathered to every process.

        bfloat16 is returned as float32 (numpy has no bfloat16)."""
        t = self.__array
        if self.is_distributed():
            t = self.__comm.Allgatherv(t, self.__split)
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()

    def __array__(self, dtype=None, copy=None) -> np.ndarray:
        a = self.numpy()
        return a.astype(dtype) if dtype is not None else a

    def astype(self, dtype, copy: bool = True) -> "DNDarray":
        """This array cast to ``dtype`` (same split, device and communicator):
        a copy, or with ``copy=False`` this array, its local tensor replaced."""
        dtype = types.canonical_heat_type(dtype)
        t = self.__array.to(dtype.torch_type(), copy=copy)
        if copy:
            return DNDarray(t, self.__gshape, dtype, self.__split, self.__device, self.__comm, self.__balanced)
        self.__array, self.__dtype = t, dtype
        return self

    def tolist(self, keepsplit: bool = False) -> List:
        """The global array as nested Python lists."""
        return self.numpy().tolist()

    def item(self):
        """The one element of a one-element array, as a Python scalar."""
        if self.size != 1:
            raise ValueError("only one-element DNDarrays can be converted to scalars")
        t = self.__array if not self.is_distributed() else torch.from_numpy(self.numpy())
        return t.reshape(()).item()

    def __bool__(self) -> bool:
        return bool(self.item())

    def __int__(self) -> int:
        return int(self.item())

    def __float__(self) -> float:
        return float(self.item())

    def __complex__(self) -> complex:
        return complex(self.item())

    def __index__(self) -> int:
        if not issubclass(self.__dtype, (types.integer, types.bool)):
            raise TypeError("only integer scalar arrays can be used as an index")
        return int(self.item())

    @property
    def T(self) -> "DNDarray":
        """The transpose (all axes reversed)."""
        from ..linalg import basics

        return basics.transpose(self)

    def __len__(self) -> int:
        if self.ndim == 0:
            raise TypeError("len() of unsized object")
        return self.__gshape[0]

    def __repr__(self) -> str:
        from . import printing

        return printing.__repr__(self)

    def __str__(self) -> str:
        from . import printing

        return printing.__str__(self)

    def cpu(self) -> "DNDarray":
        """This array on the CPU (:meth:`to_device`)."""
        return self.to_device("cpu")

    def to_device(self, device) -> "DNDarray":
        """This array with its local tensor moved to ``device`` (this array
        where it is there already): the same split, layout and communicator."""
        from .devices import sanitize_device

        device = sanitize_device(device)
        if device == self.__device:
            return self
        t = self.__array.to(device.torch_device)
        return DNDarray(t, self.__gshape, self.__dtype, self.__split, device, self.__comm, self.__balanced)

    # ------------------------------------------------------------------ #
    # distribution
    # ------------------------------------------------------------------ #
    def is_balanced(self, force_check: bool = False) -> bool:
        """HeAT's criterion: the ranks' extents along the split axis differ by
        at most 1.  A ``chunk`` layout always passes; otherwise (or with
        ``force_check``) the ranks' extents are gathered."""
        if not self.is_distributed():
            return True
        if self.__balanced and not force_check:
            return True
        counts = self.__comm._extents(self.__array, self.__split)
        return max(counts) - min(counts) <= 1

    def balance_(self) -> None:
        """Redistribute in place to ``chunk``'s layout (the first n % size
        ranks one row more), which every factory makes."""
        if self.is_distributed() and not self.__balanced:
            self.redistribute_(target_map=self.__comm.lshape_map(self.__gshape, self.__split))

    def redistribute_(self, lshape_map=None, target_map=None) -> None:
        """Move rows along the split axis, in place, from the layout
        ``lshape_map`` (every rank's local shape; gathered when not given) to
        ``target_map`` (``chunk``'s when not given): each rank sends the rows
        of its range that fall in another rank's target range."""
        if self.__split is None:
            return
        split = self.__split
        counts = self.counts_displs()[0] if lshape_map is None else [int(c) for c in np.asarray(lshape_map)[:, split]]
        chunk = self.__comm.lshape_map(self.__gshape, split)
        target = chunk if target_map is None else np.asarray(target_map)
        target = [int(c) for c in target[:, split]]
        self.__array = self.__comm.redistribute(self.__array, split, counts, target)
        self.__balanced = target == [int(c) for c in chunk[:, split]]

    def _resplit_tensor(self, axis: Optional[int], memory_budget=None) -> torch.Tensor:
        counts = None if self.__balanced or self.__split is None else self.counts_displs()[0]
        return self.__comm.resplit(self.__array, self.__gshape, self.__split, axis, counts, memory_budget)

    def resplit_(self, axis: Optional[int] = None, memory_budget=None) -> "DNDarray":
        """Redistribute in place to split axis ``axis`` (None: every rank the
        whole array): split to split by one Alltoall, split to None by an
        Allgatherv, None to split by a local slice.  The result takes
        ``chunk``'s layout.

        ``memory_budget`` (bytes or a K/M/G string; ``None``: the process
        default of ``ht.set_redistribution_budget``/``HEAT_TPU_RESPLIT_BUDGET``)
        bounds the bytes moved a step: an array past it streams as K tiled
        collectives (``core.redistribution``), and its old chunk is dropped
        once its last tile has left it."""
        axis = sanitize_axis(self.__gshape, axis)
        if axis == self.__split:
            return self
        counts = None if self.__balanced or self.__split is None else self.counts_displs()[0]
        box = [self.__array]
        self.__array = None  # the box holds the only reference, which the tiled path drops
        try:
            self.__array = self.__comm.resplit(box, self.__gshape, self.__split, axis, counts, memory_budget,
                                               donate=True)
        except BaseException:
            if box:
                self.__array = box[0]
            raise
        self.__split, self.__balanced = axis, True
        if _CHECKS is not None:
            _CHECKS(self, "resplit_")
        return self

    def resplit(self, axis: Optional[int] = None, memory_budget=None) -> "DNDarray":
        """A copy of this array split along ``axis`` (see :meth:`resplit_`)."""
        axis = sanitize_axis(self.__gshape, axis)
        if axis == self.__split:
            return DNDarray(self.__array.clone(), self.__gshape, self.__dtype, axis, self.__device, self.__comm,
                            self.__balanced)
        t = self._resplit_tensor(axis, memory_budget)
        if t is self.__array:
            t = t.clone()
        return DNDarray(t, self.__gshape, self.__dtype, axis, self.__device, self.__comm, True)


    # ------------------------------------------------------------------ #
    # indexing
    # ------------------------------------------------------------------ #
    def _normalized_key(self, key) -> tuple:
        """``key`` as a tuple whose index arrays are ``torch.Tensor``s (int64
        or bool, on this array's device) or DNDarrays, as the reference's
        ``_normalized_key`` makes them ``jax.Array``s."""
        tdev = self.__array.device

        def conv(k):
            if isinstance(k, (list, np.ndarray)):
                k = np.asarray(k)
                k = torch.from_numpy(k.astype(np.int64) if k.size == 0 and k.dtype.kind == "f" else k)
            if isinstance(k, torch.Tensor):
                if k.dtype != torch.bool and (k.is_floating_point() or k.is_complex()):
                    raise IndexError("arrays used as indices must be of integer (or boolean) type")
                return k.to(device=tdev, dtype=torch.bool if k.dtype == torch.bool else torch.int64)
            if isinstance(k, DNDarray) and not (k.dtype is types.bool or issubclass(k.dtype, types.integer)):
                raise IndexError("arrays used as indices must be of integer (or boolean) type")
            return int(k) if isinstance(k, np.integer) else k

        return tuple(conv(k) for k in key) if isinstance(key, tuple) else (conv(key),)

    def _result_split_of_key(self, key: tuple) -> Optional[int]:
        """The split axis of ``self[key]`` (None: replicated), the reference's
        rule (``heat_tpu/core/dndarray.py::_result_split_of_key``), which an
        index array on the split axis sends to 0 wherever numpy places it."""
        if self.__split is None:
            return None
        key_t = key
        if any(k is Ellipsis for k in key_t):
            n_specified = sum(1 for k in key_t if k is not None and k is not Ellipsis)
            fill = self.ndim - n_specified
            out = []
            for k in key_t:
                if k is Ellipsis:
                    out.extend([slice(None)] * fill)
                else:
                    out.append(k)
            key_t = tuple(out)
        in_ax = 0
        out_ax = 0
        has_advanced = any(_is_array(k) for k in key_t)
        for k in key_t:
            if k is None:
                out_ax += 1
                continue
            if in_ax == self.__split:
                if isinstance(k, slice):
                    return out_ax
                if isinstance(k, (int, np.integer)):
                    return None
                if has_advanced and not isinstance(k, (bool, np.bool_)):
                    return 0
                return None
            if isinstance(k, (int, np.integer)):
                in_ax += 1
            elif isinstance(k, slice):
                in_ax += 1
                out_ax += 1
            else:
                in_ax += k.ndim if _is_array(k) and _is_bool(k) else 1
                out_ax += 1
        if in_ax <= self.__split:
            return out_ax + (self.__split - in_ax)
        return None

    def _key(self, key) -> "_Key":
        """``key`` parsed against this array's global shape, and the split of
        the result by the reference's rule."""
        nkey = self._normalized_key(key)
        parsed = _Key(nkey, self.__gshape, self.__array.device, self.__comm, self.__split)
        split = self._result_split_of_key(nkey)
        parsed.split = None if split is None or split >= len(parsed.shape) else split
        return parsed

    def __getitem__(self, key) -> "DNDarray":
        """``self[key]`` with numpy's semantics for every kind of key (ints,
        slices of any step, Ellipsis, None, integer and boolean index arrays
        as lists, numpy, ``torch.Tensor`` or DNDarray), split by the
        reference's rule.  The result never shares storage with this array.

        On several ranks a key that keeps the split axis's order (a slice of
        positive step, a boolean mask starting at the split axis) moves no
        data: each rank selects from its own elements, which may leave the
        result unbalanced.  A key that reorders or picks along the split axis
        moves only the slabs that change rank (:meth:`_take`); a split axis
        that the rule replicates is gathered."""
        k = self._key(key)
        if not self.is_distributed():
            t = _index(self.__array, k.entries, k)
            return DNDarray(t, k.shape, self.__dtype, k.split, self.__device, self.__comm, True)
        local = self._local_part(k)
        if local is None:
            return self._take(k)
        entries, counts, _ = local
        t = _index(self.__array, entries, k)
        return self._place(t, k.axis_of_split, counts, k)

    def _local_part(self, k: "_Key"):
        """(entries, counts, offset) where ``k`` selects along the split axis in
        the global order from each rank's own elements: the key with the split
        axis's entry made local, every rank's extent of the result along
        ``k.axis_of_split`` and this rank's offset there; None otherwise (a
        reordering or picking key, or a mask that does not start at the split
        axis)."""
        i, e = k.entry_of_axis(self.__split)
        counts, displs = self.counts_displs()
        rank = self.__comm.rank
        if e[0] == "slice" and e[3] > 0:
            runs = [_slice_positions(*e[1:4], d, d + c) for c, d in zip(counts, displs)]
            p0, p1 = runs[rank]
            start = e[1] + p0 * e[3] - displs[rank]
            local = ("slice", start, start + (p1 - p0) * e[3], e[3], e[4])
            ext = [b - a for a, b in runs]
        elif e[0] == "adv" and k.mask_starts(i, self.__split) and k.n_arrays == 1:
            mask, ext = self._mask_part(e[1], 0)
            local = ("adv", mask, e[2])
        else:
            return None
        entries = list(k.entries)
        entries[i] = local
        return entries, ext, sum(ext[:rank])

    def _mask_part(self, mask, axis: int):
        """This rank's part of the boolean ``mask`` (a tensor or DNDarray)
        along its ``axis``, which lies over this array's split axis, and every
        rank's count of True in its part."""
        counts, displs = self.counts_displs()
        rank, comm = self.__comm.rank, self.__comm
        if isinstance(mask, DNDarray):
            if mask.is_distributed():
                m = mask if mask.split == axis else mask.resplit(axis)
                local = comm.redistribute(m.larray, axis, m.counts_displs()[0], counts).to(self.__array.device)
                trues = comm.Allgather(local.sum().reshape(1).to(torch.int64))
                return local, [int(c) for c in torch.cat(trues).tolist()]
            mask = mask.larray.to(self.__array.device)
        sums = mask.movedim(axis, 0).reshape(mask.shape[axis], -1).sum(1)
        trues = torch.stack([sums[d : d + c].sum() for c, d in zip(counts, displs)]).tolist()
        return mask.narrow(axis, displs[rank], counts[rank]), [int(c) for c in trues]

    def _place(self, t: torch.Tensor, axis: int, counts, k: "_Key") -> "DNDarray":
        """The result of ``k`` from this rank's block ``t`` along the result's
        ``axis`` (the ranks' blocks in rank order, of extents ``counts``),
        moved to the rule's split: kept there (unbalanced where ``counts``
        are not ``chunk``'s), gathered for None, or cut along the rule's axis
        by one Alltoall."""
        comm, split = self.__comm, k.split
        wire = t.view(torch.uint8) if t.dtype == torch.bool else t
        if split is None:
            t = comm.Allgatherv(wire, axis, counts=counts).view(t.dtype)
            return DNDarray(t, k.shape, self.__dtype, None, self.__device, comm, True)
        chunk = comm.counts_displs_shape(k.shape, split)[0]
        if split == axis:
            return DNDarray(t, k.shape, self.__dtype, split, self.__device, comm, list(counts) == list(chunk))
        t = comm.Alltoall(wire, split, axis, send_counts=chunk, recv_counts=counts).view(t.dtype)
        return DNDarray(t, k.shape, self.__dtype, split, self.__device, comm, True)

    def _take(self, k: "_Key") -> "DNDarray":
        """``self[k]`` for a key that reorders or picks along the split axis:
        each rank computes its ``chunk`` of the result along the rule's split
        (all of it for None) from the slabs along the split axis that its
        part names.  Every rank knows every part (the key is the same on all
        of them), so one exchange sends each rank the slabs it needs that
        another rank holds; a slab a rank holds itself does not move."""
        s, comm, rank = self.__split, self.__comm, self.__comm.rank
        idx = k.explicit()
        parts = [k.narrow(idx, q) for q in range(comm.size)]
        need = [torch.unique(part[s]) for part in parts]
        counts, displs = self.counts_displs()
        ends = torch.tensor(np.cumsum(counts), device=self.__array.device)
        lo, hi = displs[rank], displs[rank] + counts[rank]
        pieces = [self.__array.index_select(s, rows[(rows >= lo) & (rows < hi)] - lo) for rows in need]
        held = torch.bincount(torch.searchsorted(ends, need[rank], right=True), minlength=comm.size).tolist()
        shapes = [self.lshape[:s] + (n,) + self.lshape[s + 1 :] for n in held]
        slabs = torch.cat(comm.exchange(pieces, shapes, self.__array), dim=s)
        mine = list(parts[rank])
        mine[s] = torch.searchsorted(need[rank], mine[s].contiguous())
        return DNDarray(slabs[tuple(mine)], k.shape, self.__dtype, k.split, self.__device, comm, True)

    def _gather_rows(self, idx: torch.Tensor) -> torch.Tensor:
        """Global rows ``idx`` (int64, on this array's device) on every rank;
        a row moves only from its owner to the ranks that lack it."""
        if not self.is_distributed() or self.__split != 0:
            return self.__array[idx]
        k = self._key(idx)
        k.split = None
        return self._take(k).larray

    def __setitem__(self, key, value) -> None:
        """``self[key] = value`` for every key of :meth:`__getitem__`.
        ``value`` (a Python scalar, numpy, ``torch.Tensor`` or DNDarray) is
        broadcast to the indexed region and cast to this array's dtype.  Each
        rank writes only the elements it holds.  A DNDarray value split
        otherwise than the region is moved to the region's per-rank extents
        (``redistribute``, or :meth:`_put`'s exchange); it is never gathered
        whole, unless it broadcasts along the region's split axis, where
        every rank needs all of it."""
        k = self._key(key)
        dtype = self.__dtype.torch_type()
        tdev = self.__array.device
        if isinstance(value, DNDarray):
            if value.is_distributed() and (not self.is_distributed() or value.ndim > len(k.shape)):
                value = value.resplit(None)
            if not value.is_distributed():
                value = value.larray
        if not isinstance(value, DNDarray):
            value = torch.as_tensor(value, device=tdev)
            value = value.to(dtype) if value.dtype != dtype else value
            value = value.reshape(value.shape[_leading_ones(value.shape, len(k.shape)) :])
        if not self.is_distributed():
            _assign(self.__array, k.entries, k, value)
            return
        s = self.__split
        i, e = k.entry_of_axis(s)
        if not isinstance(value, DNDarray) and value.numel() == 1 and e[0] == "adv" and _is_bool(e[1]):
            # one value for every selected element: each rank's part of the mask will do
            entries = list(k.entries)
            entries[i] = ("adv", self._mask_part(e[1], s - e[2][0])[0], e[2])
            _assign(self.__array, entries, k, value.reshape(()))
            return
        local = self._local_part(k)
        if local is None:
            self._put(k, value)
            return
        entries, counts, offset = local
        axis = k.axis_of_split
        if isinstance(value, DNDarray):
            value = self._value_along(value, k, axis, counts)
        else:
            # the ranks' blocks in rank order: this rank's values start at the
            # exclusive scan of the ranks' extents (for a mask, its True counts)
            value = _part_along(value, axis, len(k.shape), offset, counts[self.__comm.rank])
        _assign(self.__array, entries, k, value)

    def _value_along(self, value: "DNDarray", k: "_Key", axis: int, counts) -> torch.Tensor:
        """This rank's block of the distributed ``value`` broadcast to the
        region of ``k``, whose ranks hold ``counts`` along its ``axis``: the
        value resplit to that axis where split elsewhere, then its rows moved
        to ``counts`` (``redistribute``).  A value that broadcasts along
        ``axis`` is gathered: every rank needs all of it."""
        lead = len(k.shape) - value.ndim
        vaxis = axis - lead
        along = vaxis >= 0 and value.gshape[vaxis] == k.shape[axis]
        if not along:
            return value.resplit(None).larray.to(self.__dtype.torch_type())
        if value.split != vaxis:
            value = value.resplit(vaxis)
        t = self.__comm.redistribute(value.larray, vaxis, value.counts_displs()[0], counts)
        return t.to(self.__dtype.torch_type())

    def _put(self, k: "_Key", value) -> None:
        """``self[k] = value`` for a key that reorders or picks along the
        split axis: a slice of negative step, an int, or index arrays there.
        Each rank writes the elements it holds with one local assignment:
        a run of the region's positions along the axis that the slice lays
        out (:meth:`_put_run`), the whole region on the int's owner
        (:meth:`_put_owner`), or the elements of the index arrays' broadcast
        shape whose split-axis index falls in its rows (:meth:`_put_picked`).
        A tensor ``value`` (the same on every rank) is cut to this rank's
        part.  A distributed DNDarray value is moved there from the ranks
        that hold it, by one exchange; one that broadcasts along the axis
        that carries the split is gathered, since every rank needs all of
        it."""
        i, e = k.entry_of_axis(self.__split)
        if e[0] == "slice":
            self._put_run(k, i, e, value)
        elif e[0] == "int" and not k.n_arrays:
            self._put_owner(k, i, e, value)
        else:
            self._put_picked(k, value)

    def _spanning(self, value, region_axis: int, k: "_Key"):
        """``value`` as a tensor of this array's dtype where it is not
        distributed or broadcasts along the region's ``region_axis`` (gathered
        then); else the DNDarray resplit along that axis, and its axis."""
        dtype = self.__dtype.torch_type()
        if not isinstance(value, DNDarray):
            return value, None
        vaxis = region_axis - (len(k.shape) - value.ndim)
        if vaxis < 0 or value.gshape[vaxis] != k.shape[region_axis]:
            return value.resplit(None).larray.to(dtype), None
        return (value if value.split == vaxis else value.resplit(vaxis)), vaxis

    def _put_run(self, k: "_Key", i: int, e, value) -> None:
        """``_put`` where the split axis's entry ``e`` (at ``i``) is a slice:
        rank q holds a run [p0, p1) of the positions along the region's axis
        that the slice lays out.  A DNDarray value split there sends each
        rank the part of its block that falls in that rank's run."""
        comm, rank = self.__comm, self.__comm.rank
        counts, displs = self.counts_displs()
        axis = k.out_axes[i]
        runs = [_slice_positions(*e[1:4], d, d + c) for c, d in zip(counts, displs)]
        p0, p1 = runs[rank]
        value, vaxis = self._spanning(value, axis, k)
        if vaxis is not None:
            vcounts, vdispls = value.counts_displs()
            t = value.larray.to(self.__dtype.torch_type())
            lo, hi = vdispls[rank], vdispls[rank] + vcounts[rank]
            pieces = [t.narrow(vaxis, min(max(a, lo), hi) - lo, max(min(b, hi) - max(a, lo), 0)) for a, b in runs]
            shapes = [_with(t.shape, vaxis, max(min(p1, d + c) - max(p0, d), 0)) for c, d in zip(vcounts, vdispls)]
            value = torch.cat(comm.exchange(pieces, shapes, t), dim=vaxis)
        else:
            value = _part_along(value, axis, len(k.shape), p0, p1 - p0)
        start = e[1] + p0 * e[3] - displs[rank]
        stop = start + (p1 - p0) * e[3]
        key = _numpy_key(k.entries, {i: slice(start, stop if stop >= 0 else None, e[3])}, k.device)
        if p1 > p0:
            self._assign_local(key, value)

    def _put_owner(self, k: "_Key", i: int, e, value) -> None:
        """``_put`` where the split axis's entry ``e`` (at ``i``) is an int:
        its owner writes the whole region.  A distributed DNDarray value
        sends it every rank's block."""
        comm, rank = self.__comm, self.__comm.rank
        counts, displs = self.counts_displs()
        owner = int(np.searchsorted(np.cumsum(counts), e[1], side="right"))
        if isinstance(value, DNDarray):
            vs, vcounts = value.split, value.counts_displs()[0]
            t = value.larray.to(self.__dtype.torch_type())
            pieces = [t if q == owner else t.narrow(vs, 0, 0) for q in range(comm.size)]
            shapes = [_with(t.shape, vs, c if rank == owner else 0) for c in vcounts]
            value = torch.cat(comm.exchange(pieces, shapes, t), dim=vs)
        key = _numpy_key(k.entries, {i: e[1] - displs[rank]}, k.device)
        if rank == owner:
            self._assign_local(key, value)

    def _put_picked(self, k: "_Key", value) -> None:
        """``_put`` where index arrays (and the ints beside them) carry the
        split axis: rank q holds the elements of their broadcast shape whose
        split-axis index falls in its rows.  A DNDarray value split along the
        region's first broadcast axis sends each slab (the value's elements
        at one element of the broadcast shape) to the rank that holds it,
        with the slab's flat position in the broadcast shape: one Allgather
        of counts, one exchange of positions, one of values."""
        s, comm, rank = self.__split, self.__comm, self.__comm.rank
        counts, displs = self.counts_displs()
        tdev = self.__array.device
        idx = k.explicit()
        picked = {}
        for e in k.entries:
            if e[0] == "adv" or e[0] == "int":
                for a in (e[2] if e[0] == "adv" else (e[2],)):
                    picked[a] = idx[a].reshape(-1)
        owner = torch.searchsorted(torch.tensor(np.cumsum(counts), device=tdev), picked[s].contiguous(), right=True)
        nb, b0 = len(k.b_shape), k.b_pos
        b_axes = tuple(range(b0, b0 + nb))
        value, vaxis = self._spanning(value, b0, k)
        if vaxis is not None:
            vcounts, vdispls = value.counts_displs()
            inner = math.prod(k.b_shape[1:])
            block = _with(k.shape, b0, vcounts[rank])
            t = value.larray.to(self.__dtype.torch_type())
            t = t.reshape((1,) * (len(k.shape) - value.ndim) + tuple(t.shape)).expand(block)
            slabs = t.movedim(b_axes, tuple(range(nb))).reshape([-1] + block[:b0] + block[b0 + nb :])
            pos = torch.arange(vdispls[rank] * inner, (vdispls[rank] + vcounts[rank]) * inner, device=tdev)
            dest = owner[pos]
            order = torch.argsort(dest, stable=True)
            sent = torch.bincount(dest, minlength=comm.size)
            table = torch.stack(comm.Allgather(sent)).tolist()
            got = [table[q][rank] for q in range(comm.size)]
            split_sizes = sent.tolist()
            flat = torch.cat(comm.exchange(torch.split(pos[order], split_sizes), [[n] for n in got], pos))
            rest = list(slabs.shape[1:])
            value = torch.cat(comm.exchange(torch.split(slabs[order], split_sizes), [[n] + rest for n in got], slabs))
            value = value.movedim(0, b0)
        else:
            flat = torch.nonzero(owner == rank).reshape(-1)
            if value.numel() == 1:
                value = value.reshape(())
            else:
                v = value.broadcast_to(k.shape).movedim(b_axes, tuple(range(nb)))
                value = v[_unravel(flat, k.b_shape)].movedim(0, b0)
        local = {a: t[flat] - (displs[rank] if a == s else 0) for a, t in picked.items()}
        key = _numpy_key(k.entries, local, k.device, by_axis=True)
        if flat.numel():
            self._assign_local(key, value)

    def _assign_local(self, key: tuple, value: torch.Tensor) -> None:
        """``self.larray[key] = value`` with numpy's semantics for a numpy
        key of tensors, ints and slices in local coordinates."""
        k = _Key(key, self.lshape, self.__array.device, self.__comm, None)
        _assign(self.__array, k.entries, k, value)

    def fill_diagonal(self, value) -> "DNDarray":
        """Set the diagonal of the last two axes to ``value``, in place, and
        return this array: each rank writes the diagonal elements it holds."""
        if self.ndim < 2:
            return self
        n = min(self.__gshape[-2], self.__gshape[-1])
        t, s = self.__array, self.__split
        v = torch.as_tensor(value, device=t.device).to(self.__dtype.torch_type())
        if v.numel() != 1:
            v = v.broadcast_to(self.__gshape[:-2] + (n,))
        if not self.is_distributed() or s < self.ndim - 2:
            if v.ndim and self.is_distributed():
                counts, displs = self.counts_displs()
                v = v.narrow(s, displs[self.__comm.rank], counts[self.__comm.rank])
            j = torch.arange(n, device=t.device)
            t[..., j, j] = v
            return self
        counts, displs = self.counts_displs()
        off, cnt = displs[self.__comm.rank], counts[self.__comm.rank]
        lo, hi = min(off, n), min(off + cnt, n)
        j = torch.arange(lo, hi, device=t.device)
        v = v[..., lo:hi] if v.ndim else v
        if s == self.ndim - 2:
            t[..., j - off, j] = v
        else:
            t[..., j, j - off] = v
        return self


class LocalIndex:
    """``x.lloc``: indexing of the rank's local tensor, as HeAT's (the JAX
    package, one controller, indexes the global array)."""

    def __init__(self, arr: DNDarray):
        self.arr = arr

    def __getitem__(self, key):
        return self.arr.larray[key]

    def __setitem__(self, key, value):
        self.arr.larray[key] = value


def _is_array(k) -> bool:
    return isinstance(k, (torch.Tensor, DNDarray))


def _is_bool(k) -> bool:
    return k.dtype is types.bool if isinstance(k, DNDarray) else k.dtype == torch.bool


def _leading_ones(shape, ndim: int) -> int:
    """How many leading axes of ``shape`` lie beyond ``ndim`` axes (numpy
    drops them from an assigned value, which must hold 1 there)."""
    extra = max(len(shape) - ndim, 0)
    if any(s != 1 for s in shape[:extra]):
        raise ValueError(f"could not broadcast a value of shape {tuple(shape)} into {ndim} dimensions")
    return extra


def _slice_positions(start: int, stop: int, step: int, lo: int, hi: int) -> Tuple[int, int]:
    """The run [p0, p1) of positions of ``range(start, stop, step)`` whose
    indices lie in [lo, hi)."""
    n = len(range(start, stop, step))
    if step > 0:
        p0, p1 = -(-(lo - start) // step), -(-(hi - start) // step)
    else:
        p0, p1 = -(-(start - hi + 1) // -step), (start - lo) // -step + 1
    p0, p1 = min(max(p0, 0), n), min(max(p1, 0), n)
    return p0, max(p0, p1)


def _part_along(value: torch.Tensor, axis: int, ndim: int, start: int, n: int) -> torch.Tensor:
    """``value``, which broadcasts to an ``ndim``-axis region, cut to
    [start, start + n) along the region's ``axis`` (as it is where it
    broadcasts along that axis)."""
    if value.ndim >= ndim - axis and value.shape[axis - ndim] != 1:
        return value.narrow(axis - ndim, start, n)
    return value


def _with(shape, axis: int, n: int) -> List[int]:
    """``shape`` as a list, with ``n`` at ``axis``."""
    out = list(shape)
    out[axis] = n
    return out


def _unravel(flat: torch.Tensor, shape) -> Tuple[torch.Tensor, ...]:
    """The coordinates in ``shape`` of the row-major positions ``flat``."""
    out = []
    for n in reversed(shape):
        out.append(flat % n)
        flat = flat // n
    return tuple(reversed(out))


def _numpy_key(entries, replace: dict, device, by_axis: bool = False) -> tuple:
    """The numpy key of ``entries`` (index arrays as tensors on ``device``,
    gathered where a distributed DNDarray; every rank calls it), with
    ``replace`` in place of the entries it names by position, or, with
    ``by_axis``, of the input axes of the index arrays and of the ints
    beside them (one 1-D tensor an axis)."""
    key = []
    for j, e in enumerate(entries):
        kind = e[0]
        if not by_axis and j in replace:
            key.append(replace[j])
        elif by_axis and kind == "adv":
            key.extend(replace[a] for a in e[2])
        elif by_axis and kind == "int" and e[2] in replace:
            key.append(replace[e[2]])
        elif kind == "new":
            key.append(None)
        elif kind == "int":
            key.append(e[1])
        elif kind == "slice":
            empty = not len(range(*e[1:4]))
            key.append(slice(0, 0) if empty else slice(e[1], e[2] if e[2] >= 0 else None, e[3]))
        else:
            key.append(_whole(e[1], device))
    return tuple(key)


def _unaliased(t: torch.Tensor, source: torch.Tensor) -> torch.Tensor:
    """``t``, copied where it shares storage with ``source``."""
    if t.numel() and t.untyped_storage().data_ptr() == source.untyped_storage().data_ptr():
        return t.clone(memory_format=torch.contiguous_format)
    return t


def _torch_key(entries, k: "_Key"):
    """The torch key of ``entries`` and the result axes to flip: torch takes
    no negative step (a slice of one becomes its positive mirror, flipped),
    and an int beside an index array counts as one (numpy's rule for where
    the broadcast axes go) only as a 1-element tensor."""
    key, flips = [], []
    for i, e in enumerate(entries):
        kind = e[0]
        if kind == "new":
            key.append(None)
        elif kind == "int":
            key.append(torch.tensor([e[1]], device=k.device) if k.n_arrays else e[1])
        elif kind == "slice":
            start, stop, step = e[1:4]
            if step < 0:
                n = len(range(start, stop, step))
                key.append(slice(start + (n - 1) * step, start + 1, -step) if n else slice(0, 0))
                flips.append(k.out_axes[i])
            else:
                key.append(slice(start, stop, step))
        else:
            key.append(_whole(e[1], k.device))
    return tuple(key), flips


def _index(t: torch.Tensor, entries, k: "_Key") -> torch.Tensor:
    """``t[entries]`` with numpy's semantics, never a view of ``t``."""
    key, flips = _torch_key(entries, k)
    r = t[key]
    return r.flip(flips) if flips else _unaliased(r, t)


def _assign(t: torch.Tensor, entries, k: "_Key", value: torch.Tensor) -> None:
    """``t[entries] = value`` with numpy's semantics (``value`` already of
    ``t``'s dtype, broadcastable to the region).  A negative step flips the
    value along the axes it spans, before it is broadcast: flipping the
    broadcast region instead would materialize all of it."""
    key, flips = _torch_key(entries, k)
    lead = len(k.shape) - value.ndim
    dims = [a - lead for a in flips if a >= lead and value.shape[a - lead] != 1]
    t[key] = value.flip(dims) if dims else value


class _Key:
    """A key parsed against a global shape: ``entries`` one a key element,
    Ellipsis expanded and the axes left over indexed whole.  An entry is
    ``("new",)`` for None, ``("int", i, axis)``, ``("slice", start, stop,
    step, axis)`` (normalized: ``range(start, stop, step)`` are the indices)
    or ``("adv", t, axes)`` for an index array ``t`` over ``axes`` (int64 or
    bool; a boolean one over as many axes as it has).  ``shape`` is the
    result's global shape by numpy's rule: the broadcast axes of the index
    arrays (and of the ints, where an array is present) go where the first of
    them stood if they are adjacent, else first; ``out_axes`` gives each
    slice's and None's result axis."""

    def __init__(self, key: tuple, gshape: Tuple[int, ...], device, comm: Communication, split_axis: Optional[int]):
        self.device, self.comm, self.split_axis = device, comm, split_axis
        self.split = None  # the result's, set by the caller
        self.ndim_in = len(gshape)
        key = tuple(_scalar_index(k) for k in key)
        used = sum(k.ndim if _is_array(k) and _is_bool(k) else 1 for k in key if k is not None and k is not Ellipsis)
        n_ell = sum(1 for k in key if k is Ellipsis)
        if n_ell > 1:
            raise IndexError("an index can only have a single ellipsis ('...')")
        if used > len(gshape):
            raise IndexError(f"too many indices for array: array is {len(gshape)}-dimensional, but {used} were indexed")
        fill = [slice(None)] * (len(gshape) - used)
        if n_ell:
            at = next(i for i, k in enumerate(key) if k is Ellipsis)
            key = key[:at] + tuple(fill) + key[at + 1 :]
        else:
            key = key + tuple(fill)
        self.entries, axis = [], 0
        for k in key:
            if k is None:
                self.entries.append(("new",))
            elif isinstance(k, (bool, np.bool_)):
                raise NotImplementedError("a Python bool as an index is not supported")
            elif isinstance(k, int):
                n = gshape[axis]
                if not -n <= k < n:
                    raise IndexError(f"index {k} is out of bounds for axis {axis} with size {n}")
                self.entries.append(("int", k % n, axis))
                axis += 1
            elif isinstance(k, slice):
                self.entries.append(("slice",) + k.indices(gshape[axis]) + (axis,))
                axis += 1
            elif _is_array(k):
                self.entries.append(_array_entry(k, gshape, axis, device))
                axis += len(self.entries[-1][2])
            else:
                raise IndexError(f"only integers, slices (':'), ellipsis ('...'), None and integer or boolean "
                                 f"arrays are valid indices, got {type(k).__name__}")
        self._layout()

    def _layout(self) -> None:
        arrays = [i for i, e in enumerate(self.entries) if e[0] == "adv"]
        self.n_arrays = len(arrays)
        adv = arrays + ([i for i, e in enumerate(self.entries) if e[0] == "int"] if arrays else [])
        shapes = []
        for i in arrays:
            t = self.entries[i][1]
            shapes.append((_count_true(t),) if _is_bool(t) else tuple(t.shape))
        self.b_shape = tuple(np.broadcast_shapes(*shapes)) if shapes else ()
        adjacent = bool(adv) and max(adv) - min(adv) + 1 == len(adv)
        basic = [i for i, e in enumerate(self.entries) if e[0] in ("slice", "new")]
        self.b_pos = sum(1 for i in basic if adv and i < min(adv)) if adjacent else 0
        out, self.out_axes = [], {}
        for i in basic:
            self.out_axes[i] = len(out) + (len(self.b_shape) if adv and (not adjacent or i > min(adv)) else 0)
            out.append(1 if self.entries[i][0] == "new" else len(range(*self.entries[i][1:4])))
        if adv:
            out[self.b_pos : self.b_pos] = list(self.b_shape)
        self.shape = tuple(out)

    def entry_of_axis(self, axis: int):
        """(position, entry) of the entry that indexes input ``axis``."""
        for i, e in enumerate(self.entries):
            if e[0] == "int" or e[0] == "slice":
                if e[-1] == axis:
                    return i, e
            elif e[0] == "adv" and axis in e[2]:
                return i, e
        raise IndexError(f"no entry indexes axis {axis}")

    def mask_starts(self, i: int, axis: int) -> bool:
        """Whether entry ``i`` is a boolean mask whose first axis is ``axis``."""
        e = self.entries[i]
        return e[0] == "adv" and _is_bool(e[1]) and e[2][0] == axis

    @property
    def axis_of_split(self) -> int:
        """The result axis along which the split axis's entry (a slice, or a
        mask starting there, the only array) lays out its elements."""
        i, e = self.entry_of_axis(self.split_axis)
        return self.out_axes[i] if e[0] == "slice" else self.b_pos

    def explicit(self) -> List[torch.Tensor]:
        """For each input axis, the index of each result element along it, as
        a tensor that broadcasts to :attr:`shape` (numpy's integer-array form
        of the key).  Index arrays come replicated: a distributed DNDarray is
        gathered."""
        nd, dev = len(self.shape), self.device
        idx = [None] * self.ndim_in
        arrays = []
        for e in self.entries:
            if e[0] == "adv":
                t = _whole(e[1], dev)
                if _is_bool(t):
                    arrays += list(zip(e[2], t.nonzero(as_tuple=True)))
                else:
                    arrays.append((e[2][0], t))
            elif e[0] == "int" and self.n_arrays:
                arrays.append((e[2], torch.tensor(e[1], device=dev)))
        view = [1] * self.b_pos + list(self.b_shape) + [1] * (nd - self.b_pos - len(self.b_shape))
        for axis, t in arrays:
            idx[axis] = t.broadcast_to(self.b_shape).reshape(view)
        for i, e in enumerate(self.entries):
            if e[0] == "slice":
                v = [1] * nd
                v[self.out_axes[i]] = -1
                idx[e[4]] = torch.arange(e[1], e[2], e[3], device=dev).reshape(v)
            elif e[0] == "int" and not self.n_arrays:
                idx[e[2]] = torch.full([1] * nd, e[1], device=dev)
        return idx

    def narrow(self, idx: List[torch.Tensor], rank: int) -> List[torch.Tensor]:
        """``idx`` (:meth:`explicit`) cut to rank ``rank``'s ``chunk`` of the
        result along :attr:`split` (all of it where the split is None)."""
        if self.split is None:
            return idx
        off, lshape, _ = self.comm.chunk(self.shape, self.split, rank)
        cnt, full = lshape[self.split], self.shape[self.split]
        return [t.narrow(self.split, off, cnt) if t.shape[self.split] == full else t for t in idx]


def _scalar_index(k):
    """A 0-d integer index array as the int it is (numpy's treatment)."""
    if isinstance(k, torch.Tensor) and k.ndim == 0 and k.dtype != torch.bool:
        return int(k)
    if isinstance(k, DNDarray) and k.ndim == 0 and k.dtype is not types.bool:
        return int(k.item())
    return k


def _whole(t, device) -> torch.Tensor:
    """Index array ``t`` as a tensor on ``device``: a DNDarray's global one
    (gathered where distributed)."""
    if isinstance(t, DNDarray):
        t = (t.resplit(None) if t.is_distributed() else t).larray
    return t.to(device)


def _array_entry(k, gshape, axis: int, device):
    """The entry of index array ``k`` at input ``axis``: a boolean one checked
    against the axes it covers, an integer one (gathered where distributed)
    checked against its axis and made non-negative."""
    if _is_bool(k):
        axes = tuple(range(axis, axis + k.ndim))
        if tuple(k.shape) != tuple(gshape[axis : axis + k.ndim]):
            raise IndexError(f"boolean index of shape {tuple(k.shape)} does not match the indexed axes "
                             f"{tuple(gshape[axis : axis + k.ndim])}")
        return ("adv", k, axes)
    t = _whole(k, device).to(torch.int64)
    n = gshape[axis]
    if t.numel() and bool(((t < -n) | (t >= n)).any()):
        raise IndexError(f"index out of bounds for axis {axis} with size {n}")
    return ("adv", torch.where(t < 0, t + n, t), (axis,))


def _count_true(mask) -> int:
    """The number of True in a boolean mask (a tensor or DNDarray; summed
    over the ranks where distributed)."""
    if isinstance(mask, DNDarray):
        local = mask.larray.sum().reshape(1).to(torch.int64)
        return int(mask.comm.Allreduce(local).item()) if mask.is_distributed() else int(local.item())
    return int(mask.sum())
