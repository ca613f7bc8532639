"""Streaming datasets for files larger than memory (reference:
``heat/utils/data/partial_dataset.py``).

``PartialH5Dataset`` iterates an HDF5 dataset in blocks of ``load_length``
rows, each yielded as a DNDarray split 0: every rank reads only its
``chunk`` of each block, and a background thread reads the next block
while the current one is used.  h5py is imported where the file is
opened.
"""

from __future__ import annotations

import queue
import threading
from typing import Optional

import numpy as np
import torch

from ...core import devices, types
from ...core.communication import sanitize_comm
from ...core.dndarray import DNDarray

__all__ = ["PartialH5Dataset", "PartialH5DataLoaderIter"]


class PartialH5Dataset:
    """Iterate an HDF5 dataset in blocks without loading it whole.

    Parameters are the reference's: ``file``, ``comm``, ``dataset_names``
    (one name, or several read in step), ``initial_load`` (rows a block)
    or ``load_length``, ``transforms`` (applied to each rank's numpy rows);
    ``use_gpu``, ``np_buffer`` and ``np_buffer_dataset_names`` are accepted
    for parity (placement follows the default device, or ``device``)."""

    def __init__(self, file: str, comm=None, dataset_names="data", initial_load: int = 7000,
                 load_length: Optional[int] = None, use_gpu: bool = True, np_buffer: bool = True,
                 np_buffer_dataset_names="data", transforms=None, device=None):
        try:
            import h5py
        except ImportError as e:
            raise RuntimeError("PartialH5Dataset requires h5py") from e
        self.file = file
        self.comm = sanitize_comm(comm)
        self.device = devices.sanitize_device(device)
        self.names = [dataset_names] if isinstance(dataset_names, str) else list(dataset_names)
        self.load_size = max(int(load_length or initial_load), 1)
        self.transforms = transforms
        with h5py.File(file, "r") as f:
            self.length = f[self.names[0]].shape[0]
            self.shapes = {n: f[n].shape for n in self.names}

    def __len__(self) -> int:
        return self.length

    def _rows(self, lo: int, hi: int):
        """This rank's rows [a, b) of the block [lo, hi)."""
        off, lshape, _ = self.comm.chunk((hi - lo,), 0)
        return lo + off, lo + off + lshape[0]

    def _reader(self, q: "queue.Queue", stop: "threading.Event"):
        import h5py

        try:
            with h5py.File(self.file, "r") as f:
                for lo in range(0, self.length, self.load_size):
                    if stop.is_set():
                        return
                    hi = min(lo + self.load_size, self.length)
                    a, b = self._rows(lo, hi)
                    block = (hi - lo, {n: np.asarray(f[n][a:b]) for n in self.names})
                    while not stop.is_set():
                        try:
                            q.put(block, timeout=0.1)
                            break
                        except queue.Full:
                            continue
        finally:
            while True:
                try:
                    q.put(None, timeout=0.1)
                    return
                except queue.Full:
                    if stop.is_set():
                        return

    def __iter__(self):
        """Yield a DNDarray split 0 a block (a dict of them for several
        names); leaving the loop early stops the reader thread."""
        q: "queue.Queue" = queue.Queue(maxsize=2)
        stop = threading.Event()
        t = threading.Thread(target=self._reader, args=(q, stop), daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                rows, block = item
                out = {}
                for n, arr in block.items():
                    if self.transforms is not None:
                        arr = self.transforms(arr)
                    local = torch.from_numpy(np.ascontiguousarray(arr)).to(self.device.torch_device)
                    dt = types.canonical_heat_type(local.dtype)
                    out[n] = DNDarray(local, (rows,) + tuple(local.shape[1:]), dt, 0, self.device, self.comm, True)
                yield out if len(out) > 1 else next(iter(out.values()))
        finally:
            stop.set()
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            t.join(timeout=2.0)


PartialH5DataLoaderIter = PartialH5Dataset
