"""Device handles (reference: ``heat/core/devices.py``).

A :class:`Device` names a platform, ``cpu`` or ``gpu``.  Every process owns
one card: ``gpu`` maps this process to ``cuda:<local_rank>``.  The default
device is ``gpu``.  Where CUDA is absent, resolving it raises: nothing falls
back to the CPU unless the caller asks for ``cpu`` (``use_device("cpu")`` or
``device="cpu"``).
"""

from __future__ import annotations

import os
from typing import Union

import torch

__all__ = ["Device", "cpu", "gpu", "get_device", "sanitize_device", "use_device"]


class Device:
    """Handle for one platform: ``'cpu'`` or ``'gpu'``."""

    def __init__(self, device_type: str):
        if device_type not in ("cpu", "gpu"):
            raise ValueError(f"Unknown device, must be 'cpu' or 'gpu', got {device_type!r}")
        self.__device_type = device_type

    @property
    def device_type(self) -> str:
        return self.__device_type

    @property
    def device_id(self) -> int:
        return local_rank() if self.__device_type == "gpu" else 0

    @property
    def torch_device(self) -> torch.device:
        """The torch device this process uses (raises for ``gpu`` without CUDA)."""
        if self.__device_type == "cpu":
            return torch.device("cpu")
        if not torch.cuda.is_available():
            raise RuntimeError(
                "heat_tpu_torch: the default device is 'gpu' but CUDA is not available; "
                "pass device='cpu' or call heat_tpu_torch.use_device('cpu') to run on the CPU"
            )
        return torch.device("cuda", self.device_id)

    def __eq__(self, other) -> bool:
        if isinstance(other, Device):
            return self.__device_type == other.device_type
        if isinstance(other, str):
            return self.__device_type == _canonical_name(other)
        return NotImplemented

    def __hash__(self) -> int:
        return hash(self.__device_type)

    def __repr__(self) -> str:
        return f"device({self.__str__()!r})"

    def __str__(self) -> str:
        return f"{self.__device_type}:{self.device_id}"


def local_rank() -> int:
    """This process's card index on its host: ``LOCAL_RANK`` if set, else the
    global rank modulo the visible card count."""
    env = os.environ.get("LOCAL_RANK")
    if env is not None:
        return int(env)
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        count = torch.cuda.device_count() if torch.cuda.is_available() else 1
        return torch.distributed.get_rank() % max(count, 1)
    return 0


def _canonical_name(name: str) -> str:
    name = name.lower()
    return "gpu" if name == "cuda" or name.startswith("cuda:") else name


cpu = Device("cpu")
gpu = Device("gpu")
_DEVICES = {"cpu": cpu, "gpu": gpu}

__default_device: Device = gpu


def get_device() -> Device:
    """The current default :class:`Device` (``gpu`` unless changed)."""
    return __default_device


def use_device(device: Union[str, Device, None] = None) -> None:
    """Set the default device, cf. ``ht.use_device('gpu')`` in the reference."""
    global __default_device
    if device is None:
        return
    __default_device = sanitize_device(device)


def sanitize_device(device: Union[str, Device, torch.device, None]) -> Device:
    """Resolve ``device`` to a :class:`Device` (the default device for ``None``)."""
    if device is None:
        return get_device()
    if isinstance(device, Device):
        return device
    if isinstance(device, torch.device):
        device = device.type
    if isinstance(device, str):
        name = _canonical_name(device)
        if name in _DEVICES:
            return _DEVICES[name]
    raise ValueError(f"Unknown device, must be 'cpu' or 'gpu', got {device!r}")
