"""Device selection for the Paddle API (the reference's
``paddle_tpu/device/__init__.py``: ``set_device``, ``get_device`` and the
place classes).

New tensors go to the current device: CUDA unless ``set_device("cpu")``
(or an explicit ``place``) asks for the CPU.  With no card, the default
raises (``resolve_device``) instead of falling back to the CPU.
"""
from __future__ import annotations

import torch

from .. import resolve_device

__all__ = ["set_device", "get_device", "CPUPlace", "CUDAPlace",
           "current_device", "to_torch_device"]

_current = None          # None: CUDA, resolved at each use


class _Place:
    def __init__(self, device_id=0):
        self.device_id = int(device_id)

    def __repr__(self):
        return f"{type(self).__name__}({self.device_id})"

    def __eq__(self, other):
        return type(self) is type(other) and self.device_id == other.device_id

    def __hash__(self):
        return hash((type(self).__name__, self.device_id))


class CPUPlace(_Place):
    def __init__(self):
        super().__init__(0)

    def __repr__(self):
        return "Place(cpu)"


class CUDAPlace(_Place):
    pass


def to_torch_device(place) -> torch.device:
    """A place (``"cpu"``, ``"gpu:0"``, ``"cuda"``, a place object or a
    torch device; None is the current device) as a torch device, checked
    by ``resolve_device``."""
    if place is None:
        return current_device()
    if isinstance(place, CPUPlace):
        return torch.device("cpu")
    if isinstance(place, CUDAPlace):
        return resolve_device(torch.device("cuda", place.device_id))
    if isinstance(place, str):
        name, _, idx = place.partition(":")
        if name == "cpu":
            return torch.device("cpu")
        if name not in ("gpu", "cuda"):
            raise ValueError(f"unknown device {place!r}: expected 'cpu', "
                             "'gpu' or 'gpu:N'")
        place = torch.device("cuda", int(idx or 0))
    return resolve_device(place)


def set_device(device):
    """paddle.set_device: ``"cpu"`` or ``"gpu"``/``"gpu:N"`` (``"cuda"``
    too).  Raises for a card that is not there."""
    global _current
    _current = to_torch_device(device)
    return _current


def get_device() -> str:
    """``"cpu"`` or ``"gpu:N"``, the reference's spelling."""
    if _current is None:
        return "gpu:0"
    return "cpu" if _current.type == "cpu" else f"gpu:{_current.index or 0}"


def current_device() -> torch.device:
    """The device new tensors go to (raises where that is CUDA and no
    card is present)."""
    return resolve_device(_current)
