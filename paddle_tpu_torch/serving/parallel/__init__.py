"""The engine's device half: the model runner, and serving tensor
parallelism over one process per card.

The engine (``serving/engine.py``) drives admission and scheduling and
calls a :class:`ModelRunner`, which owns the weights, the paged KV pools
and the decode state on its device.  At ``tp > 1`` the runner is rank 0
of a mesh of processes (``worker.py``): q/k/v, gate and up split their
columns over the ranks, o and down their rows, the pools their kv heads,
and each layer all-reduces twice (after o and after down).  ``tp=1`` is
the single-device runner, with no process and no collective.
"""
from .mesh import mesh_devices, parse_mesh, validate_tp
from .runner import ModelRunner

__all__ = ["ModelRunner", "mesh_devices", "parse_mesh", "validate_tp"]
