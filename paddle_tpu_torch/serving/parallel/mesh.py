"""Serving-mesh parsing and validation.

Ports ``paddle_tpu/serving/parallel/mesh.py``.  One axis (``tp``) is
enough for the serving runner: attention heads and the FFN hidden
dimension shard along it, everything per-token stays replicated.
``parse_mesh`` accepts every spelling the CLI and ``create_engine`` take
(``4``, ``"4"``, ``"tp=4"``, ``(4,)``), so the flag, the server argument
and the Python API agree on one parser.

The reference places its mesh on JAX devices; the port runs one process
per card (``serving/parallel/worker.py``), and :func:`mesh_devices`
names the device of each rank: ``cuda:0 … cuda:N-1``, or N CPU ranks
when the caller asks for ``device="cpu"``.
"""
from __future__ import annotations

import torch

__all__ = ["parse_mesh", "validate_tp", "mesh_devices", "TP_AXIS"]

TP_AXIS = "tp"


def parse_mesh(mesh) -> int:
    """Normalize a mesh knob to the tp size.

    Accepted: ``None`` (-> 1), an int, ``"4"``, ``"tp=4"``, and a
    1-tuple/list ``(4,)``.
    """
    if mesh is None:
        return 1
    if isinstance(mesh, (tuple, list)):
        if len(mesh) != 1:
            raise ValueError(
                f"serving mesh has a single tp axis; got shape {mesh!r}")
        mesh = mesh[0]
    if isinstance(mesh, str):
        s = mesh.strip().lower()
        if s.startswith("tp="):
            s = s[3:]
        try:
            mesh = int(s)
        except ValueError:
            raise ValueError(
                f"cannot parse mesh spec {mesh!r}; expected an int, "
                f"'tp=N', or a 1-tuple") from None
    tp = int(mesh)
    if tp < 1:
        raise ValueError(f"mesh tp size must be >= 1, got {tp}")
    return tp


def validate_tp(config, tp: int) -> None:
    """The head-sharded layout's divisibility contract, checked at engine
    construction instead of as a shape error in the first step."""
    if tp == 1:
        return
    for what, n in (("num_attention_heads", config.num_attention_heads),
                    ("num_key_value_heads", config.num_key_value_heads),
                    ("intermediate_size", config.intermediate_size)):
        if n % tp:
            raise ValueError(
                f"tp={tp} must divide {what}={n} (attention heads and "
                "the FFN hidden dim shard along the tp axis)")


def mesh_devices(tp: int, device=None) -> list[torch.device]:
    """The device of each of ``tp`` ranks: ``cuda:0 … cuda:tp-1`` (one
    process per card; ``device=None`` means CUDA), or ``tp`` CPU ranks
    for ``device="cpu"``.  Raises, naming the card count, when the
    machine has fewer cards than ranks."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return [torch.device("cpu")] * tp
    if dev.type != "cuda":
        raise ValueError(f"a serving mesh runs on CUDA cards or, when "
                         f"asked, on the CPU; got device {dev}")
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < tp:
        raise ValueError(
            f"mesh tp={tp} needs {tp} CUDA devices, one per rank, but this "
            f"machine has {n} (device=\"cpu\" runs the ranks on the CPU)")
    return [torch.device("cuda", i) for i in range(tp)]
