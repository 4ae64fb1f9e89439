"""The distributed environment: ranks, world size, process-group init.

Ports ``paddle_tpu/distributed/env.py``.  The reference brings up JAX's
coordination service and runs one SPMD program over a device mesh; the
port runs one process per rank over ``torch.distributed``.  The rank and
the world size come from the launcher's environment: ``RANK`` /
``WORLD_SIZE`` (``torchrun``) or the reference's ``PADDLE_TRAINER_ID`` /
``PADDLE_TRAINERS_NUM``, and the rendezvous from ``MASTER_ADDR`` /
``MASTER_PORT`` (or ``PADDLE_MASTER``), unless the caller passes them.

:func:`init_parallel_env` picks the backend from the device: NCCL on
CUDA (``device=None`` means CUDA, and raises without a card), gloo only
when the caller asks for ``device="cpu"``.  Nothing falls back from one
to the other.
"""
from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from .. import resolve_device

__all__ = ["ParallelEnv", "get_rank", "get_world_size", "init_parallel_env",
           "is_initialized"]

_device: torch.device | None = None     # the device init_parallel_env chose


def _env_int(*names, default=None):
    for name in names:
        if os.environ.get(name) not in (None, ""):
            return int(os.environ[name])
    return default


def get_rank(group=None) -> int:
    """This process's rank: in ``group`` (its index among the group's
    ranks, -1 outside it), else in the world."""
    if group is not None:
        return group.get_group_rank(get_rank())
    if dist.is_initialized():
        return dist.get_rank()
    return _env_int("RANK", "PADDLE_TRAINER_ID", default=0)


def get_world_size(group=None) -> int:
    """Processes in ``group``, else in the world."""
    if group is not None:
        return group.nranks
    if dist.is_initialized():
        return dist.get_world_size()
    return _env_int("WORLD_SIZE", "PADDLE_TRAINERS_NUM", default=1)


def is_initialized() -> bool:
    return dist.is_initialized()


def init_parallel_env(device=None, rank=None, world_size=None,
                      init_method=None, store=None, timeout_s=None):
    """Join the process group (reference ``parallel.py:978``) and return
    the default :class:`~.collective.Group`.

    ``device`` None or "cuda": NCCL, and this process takes card
    ``LOCAL_RANK`` (default: rank modulo the cards it sees); "cpu":
    gloo.  ``rank``/``world_size`` default to the launcher's variables,
    ``init_method`` to ``tcp://MASTER_ADDR:MASTER_PORT`` when those are
    set, else ``env://``; ``store`` (e.g. a ``FileStore``) replaces the
    rendezvous.  A second call returns the same group."""
    global _device
    dev = resolve_device(device)
    if not dist.is_initialized():
        rank = _env_int("RANK", "PADDLE_TRAINER_ID") if rank is None else rank
        world_size = (_env_int("WORLD_SIZE", "PADDLE_TRAINERS_NUM", default=1)
                      if world_size is None else world_size)
        if rank is None:
            if world_size > 1:
                raise RuntimeError(
                    "init_parallel_env: a world of more than one process "
                    "needs each process's rank (RANK or PADDLE_TRAINER_ID, "
                    "or rank=); defaulting every rank to 0 would hang the "
                    "rendezvous")
            rank = 0
        if dev.type == "cuda":
            local = _env_int("LOCAL_RANK",
                             default=rank % torch.cuda.device_count())
            dev = torch.device("cuda", local if dev.index is None
                               else dev.index)
            torch.cuda.set_device(dev)
        if store is None and init_method is None:
            master = os.environ.get("PADDLE_MASTER")
            addr, port = (os.environ.get("MASTER_ADDR"),
                          os.environ.get("MASTER_PORT"))
            if addr and port:
                init_method = f"tcp://{addr}:{port}"
            elif master:
                init_method = f"tcp://{master}"
            else:
                init_method = "env://"
        kw = {} if timeout_s is None else {
            "timeout": datetime.timedelta(seconds=timeout_s)}
        if dev.type == "cuda":
            kw["device_id"] = dev
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method=init_method, store=store,
                                rank=rank, world_size=world_size, **kw)
    elif dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    backend = dist.get_backend()
    if (backend == "nccl") != (dev.type == "cuda"):
        raise RuntimeError(f"the process group runs {backend}, which does "
                           f"not serve {dev.type} tensors")
    _device = dev
    from .collective import _get_or_create_default_group
    return _get_or_create_default_group()


class ParallelEnv:
    """The reference's view of this process (``parallel.py``)."""

    @property
    def rank(self):
        return get_rank()

    @property
    def world_size(self):
        return get_world_size()

    @property
    def device_id(self):
        if _device is None or _device.type != "cuda":
            return 0
        return _device.index or 0

    @property
    def current_endpoint(self):
        return os.environ.get("PADDLE_CURRENT_ENDPOINT", "127.0.0.1:6170")

    @property
    def trainer_endpoints(self):
        eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
        return eps.split(",") if eps else []
