"""``paddle.distributed`` of the port (ports ``paddle_tpu/distributed/``).

The process environment (``env``), process meshes (``mesh``), the
collectives (``collective``), the tensor- and sequence-parallel autograd
collectives (``mp_ops``), the pipeline schedules (``pipelining``,
``pipeline_schedules``) and the single-device MoE dispatch (``moe``).
Each rank is one process over ``torch.distributed``: NCCL on CUDA, gloo
on the CPU.
"""
from .collective import (Group, P2POp, ReduceOp, all_gather,  # noqa: F401
                         all_gather_object, all_reduce, all_to_all, alltoall,
                         barrier, batch_isend_irecv, broadcast, get_group,
                         get_world_size_group, irecv, isend, new_group, recv,
                         reduce, reduce_scatter, scatter, send, split, wait)
from .env import (ParallelEnv, get_rank, get_world_size,  # noqa: F401
                  init_parallel_env, is_initialized)
from .mesh import (ProcessMesh, auto_mesh, get_mesh,  # noqa: F401
                   init_device_mesh, set_mesh)
