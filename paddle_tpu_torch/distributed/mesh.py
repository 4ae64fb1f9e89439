"""Process meshes: a grid of ranks with named axes.

Ports ``paddle_tpu/distributed/mesh.py`` (``ProcessMesh``, ``set_mesh``
/ ``get_mesh``, ``auto_mesh``, ``init_device_mesh``).  The reference's
mesh is a ``jax.sharding.Mesh`` over devices; here it is a grid of the
``torch.distributed`` world's ranks, and each axis has one process
group per slice: the ranks that differ only in that axis's coordinate.
:meth:`ProcessMesh.group` gives this rank's slice along one axis or
several.

Process groups are made when the mesh is made, every group of every
axis in one fixed order, because ``torch.distributed.new_group`` is a
call that every process of the world makes together.  They are cached
by the mesh's ranks and axis names, so a second mesh of the same layout
reuses them (a NCCL communicator is expensive).  A mesh made before the
world is initialised (or in a process that takes no part, such as a
test's parent process that converts parameters) has no groups; only its
shape and coordinates work.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch
import torch.distributed as dist

from .collective import Group, _register

__all__ = ["ProcessMesh", "auto_mesh", "get_mesh", "init_device_mesh",
           "set_mesh"]

_global_mesh: "ProcessMesh | None" = None
# (ranks, shape, dim names) -> {axes tuple: this rank's Group}
_GROUP_CACHE: dict = {}


class ProcessMesh:
    """An N-d grid of global ranks (``mesh``) with ``dim_names``."""

    def __init__(self, mesh, dim_names=None, process_ids=None):
        arr = np.asarray(mesh, dtype=np.int64)
        if dim_names is None:
            dim_names = [f"d{i}" for i in range(arr.ndim)]
        if len(dim_names) != arr.ndim:
            raise ValueError(f"{len(dim_names)} names for a {arr.ndim}-d "
                             "mesh")
        if len(set(arr.reshape(-1).tolist())) != arr.size:
            raise ValueError("a rank appears twice in the mesh")
        self._mesh = arr
        self._dim_names = list(dim_names)
        self._groups = self._make_groups() if dist.is_initialized() else None

    # ------------------------------------------------------------ layout
    @property
    def shape(self):
        return list(self._mesh.shape)

    @property
    def ndim(self):
        return self._mesh.ndim

    @property
    def dim_names(self):
        return list(self._dim_names)

    @property
    def process_ids(self):
        return self._mesh.reshape(-1).tolist()

    @property
    def mesh(self):
        return self._mesh.copy()

    def get_dim_size(self, name):
        return int(self._mesh.shape[self._dim_names.index(name)])

    def get_rank_by_dim_and_process_id(self, dim, process_id):
        axis = self._dim_names.index(dim) if isinstance(dim, str) else dim
        coords = np.argwhere(self._mesh == process_id)
        return int(coords[0][axis]) if len(coords) else -1

    def coords(self, rank):
        """{axis name: coordinate} of global ``rank``."""
        where = np.argwhere(self._mesh == rank)
        if not len(where):
            raise ValueError(f"rank {rank} is not in {self}")
        return dict(zip(self._dim_names, (int(c) for c in where[0])))

    # ------------------------------------------------------------ groups
    def _make_groups(self):
        key = (tuple(self.process_ids), self._mesh.shape,
               tuple(self._dim_names))
        if key in _GROUP_CACHE:
            return _GROUP_CACHE[key]
        me = dist.get_rank()
        world = dist.get_world_size()
        nccl = dist.get_backend() == "nccl"
        groups = {}
        # every non-empty set of axes, in one order on every process
        for n in range(1, self.ndim + 1):
            for axes in itertools.combinations(range(self.ndim), n):
                mine = None
                for slice_ranks in self._slices(axes):
                    pg = None
                    if len(slice_ranks) > 1 and \
                            sorted(slice_ranks) != list(range(world)):
                        pg = dist.new_group(slice_ranks)
                    if me in slice_ranks:
                        mine = (slice_ranks, pg)
                if mine is not None:
                    names = tuple(self._dim_names[a] for a in axes)
                    groups[names] = _register(mine[0], mine[1], names)
                    if nccl and mine[1] is not None:
                        # bring the communicator up now, once, rather
                        # than inside the first step's first collective
                        dist.all_reduce(torch.zeros(1, device="cuda"),
                                        group=mine[1])
        _GROUP_CACHE[key] = groups
        return groups

    def _slices(self, axes):
        """The rank lists along ``axes``: one per coordinate of the other
        axes, each in row-major order of ``axes``."""
        rest = [a for a in range(self.ndim) if a not in axes]
        moved = np.transpose(self._mesh, rest + list(axes))
        return [s.reshape(-1).tolist()
                for s in moved.reshape(-1, int(np.prod(
                    [self._mesh.shape[a] for a in axes])))]

    def group(self, axis_names) -> Group:
        """This rank's group along ``axis_names`` (a name or a sequence of
        names, in the mesh's order)."""
        if self._groups is None:
            raise RuntimeError("this mesh was made before "
                               "init_parallel_env(): it has no groups")
        names = (axis_names,) if isinstance(axis_names, str) \
            else tuple(axis_names)
        names = tuple(n for n in self._dim_names if n in names)
        if names not in self._groups:
            raise ValueError(f"this rank is not in {self} or it has no axes "
                             f"{axis_names}")
        return self._groups[names]

    # ------------------------------------------------------------- misc
    def __eq__(self, other):
        return isinstance(other, ProcessMesh) and \
            self._mesh.shape == other._mesh.shape and \
            self._dim_names == other._dim_names and \
            self.process_ids == other.process_ids

    def __hash__(self):
        return hash((self._mesh.shape, tuple(self._dim_names),
                     tuple(self.process_ids)))

    def __repr__(self):
        return f"ProcessMesh(shape={self.shape}, dim_names={self._dim_names})"

    def __enter__(self):
        self._prev = _global_mesh
        set_mesh(self)
        return self

    def __exit__(self, *exc):
        set_mesh(self._prev)
        return False


def set_mesh(mesh):
    global _global_mesh
    _global_mesh = mesh


def get_mesh() -> "ProcessMesh | None":
    return _global_mesh


def auto_mesh(**axis_sizes) -> ProcessMesh:
    """A mesh over the world's ranks, ``auto_mesh(pp=2, dp=2, tp=2)``; one
    size may be -1 (the rest of the world).  It becomes the current
    mesh."""
    names = list(axis_sizes)
    sizes = list(axis_sizes.values())
    world = dist.get_world_size() if dist.is_initialized() else 1
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        sizes[sizes.index(-1)] = world // known
    n = int(np.prod(sizes))
    if n > world:
        raise ValueError(f"a mesh of {n} ranks in a world of {world}")
    m = ProcessMesh(np.arange(n).reshape(sizes), names)
    set_mesh(m)
    return m


def init_device_mesh(device_type=None, mesh_shape=(), mesh_dim_names=None):
    """torch/paddle-shaped mesh constructor."""
    sizes = dict(zip(mesh_dim_names or
                     [f"d{i}" for i in range(len(mesh_shape))], mesh_shape))
    return auto_mesh(**sizes)
