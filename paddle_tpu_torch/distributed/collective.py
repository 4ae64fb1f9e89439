"""Collective communication API over ``torch.distributed``.

Ports ``paddle_tpu/distributed/collective.py``: the same names and
signatures, the same ``collective_calls_total`` / ``collective_bytes_total``
counters (labelled by op) and a ``collective:<op>`` span around each
call.  The reference runs one controller over a device mesh, so an eager
collective there is a small ``shard_map`` program over the mesh axes of
the group; here every rank is a process and a collective is the
``torch.distributed`` call of this rank.  A :class:`Group` is a list of
global ranks with its process group; mesh axes name the groups of a
:class:`~.mesh.ProcessMesh` (``mesh.group("tp")``).

Where the two count differently, by construction: the reference's eager
payload is the whole array, every device's shard included, and here each
rank counts the bytes of its own input, so the bytes summed over the
group's ranks equal the reference's for the same call; the calls count
one per rank, as the reference's count one per call.

A group of one rank is the identity and counts nothing, as in the
reference.  ``send``/``recv`` and :func:`batch_isend_irecv` carry the
pipeline's activations between stages (the reference's ``ppermute``
inside its pipelined ``shard_map``).  NCCL serves CUDA tensors and gloo
CPU tensors; a CUDA tensor on a gloo group raises.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from .. import observability as _obs

__all__ = ["Group", "P2POp", "ReduceOp", "all_gather", "all_gather_object",
           "all_reduce", "all_to_all", "alltoall", "barrier",
           "batch_isend_irecv", "broadcast", "get_group",
           "get_world_size_group", "irecv", "isend", "new_group", "recv",
           "reduce", "reduce_scatter", "scatter", "send", "split", "wait"]


class ReduceOp:
    SUM = "sum"
    MAX = "max"
    MIN = "min"
    PROD = "prod"
    AVG = "avg"


_TORCH_OPS = {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.MAX: dist.ReduceOp.MAX,
              ReduceOp.MIN: dist.ReduceOp.MIN,
              ReduceOp.PROD: dist.ReduceOp.PRODUCT,
              ReduceOp.AVG: dist.ReduceOp.SUM}    # then divided by nranks
# torch 2.13 renames the single-tensor forms; 2.11 has only the old names
_ALL_GATHER = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


class Group:
    """A communicator: an ordered list of global ranks and the process
    group that joins them (None for the world and for a single rank).
    ``axis_names`` are the mesh axes it spans, where a mesh made it."""

    def __init__(self, ranks, pg=None, axis_names=(), gid=0):
        self.ranks = [int(r) for r in ranks]
        self.pg = pg
        self.axis_names = (axis_names,) if isinstance(axis_names, str) \
            else tuple(axis_names)
        self.id = gid

    @property
    def nranks(self):
        return len(self.ranks)

    @property
    def world_size(self):
        return self.nranks

    @property
    def rank(self):
        """This process's index in the group (-1 outside it)."""
        return self.get_group_rank(dist.get_rank() if dist.is_initialized()
                                   else 0)

    @property
    def process_ids(self):
        return list(self.ranks)

    def get_group_rank(self, rank):
        return self.ranks.index(rank) if rank in self.ranks else -1

    def __repr__(self):
        return (f"Group(ranks={self.ranks}, axes={self.axis_names}, "
                f"nranks={self.nranks})")


_groups: dict[int, Group] = {}
_next_gid = [1]


def _get_or_create_default_group() -> Group:
    world = dist.get_world_size() if dist.is_initialized() else 1
    g = _groups.get(0)
    if g is None or g.nranks != world:
        g = _groups[0] = Group(range(world), gid=0)
    return g


def _register(ranks, pg, axis_names) -> Group:
    gid = _next_gid[0]
    _next_gid[0] += 1
    g = _groups[gid] = Group(ranks, pg, axis_names, gid)
    return g


def new_group(ranks=None, backend=None, timeout=None, axis_names=None):
    """reference ``collective.py:194``.  ``axis_names``: the group of this
    rank along those axes of the current mesh (built with the mesh).
    ``ranks``: a process group over those global ranks, which every
    process must create together, in the same order, as
    ``torch.distributed.new_group`` requires."""
    if axis_names is not None:
        from .mesh import get_mesh
        mesh = get_mesh()
        if mesh is None:
            raise RuntimeError("new_group(axis_names=...) needs a mesh "
                               "(set_mesh / auto_mesh)")
        return mesh.group(axis_names)
    world = dist.get_world_size() if dist.is_initialized() else 1
    ranks = list(range(world)) if ranks is None else sorted(ranks)
    pg = None
    if len(ranks) > 1 and ranks != list(range(world)):
        kw = {} if timeout is None else {"timeout": timeout}
        pg = dist.new_group(ranks, backend=backend, **kw)
    return _register(ranks, pg, ())


def get_group(gid=0):
    return _groups.get(gid) or _get_or_create_default_group()


def _group(group) -> Group:
    return _get_or_create_default_group() if group is None else group


def get_world_size_group(group=None):
    return _group(group).nranks


# telemetry (reference :146-175): call and payload-byte counters per
# collective kind, and a span so that traces show where collective time
# goes
_M_COLL_CALLS = _obs.counter(
    "collective_calls_total", "eager collective invocations", ("op",))
_M_COLL_BYTES = _obs.counter(
    "collective_bytes_total", "payload bytes entering eager collectives",
    ("op",))


class _collective_span:
    """Span + counters around one collective."""

    def __init__(self, name, tensor=None):
        _M_COLL_CALLS.labels(name).inc()
        if tensor is not None and tensor.numel():
            _M_COLL_BYTES.labels(name).inc(tensor.numel()
                                           * tensor.element_size())
        self._ev = torch.profiler.record_function(f"collective:{name}")

    def __enter__(self):
        self._ev.__enter__()
        return self

    def __exit__(self, *exc):
        self._ev.__exit__(*exc)
        return False


def _check(tensor, g: Group):
    """A CUDA tensor needs NCCL and a CPU tensor gloo: nothing crosses."""
    backend = dist.get_backend(g.pg)
    if (tensor.device.type == "cuda") != (backend == "nccl"):
        raise RuntimeError(f"a {tensor.device.type} tensor on a {backend} "
                           "group: NCCL serves CUDA tensors, gloo CPU ones")


def all_reduce(tensor, op=ReduceOp.SUM, group=None, sync_op=True):
    """In-place all-reduce over the group; returns ``tensor``."""
    g = _group(group)
    if g.nranks == 1:
        return tensor
    if op not in _TORCH_OPS:
        raise ValueError(f"unsupported reduce op: {op!r}")
    _check(tensor, g)
    with _collective_span("all_reduce", tensor):
        dist.all_reduce(tensor, _TORCH_OPS[op], group=g.pg)
    if op == ReduceOp.AVG:
        tensor.div_(g.nranks)
    return tensor


def _gathered(tensor, g: Group, axis):
    """Every rank's ``tensor`` concatenated along ``axis``, in rank order."""
    x = tensor.movedim(axis, 0).contiguous()
    out = torch.empty((g.nranks * x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    _ALL_GATHER(out, x, group=g.pg)
    return out.movedim(0, axis)


def all_gather(tensor_list, tensor, group=None, sync_op=True, axis=0):
    """Gather every rank's ``tensor``: appended to ``tensor_list`` one
    piece per rank, or (``tensor_list`` None) returned concatenated along
    ``axis``."""
    g = _group(group)
    if g.nranks == 1:
        if tensor_list is not None:
            tensor_list.append(tensor)
            return tensor_list
        return tensor
    _check(tensor, g)
    with _collective_span("all_gather", tensor):
        out = _gathered(tensor, g, axis)
    if tensor_list is not None:
        tensor_list.extend(out.chunk(g.nranks, dim=axis))
        return tensor_list
    return out


def reduce_scatter(tensor, tensor_or_tensor_list, op=ReduceOp.SUM,
                   group=None, sync_op=True, axis=0):
    """Reduce over the group, then keep this rank's 1/nranks along
    ``axis``: written into ``tensor`` (which may be None) and returned."""
    g = _group(group)
    src = tensor_or_tensor_list
    if isinstance(src, (list, tuple)):
        src = torch.cat(list(src), dim=axis)
    if g.nranks == 1:
        if tensor is None:
            return src
        tensor.copy_(src)
        return tensor
    if op not in (ReduceOp.SUM, ReduceOp.AVG):
        raise ValueError(f"unsupported reduce_scatter op: {op!r}")
    if src.shape[axis] % g.nranks:
        raise ValueError(f"reduce_scatter: dim {axis} of {tuple(src.shape)} "
                         f"does not split over {g.nranks} ranks")
    _check(src, g)
    x = src.movedim(axis, 0).contiguous()
    out = torch.empty((x.shape[0] // g.nranks,) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    with _collective_span("reduce_scatter", src):
        _REDUCE_SCATTER(out, x, group=g.pg)
    if op == ReduceOp.AVG:
        out.div_(g.nranks)
    out = out.movedim(0, axis)
    if tensor is None:
        return out
    tensor.copy_(out)
    return tensor


def all_to_all(out_tensor_list, in_tensor_list, group=None, sync_op=True):
    """reference ``dist.alltoall``: send the i-th tensor of
    ``in_tensor_list`` to rank i of the group; ``out_tensor_list`` gets
    what each rank sent this one, in rank order."""
    g = _group(group)
    ins = list(in_tensor_list)
    if g.nranks == 1:
        out_tensor_list.extend(ins)
        return out_tensor_list
    _check(ins[0], g)
    outs = [torch.empty_like(t) for t in ins]
    with _collective_span("all_to_all", torch.cat([t.reshape(-1)
                                                   for t in ins])):
        dist.all_to_all(outs, [t.contiguous() for t in ins], group=g.pg)
    out_tensor_list.extend(outs)
    return out_tensor_list


alltoall = all_to_all


def broadcast(tensor, src=0, group=None, sync_op=True):
    """In place: every rank gets global rank ``src``'s ``tensor``."""
    g = _group(group)
    if g.nranks == 1:
        return tensor
    _check(tensor, g)
    with _collective_span("broadcast", tensor):
        dist.broadcast(tensor, src, group=g.pg)
    return tensor


def reduce(tensor, dst=0, op=ReduceOp.SUM, group=None, sync_op=True):
    """Reduce onto global rank ``dst`` (in place there)."""
    g = _group(group)
    if g.nranks == 1:
        return tensor
    _check(tensor, g)
    with _collective_span("reduce", tensor):
        dist.reduce(tensor, dst, _TORCH_OPS[op], group=g.pg)
    if op == ReduceOp.AVG and dist.get_rank() == dst:
        tensor.div_(g.nranks)
    return tensor


def scatter(tensor, tensor_list=None, src=0, group=None, sync_op=True):
    """Rank i of the group gets ``tensor_list[i]`` of global rank ``src``
    (written into ``tensor``)."""
    g = _group(group)
    if g.nranks == 1:
        if tensor_list:
            tensor.copy_(tensor_list[0])
        return tensor
    _check(tensor, g)
    mine = dist.get_rank() == src
    with _collective_span("scatter", tensor):
        dist.scatter(tensor, list(tensor_list) if mine else None, src=src,
                     group=g.pg)
    return tensor


def barrier(group=None):
    g = _group(group)
    with _collective_span("barrier"):
        if g.nranks > 1:
            dist.barrier(group=g.pg)


def send(tensor, dst=0, group=None, sync_op=True):
    """Send ``tensor`` to global rank ``dst``."""
    g = _group(group)
    _check(tensor, g)
    with _collective_span("send", tensor):
        dist.send(tensor, dst, group=g.pg)


def recv(tensor, src=0, group=None, sync_op=True):
    """Receive into ``tensor`` from global rank ``src``."""
    g = _group(group)
    _check(tensor, g)
    with _collective_span("recv", tensor):
        dist.recv(tensor, src, group=g.pg)
    return tensor


def isend(tensor, dst=0, group=None):
    g = _group(group)
    _check(tensor, g)
    with _collective_span("isend", tensor):
        return dist.isend(tensor, dst, group=g.pg)


def irecv(tensor, src=0, group=None):
    g = _group(group)
    _check(tensor, g)
    with _collective_span("irecv", tensor):
        return dist.irecv(tensor, src, group=g.pg)


class P2POp:
    """One send or receive of a :func:`batch_isend_irecv` batch: ``op``
    is :func:`isend` or :func:`irecv`, ``peer`` a global rank."""

    def __init__(self, op, tensor, peer, group=None, tag=0):
        if op not in (isend, irecv):
            raise ValueError("P2POp takes isend or irecv")
        self.op, self.tensor, self.peer, self.tag = op, tensor, peer, tag
        self.group = _group(group)


def batch_isend_irecv(p2p_op_list):
    """Start every send and receive of the list together (NCCL groups
    them into one launch); returns the requests to ``wait()`` on.  Both
    sides must list the messages between a pair of ranks in the same
    order."""
    if not p2p_op_list:
        return []
    ops = []
    for p in p2p_op_list:
        _check(p.tensor, p.group)
        name = "isend" if p.op is isend else "irecv"
        _M_COLL_CALLS.labels(name).inc()
        _M_COLL_BYTES.labels(name).inc(p.tensor.numel()
                                       * p.tensor.element_size())
        ops.append(dist.P2POp(dist.isend if p.op is isend else dist.irecv,
                              p.tensor, p.peer, group=p.group.pg, tag=p.tag))
    with torch.profiler.record_function("collective:batch_isend_irecv"):
        return dist.batch_isend_irecv(ops)


def split(x, num_or_sections, axis=0, group=None):
    """Paddle's split: ``num_or_sections`` an int (that many equal parts)
    or a list of sizes."""
    if isinstance(num_or_sections, int):
        return list(torch.chunk(x, num_or_sections, dim=axis))
    return list(torch.split(x, list(num_or_sections), dim=axis))


def wait(tensor, group=None, use_calc_stream=True):
    """Wait for the work queued on ``tensor``'s device."""
    if tensor.device.type == "cuda":
        torch.cuda.current_stream(tensor.device).synchronize()
    return tensor


def all_gather_object(object_list, obj, group=None):
    g = _group(group)
    if g.nranks == 1:
        object_list.append(obj)
        return object_list
    out = [None] * g.nranks
    with _collective_span("all_gather_object"):
        dist.all_gather_object(out, obj, group=g.pg)
    object_list.extend(out)
    return object_list
