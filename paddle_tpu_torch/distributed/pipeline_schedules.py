"""Hand-scheduled pipeline parallelism: 1F1B, interleaved (VPP) and
zero bubble (ZB-H1), over point-to-point messages between processes.

Ports ``paddle_tpu/distributed/pipeline_schedules.py``
(``schedule_grid``, ``stack_stage_params``, ``pipeline_1f1b``).  The
reference runs one SPMD program: a scan over ticks inside a
``shard_map`` manual over ``pp``, every device running a (masked)
forward and backward unit each tick, activations and cotangents moving
by ``ppermute``.  Here every stage is a process that runs only the
units it has, and the messages go by ``batch_isend_irecv`` at the end of
each tick.  The unit placement is the reference's, formula for formula
(S stages, v chunks per device, m microbatches, device s; microbatch
j = g·S + r):

  forward of chunk c, microbatch j   at  t = g·v·S + c·S + r + s
  backward of chunk c, microbatch j  at  t = g·v·S + (v-1-c)·S + r
                                             + 2·(S-1) - s + (v-1)·S

so the last virtual stage runs a microbatch's loss head and its
backward in the tick of its forward.  Device s owns virtual stages
{c·S + s}: the activation leaving device S-1 in chunk c enters device 0
in chunk c + 1.  Zero bubble splits a backward into B (the gradient of
the stage input, ``torch.autograd.grad`` with ``retain_graph=True``) and
W (the weight gradients): the W units of device s's last s microbatches
of chunk 0 move to the tail ticks T - (m - j), which that device would
otherwise spend idle, exactly as ``schedule_grid`` places them.

The reference's backward tick re-runs the stage forward (``jax.vjp``
from a ring of stage inputs); here the forward's autograd graph is kept
from the forward tick to the backward tick instead, so a stage's forward
runs once.  The graphs in flight are the reference's ring: at most
2·v·S per device, whatever m (:data:`last_stats` records the most).
Gradients accumulate in float32 and come back in the parameters' dtype,
as the reference's do; the loss and the first and last stages'
gradients are summed over the pipeline group, as the reference psums
them.
"""
from __future__ import annotations

from typing import Callable

import torch

from . import collective as C

__all__ = ["last_stats", "pipeline_1f1b", "schedule_grid",
           "stack_stage_params"]

# the most forward graphs one device held at once in the last run, and
# the run's ticks (the 1F1B memory property's witness)
last_stats = {"max_in_flight": 0, "ticks": 0}


def schedule_grid(S, m, zero_bubble=False):
    """Pure-Python model of the fused-tick schedule: grid[s][t] is the
    set of unit types device s runs at tick t ('F', 'B' = dx, 'W' = dW).

    1F1B fuses W with B; zero-bubble (ZB-H1) defers each device's LAST s
    microbatches' W units into its tail idle window [T-s, T) — exactly
    the drain ticks that device would otherwise spend idle — so the
    grid has strictly fewer idle (device, tick) slots.  The executable
    engine shares this placement."""
    T = m + 2 * (S - 1)
    grid = [[set() for _ in range(T)] for _ in range(S)]
    for s in range(S):
        for j in range(m):
            grid[s][j + s].add("F")
            tb = j + 2 * (S - 1) - s
            grid[s][tb].add("B")
            if zero_bubble and j >= m - s:
                grid[s][T - (m - j)].add("W")     # deferred into tail idle
            else:
                grid[s][tb].add("W")              # fused with B
    return grid


def stack_stage_params(layer_params_list, n_stages, n_virtual=1):
    """Split L per-layer params into the stages' chunks: out[s][c] is the
    list of layers of virtual stage c·S + s (reference interleaved
    assignment, ``pipeline_parallel.py:1174``).  The reference stacks
    them into [S, v, lps, ...] leaves; the port keeps one entry per
    layer."""
    L = len(layer_params_list)
    sv = n_stages * n_virtual
    if L % sv:
        raise ValueError(f"{L} layers do not split into {n_stages} stages "
                         f"x {n_virtual} chunks")
    lps = L // sv
    return [[list(layer_params_list[(c * n_stages + s) * lps:
                                    (c * n_stages + s + 1) * lps])
             for c in range(n_virtual)] for s in range(n_stages)]


def placement(S, m, n_virtual=1, schedule="1f1b"):
    """(T, units): units[s][t] is the list of (kind, chunk, microbatch)
    device s runs at tick t, kinds "F", "B" (with W fused) and, for the
    zero-bubble schedule, "Bx" (the input gradient only) and "W".
    ``schedule``: "gpipe" (every forward, then every backward in reverse
    order), "1f1b" or "zb"."""
    v = int(n_virtual)
    if schedule == "gpipe":
        if v != 1:
            raise ValueError("the gpipe schedule has no virtual stages")
        T = 2 * (m + S - 1)
        units = [[[] for _ in range(T)] for _ in range(S)]
        for s in range(S):
            for j in range(m):
                units[s][j + s].append(("F", 0, j))
                units[s][(m + S - 1) + (m - 1 - j) + (S - 1 - s)].append(
                    ("B", 0, j))
        return T, units
    if schedule not in ("1f1b", "zb"):
        raise ValueError(f"unknown pipeline schedule {schedule!r}")
    if v > 1 and m % S:
        raise ValueError(f"interleaved schedule needs n_micro % pp == 0, "
                         f"got {m} % {S}")
    if schedule == "zb" and m < S:
        raise ValueError(f"zero_bubble needs n_micro >= pp, got {m} < {S}")
    vS = v * S
    T = m * v + 2 * (S - 1) + (v - 1) * S
    units = [[[] for _ in range(T)] for _ in range(S)]
    for s in range(S):
        for c in range(v):
            for j in range(m):
                g, r = divmod(j, S)
                units[s][g * vS + c * S + r + s].append(("F", c, j))
                tb = (g * vS + (v - 1 - c) * S + r + 2 * (S - 1) - s
                      + (v - 1) * S)
                if schedule == "zb" and c == 0 and j >= m - s:
                    units[s][tb].append(("Bx", c, j))
                    units[s][T - (m - j)].append(("W", c, j))
                else:
                    units[s][tb].append(("B", c, j))
    order = {"F": 0, "B": 1, "Bx": 1, "W": 2}
    for row in units:
        for tick in row:
            tick.sort(key=lambda u: order[u[0]])
    return T, units


def _leaves(tree) -> list:
    """The tensors of a nested dict/list/tuple, in a fixed order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    raise TypeError(f"not a tree of tensors: {type(tree)}")


def _like(tree, leaves):
    """``leaves`` (in :func:`_leaves` order) arranged as ``tree``."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, torch.Tensor):
            return next(it)
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return type(t)(build(x) for x in t)
    return build(tree)


def _messages(S, v, s, units_t):
    """What device s sends at a tick with units ``units_t``: (kind, peer
    stage, chunk the peer runs it in, microbatch) per message, "f" for an
    activation to the next stage, "b" for a cotangent to the one
    before."""
    out = []
    for kind, c, j in units_t:
        if kind == "F" and not (s == S - 1 and c == v - 1):
            out.append(("f", (s + 1) % S, c + (s == S - 1), j))
        elif kind in ("B", "Bx") and not (s == 0 and c == 0):
            out.append(("b", (s - 1) % S, c - (s == 0), j))
    return sorted(out, key=lambda msg: msg[0] != "f")


def pipeline_1f1b(stage_fn: Callable, first_fn: Callable, last_fn: Callable,
                  stage_params, first_params, last_params, aux, group,
                  act_shape, act_dtype, n_virtual: int = 1,
                  zero_bubble: bool = False, schedule: str | None = None):
    """One pipelined forward+backward pass on this stage.  Returns
    ``(loss_sum, d_stage, d_first, d_last)``.

    stage_fn(chunk_params, x) -> x'     homogeneous trunk chunk
    first_fn(first_params, aux_j) -> x  stage-0 input (e.g. embedding)
    last_fn(last_params, y, aux_j) -> scalar loss for one microbatch
    stage_params: this device's v chunks (``stack_stage_params(...)[s]``),
        trees of tensors that require grad; first/last_params likewise.
    aux: the m microbatches' inputs (a list).
    group: the pipeline :class:`~.collective.Group`; this process is
        stage ``group.rank``, its neighbours the ranks beside it.
    act_shape, act_dtype: the activation that moves between stages.
    schedule: "1f1b" (default; "zb" with ``zero_bubble``) or "gpipe".

    Losses are summed over microbatches (bake any 1/tokens scale into
    last_fn); the loss and d_first/d_last are summed over the group, so
    every stage returns them whole."""
    S, s = group.nranks, group.rank
    v = int(n_virtual)
    m = len(aux)
    schedule = schedule or ("zb" if zero_bubble else "1f1b")
    T, units = placement(S, m, v, schedule)
    params0 = _leaves(stage_params[0])
    dev = params0[0].device
    chunk_leaves = [_leaves(cp) for cp in stage_params]
    first_leaves, last_leaves = _leaves(first_params), _leaves(last_params)
    d_stage = [[torch.zeros(p.shape, dtype=torch.float32, device=dev)
                for p in leaves] for leaves in chunk_leaves]
    d_first = [torch.zeros(p.shape, dtype=torch.float32, device=dev)
               for p in first_leaves]
    d_last = [torch.zeros(p.shape, dtype=torch.float32, device=dev)
              for p in last_leaves]
    loss = torch.zeros((), dtype=torch.float32, device=dev)
    inbox, live, dy_tail, stash = {}, {}, {}, {}
    peak = 0

    def acc(dst, grads):
        for a, g in zip(dst, grads):
            if g is not None:
                a.add_(g.float())

    for t in range(T):
        sends = []
        for kind, c, j in units[s][t]:
            if kind == "F":
                x_first = None
                if s == 0 and c == 0:
                    x_first = first_fn(first_params, aux[j])
                    x = x_first.detach().requires_grad_()
                else:
                    x = inbox.pop(("f", c, j)).requires_grad_()
                y = stage_fn(stage_params[c], x)
                live[(c, j)] = (x, y, x_first)
                peak = max(peak, len(live))
                if s == S - 1 and c == v - 1:
                    loss_j = last_fn(last_params, y, aux[j])
                    grads = torch.autograd.grad(loss_j, [y] + last_leaves)
                    dy_tail[(c, j)] = grads[0]
                    acc(d_last, grads[1:])
                    loss += loss_j.detach().float()
                else:
                    sends.append(y.detach())
            elif kind in ("B", "Bx"):
                dy = dy_tail.pop((c, j)) if (s == S - 1 and c == v - 1) \
                    else inbox.pop(("b", c, j))
                x, y, x_first = live.pop((c, j))
                if kind == "B":
                    grads = torch.autograd.grad(
                        y, [x] + chunk_leaves[c], dy, allow_unused=True)
                    dx = grads[0]
                    acc(d_stage[c], grads[1:])
                else:
                    dx, = torch.autograd.grad(y, [x], dy, retain_graph=True)
                    stash[(c, j)] = (y, dy)
                if x_first is not None:
                    acc(d_first, torch.autograd.grad(
                        x_first, first_leaves, dx, allow_unused=True))
                else:
                    sends.append(dx)
            else:                                   # "W"
                y, dy = stash.pop((c, j))
                acc(d_stage[c], torch.autograd.grad(
                    y, chunk_leaves[c], dy, allow_unused=True))
        _exchange(S, v, s, t, units, sends, inbox, group, act_shape,
                  act_dtype, dev)
    if live or inbox or stash or dy_tail:
        raise RuntimeError("pipeline schedule left units unfinished")
    last_stats.update(max_in_flight=peak, ticks=T)
    C.all_reduce(loss, group=group)
    for g in d_first + d_last:
        C.all_reduce(g, group=group)

    def cast(grads, leaves):
        return [g.to(p.dtype) for g, p in zip(grads, leaves)]
    return (loss,
            [_like(cp, cast(g, leaves)) for cp, g, leaves
             in zip(stage_params, d_stage, chunk_leaves)],
            _like(first_params, cast(d_first, first_leaves)),
            _like(last_params, cast(d_last, last_leaves)))


def _exchange(S, v, s, t, units, sends, inbox, group, act_shape, act_dtype,
              dev):
    """The tick's messages: this device's, in :func:`_messages` order,
    and its neighbours' to it, into ``inbox``.  Both sides of a pair list
    activations before cotangents, so NCCL matches them in order; gloo
    matches them by tag as well."""
    if S == 1:
        return
    mine = _messages(S, v, s, units[s][t])
    ops, recvs = [], []
    for (kind, peer, _, _), tensor in zip(mine, sends):
        ops.append(C.P2POp(C.isend, tensor.contiguous(),
                           group.ranks[peer], group, tag=int(kind == "b")))
    for src in sorted({(s - 1) % S, (s + 1) % S}):
        for kind, peer, c, j in _messages(S, v, src, units[src][t]):
            if peer != s:
                continue
            buf = torch.empty(act_shape, dtype=act_dtype, device=dev)
            ops.append(C.P2POp(C.irecv, buf, group.ranks[src], group,
                               tag=int(kind == "b")))
            recvs.append(((kind, c, j), buf))
    for req in C.batch_isend_irecv(ops):
        req.wait()
    for key, buf in recvs:
        inbox[key] = buf
