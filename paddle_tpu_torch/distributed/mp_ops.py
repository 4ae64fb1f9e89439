"""Tensor- and sequence-parallel collectives as autograd functions.

The reference leaves these to GSPMD: it states shardings
(``models/llama_hybrid.py:param_shardings``, the ``P("dp", "tp", None)``
constraint of Megatron-SP) and XLA inserts the all-reduces and gathers
that the Paddle reference writes by hand (``fleet/layers/mpu/mp_ops.py``,
``fleet/utils/sequence_parallel_utils.py``).  Here each is a
``torch.autograd.Function`` over a :class:`~.collective.Group`, whose
forward and backward go through :mod:`.collective` (so its counters show
the traffic):

* :func:`copy_to` — identity forward, all-reduce backward (Megatron's
  ``f``: before a column-parallel matmul whose input every rank holds);
* :func:`reduce_from` — all-reduce forward, identity backward (``g``:
  after a row-parallel matmul);
* :func:`gather_from` — all-gather forward, this rank's slice backward
  (a sharded result every rank then uses whole, the gradient of which
  every rank holds whole too);
* :func:`scatter_to` — this rank's slice forward, all-gather backward;
* :func:`sp_gather` — all-gather forward, reduce-scatter backward
  (Megatron-SP, before a column-parallel matmul);
* :func:`sp_scatter` — reduce-scatter forward, all-gather backward
  (Megatron-SP, after a row-parallel matmul);
* :func:`vocab_parallel_ce` — the cross-entropy of logits split over
  the vocabulary, with its gradient;
* :func:`all_to_all` — jax's ``all_to_all(tiled=True)``: chunk r of
  ``split_dim`` goes to rank r, the chunks received are concatenated
  along ``concat_dim`` in rank order; the backward is the inverse
  exchange (Ulysses' sequence <-> head trade);
* :func:`ring_shift` — the ring rotation of ring attention (not an
  autograd function: the ring's own backward calls it).

Each is the identity, with no communication, on a group of one rank.
"""
from __future__ import annotations

import torch

from . import collective as C

__all__ = ["all_to_all", "copy_to", "gather_from", "reduce_from",
           "ring_shift", "scatter_to", "sp_gather", "sp_scatter",
           "vocab_parallel_ce"]


def _slice(x, group, dim):
    n = group.nranks
    return x.chunk(n, dim=dim)[group.rank].contiguous()


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return C.all_reduce(g.contiguous(), group=ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return C.all_reduce(x.contiguous(), group=group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return C.all_gather(None, x, group=group, axis=dim)

    @staticmethod
    def backward(ctx, g):
        return _slice(g, ctx.group, ctx.dim), None, None


class _ScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _slice(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return C.all_gather(None, g, group=ctx.group, axis=ctx.dim), None, \
            None


class _SpGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return C.all_gather(None, x, group=group, axis=dim)

    @staticmethod
    def backward(ctx, g):
        return C.reduce_scatter(None, g, group=ctx.group, axis=ctx.dim), \
            None, None


class _SpScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return C.reduce_scatter(None, x, group=group, axis=dim)

    @staticmethod
    def backward(ctx, g):
        return C.all_gather(None, g, group=ctx.group, axis=ctx.dim), None, \
            None


def copy_to(x, group):
    return x if group.nranks == 1 else _CopyTo.apply(x, group)


def reduce_from(x, group):
    return x if group.nranks == 1 else _ReduceFrom.apply(x, group)


def gather_from(x, group, dim=-1):
    return x if group.nranks == 1 else _GatherFrom.apply(x, group,
                                                         dim % x.dim())


def scatter_to(x, group, dim=-1):
    return x if group.nranks == 1 else _ScatterTo.apply(x, group,
                                                        dim % x.dim())


def sp_gather(x, group, dim=1):
    return x if group.nranks == 1 else _SpGather.apply(x, group,
                                                       dim % x.dim())


def sp_scatter(x, group, dim=1):
    return x if group.nranks == 1 else _SpScatter.apply(x, group,
                                                        dim % x.dim())


class _VocabParallelCE(torch.autograd.Function):
    """Per-row ``logsumexp(logits) - logits[label]`` over a vocabulary
    split across ``group``: ``logits`` [N, V / n] f32 holds columns
    [rank * V / n, (rank + 1) * V / n).  Three all-reduces over [N] rows
    (max, sum of exponentials, the label's logit); the gradient is
    ``softmax - onehot`` on the rank's columns, with no communication."""

    @staticmethod
    def forward(ctx, logits, labels, group):
        vl = logits.shape[-1]
        lo = group.rank * vl
        m = logits.amax(dim=-1)
        C.all_reduce(m, op=C.ReduceOp.MAX, group=group)
        e = torch.exp(logits - m[:, None])
        se = e.sum(dim=-1)
        C.all_reduce(se, group=group)
        local = labels - lo
        mine = (local >= 0) & (local < vl)
        idx = torch.where(mine, local, torch.zeros_like(local))
        tgt = torch.where(mine, logits.gather(-1, idx[:, None])[:, 0],
                          torch.zeros((), dtype=logits.dtype,
                                      device=logits.device))
        C.all_reduce(tgt, group=group)
        lse = m + torch.log(se)
        ctx.save_for_backward(e, se, idx, mine)
        return lse - tgt

    @staticmethod
    def backward(ctx, g):
        e, se, idx, mine = ctx.saved_tensors
        grad = e * (g / se)[:, None]
        grad.scatter_add_(-1, idx[:, None],
                          torch.where(mine, -g, torch.zeros_like(g))[:, None])
        return grad, None, None


def vocab_parallel_ce(logits, labels, group):
    """Per-row next-token CE of [N, V / n] f32 logits split over
    ``group`` (see :class:`_VocabParallelCE`)."""
    return _VocabParallelCE.apply(logits, labels, group)


# ------------------------------------------------- all-to-all exchanges
def _exchange(x, group, split_dim, concat_dim):
    n = group.nranks
    if x.shape[split_dim] % n:
        raise ValueError(f"dim {split_dim} of {tuple(x.shape)} does not "
                         f"split over {n} ranks")
    ins = [t.contiguous() for t in x.chunk(n, dim=split_dim)]
    return torch.cat(C.all_to_all([], ins, group=group), dim=concat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim):
        ctx.group, ctx.dims = group, (split_dim, concat_dim)
        return _exchange(x, group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return _exchange(g, ctx.group, concat_dim, split_dim), None, None, \
            None


def all_to_all(x, group, split_dim, concat_dim):
    """Chunk r of ``x`` along ``split_dim`` goes to rank r of ``group``;
    the chunks this rank receives are concatenated along ``concat_dim``
    in rank order (jax ``all_to_all(split_axis, concat_axis,
    tiled=True)``).  The gradient takes the inverse exchange."""
    if group.nranks == 1:
        return x
    return _AllToAll.apply(x, group, split_dim % x.dim(),
                           concat_dim % x.dim())


def ring_shift(tensors, group, shift=1):
    """Send each of ``tensors`` to the rank ``shift`` places ahead on the
    group's ring and receive the ones from ``shift`` places behind, all in
    one ``batch_isend_irecv`` (NCCL pairs posted apart can deadlock);
    returns the received tensors."""
    n = group.nranks
    if n == 1:
        return list(tensors)
    me = group.rank
    dst = group.ranks[(me + shift) % n]
    src = group.ranks[(me - shift) % n]
    sends = [t.contiguous() for t in tensors]
    outs = [torch.empty_like(t) for t in sends]
    ops = [C.P2POp(C.isend, t, dst, group, tag=i)
           for i, t in enumerate(sends)]
    ops += [C.P2POp(C.irecv, t, src, group, tag=i)
            for i, t in enumerate(outs)]
    for work in C.batch_isend_irecv(ops):
        work.wait()
    return outs
