"""Ring and Ulysses attention over a sequence-parallel group (context
parallelism).

Ports ``paddle_tpu/ops/ring_attention.py``.  The reference runs each
under ``shard_map`` over a mesh axis and differentiates through the
collective loop with ``jax.grad``; here every rank of the ``sep`` group
is a process holding its chunk [B, S/n, H, D] of q, k and v (chunk r
covers positions [r·S/n, (r+1)·S/n)), and the collectives are explicit:

* :func:`ring_attention` — blockwise attention with the online-softmax
  recurrence (``_block_attn`` ``:29``, ``_ring_body`` ``:47-80``): each
  rank keeps its q chunk while the k and v chunks rotate around the ring
  (``mp_ops.ring_shift``, one ``batch_isend_irecv`` a step).  The block
  math is plain PyTorch in float32, as the reference leaves it to XLA.
  Its gradient is a ``torch.autograd.Function`` whose backward is the
  reverse ring: each block's probabilities are recomputed from the
  forward's saved log-sum-exp, dq accumulates on its rank, and the dk/dv
  accumulators rotate with their k/v chunk, so that after n steps they
  are home.  A causal block whose every key lies ahead of every query
  contributes nothing, and is skipped (the reference computes it and
  clamps its max to -1e30, which gives the same zeros).
* :func:`ulysses_attention` — DeepSpeed-Ulysses: ``mp_ops.all_to_all``
  trades the sequence split for a head split (head chunk r to rank r,
  the sequence concatenated in rank order), the port's ``sdpa`` runs on
  the whole sequence at H/n heads (K1 and K2 on the card), and the
  inverse exchange trades back; its gradient is the exchanges' inverse.

With one rank in the group both are ``sdpa`` of the whole sequence.  The
ring takes the shapes the reference's einsum takes: equal q and kv head
counts; GQA inputs raise.
"""
from __future__ import annotations

import torch

from ..distributed import mp_ops
from .pallas.flash_attention import sdpa

__all__ = ["ring_attention", "ulysses_attention"]


def _sep_group(mesh, axis):
    """The group of ``axis`` (None: one rank).  ``mesh``: a
    ``ProcessMesh``, or None / a mapping of axis sizes at one device."""
    if mesh is None:
        return None
    if hasattr(mesh, "group"):
        if mesh.get_dim_size(axis) == 1:
            return None
        return mesh.group(axis)
    if int(mesh.get(axis, 1)) > 1:
        raise ValueError(f"a {axis} axis of {mesh[axis]} ranks is a "
                         "ProcessMesh of processes")
    return None


def _scores(q, k, scale, mask):
    """[B, H, Sq, Sk] f32 scores of q [B, H, Sq, D] and k [B, H, Sk, D];
    hidden pairs -inf."""
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    if mask is not None:
        s = s.masked_fill(~mask, float("-inf"))
    return s


def _block_attn(q, k, v, scale, mask):
    """One q chunk vs one kv chunk (all [B, H, S, D] f32): the unscaled
    accumulator, the row max (clamped to -1e30 where a row sees no key)
    and the row sum."""
    s = _scores(q, k, scale, mask)
    m = s.amax(dim=-1).clamp_min(-1e30)
    p = torch.exp(s - m[..., None])
    return torch.matmul(p, v), m, p.sum(dim=-1)


def _diag_mask(sl, device):
    """The causal mask of a chunk against itself: query i sees keys <= i."""
    i = torch.arange(sl, device=device)
    return i[:, None] >= i[None, :]


def _visible(causal, src, me):
    """Whether chunk ``me``'s queries see any key of chunk ``src``, and
    the mask that block needs (None: every pair)."""
    if not causal or src < me:
        return True, False
    return src == me, src == me


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, group, causal):
        n, me = group.nranks, group.rank
        qf = q.transpose(1, 2).float()                     # [B, H, Sl, D]
        b, h, sl, d = qf.shape
        scale = d ** -0.5
        diag = _diag_mask(sl, q.device)
        o = torch.zeros_like(qf)
        m = torch.full((b, h, sl), float("-inf"), device=q.device)
        l = torch.zeros((b, h, sl), device=q.device)
        kc, vc = k, v
        for i in range(n):
            src = (me - i) % n
            seen, masked = _visible(causal, src, me)
            if seen:
                acc, bm, bl = _block_attn(
                    qf, kc.transpose(1, 2).float(),
                    vc.transpose(1, 2).float(), scale,
                    diag if masked else None)
                new_m = torch.maximum(m, bm)
                alpha = torch.exp(m - new_m)
                beta = torch.exp(bm - new_m)
                o = o * alpha[..., None] + acc * beta[..., None]
                l = l * alpha + bl * beta
                m = new_m
            if i < n - 1:
                kc, vc = mp_ops.ring_shift([kc, vc], group)
        out = o / l.clamp_min(1e-30)[..., None]
        lse = torch.where(l > 0, m + torch.log(l),
                          torch.full_like(l, float("inf")))
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.group, ctx.causal = group, causal
        return out.transpose(1, 2).to(q.dtype)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        group, causal = ctx.group, ctx.causal
        n, me = group.nranks, group.rank
        qf = q.transpose(1, 2).float()
        do = dout.transpose(1, 2).float()
        sl, d = qf.shape[2], qf.shape[3]
        scale = d ** -0.5
        diag = _diag_mask(sl, q.device)
        delta = (do * out).sum(dim=-1, keepdim=True)       # [B, H, Sl, 1]
        dq = torch.zeros_like(qf)
        kc, vc = k, v
        dkc = torch.zeros_like(qf)
        dvc = torch.zeros_like(qf)
        for i in range(n):
            src = (me - i) % n
            seen, masked = _visible(causal, src, me)
            if seen:
                kf = kc.transpose(1, 2).float()
                vf = vc.transpose(1, 2).float()
                p = torch.exp(_scores(qf, kf, scale, diag if masked else None)
                              - lse[..., None])
                dvc = dvc + torch.matmul(p.transpose(-1, -2), do)
                ds = p * (torch.matmul(do, vf.transpose(-1, -2)) - delta)
                dq = dq + torch.matmul(ds, kf) * scale
                dkc = dkc + torch.matmul(ds.transpose(-1, -2), qf) * scale
            # the accumulators travel with their chunk; the n-th shift
            # brings them home
            if i < n - 1:
                kc, vc, dkc, dvc = mp_ops.ring_shift([kc, vc, dkc, dvc],
                                                     group)
            else:
                dkc, dvc = mp_ops.ring_shift([dkc, dvc], group)
        return (dq.transpose(1, 2).to(q.dtype),
                dkc.transpose(1, 2).to(k.dtype),
                dvc.transpose(1, 2).to(v.dtype), None, None)


def ring_attention(q, k, v, mesh, axis="sep", is_causal=True):
    """Exact softmax attention of this rank's q, k, v chunks [B, S/n, H,
    D] against the whole sequence spread over ``axis`` of ``mesh`` (a
    ``ProcessMesh``), with O(S/n) memory per rank; returns this rank's
    output chunk.  One rank: ``sdpa``."""
    group = _sep_group(mesh, axis)
    if group is None:
        return sdpa(q, k, v, is_causal=is_causal)
    if k.shape[2] != q.shape[2] or v.shape[2] != q.shape[2]:
        raise ValueError(
            f"ring_attention takes equal q and kv head counts (the "
            f"reference's einsum), got {q.shape[2]} and {k.shape[2]}: "
            "repeat the kv heads, or use ulysses_attention")
    return _RingAttention.apply(q, k, v, group, bool(is_causal))


def ulysses_attention(q, k, v, mesh, axis="sep", is_causal=True):
    """DeepSpeed-Ulysses: all-to-all sequence <-> head resharding around
    ``sdpa`` of the whole sequence at H/n heads.  The head counts must
    divide the axis size."""
    group = _sep_group(mesh, axis)
    if group is None:
        return sdpa(q, k, v, is_causal=is_causal)
    n = group.nranks
    for name, t in (("num_heads", q), ("num_kv_heads", k)):
        if t.shape[2] % n:
            raise ValueError(f"{name} {t.shape[2]} must be divisible by the "
                             f"sep degree {n}")

    def to_heads(t):                      # [B, S/n, H, D] -> [B, S, H/n, D]
        return mp_ops.all_to_all(t, group, split_dim=2, concat_dim=1)

    og = sdpa(to_heads(q), to_heads(k), to_heads(v), is_causal=is_causal)
    return mp_ops.all_to_all(og, group, split_dim=1, concat_dim=2)
