"""Mixture-of-Experts dispatch and combine, on one device.

Ports ``paddle_tpu/distributed/moe.py``: the gating utilities
(``number_count``, ``limit_by_capacity``, ``prune_gate_by_capacity``),
the shared gating front-end (``_topk_choices``), GShard's dense gating
(``top_k_gating``), the counting-sort dispatch (``sort_dispatch_combine``)
and the dropless tile-aligned dispatch on the grouped expert FFN
(``grouped_dispatch_ffn``, the K9 kernels on CUDA), behind
``moe_dispatch_combine``'s ``"sort"``, ``"grouped"`` and ``"dense"``
modes.

What the reference leaves to its semantics, the port spells out:

* top-k breaks ties to the lower expert index, as ``lax.top_k`` does: a
  stable descending sort (``torch.topk`` promises no order);
* gate values are rounded to the activation dtype before the combine;
* the dispatch and combine gradients are the reference's hand-written
  gathers and k-major sums (``torch.autograd.Function``s), not autograd
  of an index gather, which would scatter-add in another order;
* the noise key is an explicit ``torch.Generator``: its Gumbel draws
  are not ``jax.random``'s bits.

Expert parallelism (``"sort"`` and ``"dense"``) runs one process per
rank of a ``ProcessMesh`` with ``dp`` and ``ep`` axes (either may be
missing, as size 1).  The reference runs the whole flattened batch
under one jit, so its capacity, its k-major fill order and its drops
are global; here each rank holds its dp row's tokens [S / dp, M] (the
same on every ep rank of the row) and its E / ep experts:

* each ep rank of a row takes 1/ep of the row's tokens (a *holder*:
  rank h = d·ep + j of the mesh holds the h-th slice of the global
  tokens) and routes only those;
* the holders all-gather their per-round, per-expert counts [K, E]:
  from them every rank knows every entry's global position, so the
  capacity ``ceil(S K cf / E)`` of the global S and the drops past it
  are the reference's;
* a dp row's kept entries fill per-row capacity slots [E, C_d, M]
  (C_d = the row's most-loaded expert), which a reduce-scatter over the
  ep group (``mp_ops.sp_scatter``, the reference's ``global_scatter``)
  carries to the experts' ranks and an all-gather (``mp_ops.sp_gather``,
  its ``global_gather``) brings back; every row computes only its own
  slots;
* the router ``gate`` enters through ``mp_ops.copy_to`` over ep (each
  holder's gradient is summed over the row) and the aux loss is the
  global mean: each holder's part over the global token count, summed
  over the mesh by ``mp_ops.reduce_from``;
* the output is all-gathered over ep, so every ep rank of a row holds
  y [S / dp, M] whole.

Gradients come out as one device's would for the rank's rows: the
expert leaves and the gate still need the sum over dp that a train
step makes.  A mesh may also be ``None`` or a mapping of axis sizes
(``{"dp": 1, "ep": 1}``, as ``models.moe_llm.build_mesh`` returns at
one device); a mesh that names the ep axis counts as ep-sharded, as in
the reference, which keeps the grouped mode off it.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import collective as C
from . import mp_ops
from .mesh import ProcessMesh

__all__ = ["EPLayout", "ep_layout", "grouped_dispatch_ffn",
           "limit_by_capacity", "moe_dispatch_combine", "number_count",
           "prune_gate_by_capacity", "sort_dispatch_combine", "top_k_gating"]


def gelu(x):
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


class EPLayout(NamedTuple):
    """Where a rank sits on a (dp, ep) mesh: the axis sizes, its
    coordinates, its ep and dp groups and the group of every rank of the
    mesh (the token holders, in mesh order)."""
    dp: int
    ep: int
    d: int
    j: int
    ep_group: object
    dp_group: object
    group: object

    @property
    def holder(self):
        return self.d * self.ep + self.j

    @property
    def holders(self):
        return self.dp * self.ep


def ep_layout(mesh, ep_axis="ep"):
    """(ep-sharded, :class:`EPLayout` or None): whether ``mesh`` names
    the ep axis (the reference keeps the grouped mode off such a mesh),
    and, for a ``ProcessMesh`` of more than one rank, this process's
    place on it.
    ``mesh``: None, a mapping of axis sizes that are all 1, or a
    ``ProcessMesh`` whose axes are among ``dp`` and ``ep_axis``."""
    if mesh is None:
        return False, None
    named = ep_axis in (mesh.dim_names if isinstance(mesh, ProcessMesh)
                        else mesh)
    if not isinstance(mesh, ProcessMesh):
        sizes = {a: int(n) for a, n in mesh.items()}
        if any(n > 1 for n in sizes.values()):
            raise ValueError(
                f"a mesh of {sizes} is a ProcessMesh of processes (one per "
                "rank, after distributed.init_parallel_env()); a mapping "
                "serves one device")
        return named, None
    axes = ("dp", ep_axis)
    extra = [a for a in mesh.dim_names if a not in axes]
    if extra:
        raise ValueError(f"an expert-parallel mesh has axes among {axes}, "
                         f"got {mesh.dim_names}")
    dp, ep = (mesh.get_dim_size(a) if a in mesh.dim_names else 1
              for a in axes)
    if dp * ep == 1:
        return named, None
    import torch.distributed as dist
    me = dist.get_rank() if dist.is_initialized() else 0
    at = mesh.coords(me)
    d, j = at.get("dp", 0), at.get(ep_axis, 0)

    def group(names):
        names = [a for a in names if a in mesh.dim_names]
        return mesh.group(names) if names else C.Group([me])
    return named, EPLayout(dp, ep, d, j, group([ep_axis]), group(["dp"]),
                           group(axes))


# -------------------------------------------------- reference gating utils
def number_count(gate_idx, upper_range):
    """Tokens per expert (reference number_count_kernel); ids outside
    [0, upper_range) count nowhere."""
    idx = gate_idx.reshape(-1)
    idx = idx[(idx >= 0) & (idx < upper_range)]
    return torch.bincount(idx, minlength=upper_range).to(torch.int32)


def limit_by_capacity(expert_count, capacity, n_worker=1):
    """Clamp per-expert token counts (reference limit_by_capacity_kernel)."""
    return torch.minimum(expert_count,
                         torch.as_tensor(capacity * n_worker,
                                         dtype=expert_count.dtype,
                                         device=expert_count.device))


def prune_gate_by_capacity(gate_idx, expert_count, capacity):
    """Mark overflow tokens' gate index as -1 (reference
    prune_gate_by_capacity_kernel)."""
    e = expert_count.shape[-1]
    onehot = (gate_idx[..., None] == torch.arange(
        e, device=gate_idx.device)).to(torch.int32)
    pos = torch.cumsum(onehot, dim=0) * onehot   # 1-based position per expert
    my_pos = pos.sum(dim=-1)
    return torch.where(my_pos <= capacity, gate_idx,
                       torch.full_like(gate_idx, -1))


# ------------------------------------------------------------- GShard core
def top_k_gating(logits, top_k=2, capacity_factor=1.25, capacity=None,
                 train=True, noise_key=None):
    """logits: [S, E] -> (combine [S, E, C] f32, dispatch [S, E, C] bool,
    aux_loss scalar).  Static capacity C; positions fill round by round
    (all first choices before any second choice)."""
    s, e = logits.shape
    capacity = _capacity(s, top_k, capacity_factor, e, capacity)
    idx, gv, aux = _topk_choices(logits, top_k, train, noise_key)
    dev = logits.device
    combine = torch.zeros((s, e, capacity), dtype=torch.float32, device=dev)
    dispatch = torch.zeros((s, e, capacity), dtype=torch.bool, device=dev)
    fill = torch.zeros((e,), dtype=torch.int32, device=dev)
    for r in range(top_k):
        onehot = F.one_hot(idx[:, r], e).to(torch.float32)         # [S, E]
        pos = (torch.cumsum(onehot, dim=0) - 1.0) * onehot      # 0-based
        pos = pos + fill[None, :] * onehot
        in_cap = (pos < capacity) & (onehot > 0)
        posc = torch.clamp(pos.to(torch.int64), 0, capacity - 1)
        sel = F.one_hot(posc, capacity).to(torch.float32) * in_cap[..., None]
        combine = combine + sel * gv[:, r, None, None]
        dispatch = dispatch | (sel > 0)
        fill = fill + (onehot * in_cap).sum(dim=0).to(torch.int32)
    return combine, dispatch, aux


def _gumbel(shape, generator, device, dtype):
    """Gumbel(0, 1) draws from ``generator``, as ``jax.random.gumbel``
    forms them (uniform on [tiny, 1), then -log(-log(u)))."""
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32).clamp_min(tiny)
    return (-torch.log(-torch.log(u))).to(dtype)


def _choices(logits, top_k, train, noise_key):
    """Per-token expert ids [S, K] (descending prob, ties to the lower
    index), gate values [S, K] f32 and the f32 probabilities [S, E].
    ``noise_key``: a torch.Generator on the logits' device, or None."""
    if train and noise_key is not None:
        logits = logits + _gumbel(logits.shape, noise_key, logits.device,
                                  logits.dtype) * 1e-2
    probs = torch.softmax(logits.float(), dim=-1)
    order = torch.sort(probs, dim=-1, descending=True, stable=True).indices
    idx = order[:, :top_k]                                   # [S, K]
    return idx, probs.gather(1, idx), probs


def _topk_choices(logits, top_k, train, noise_key):
    """Shared gating front-end: :func:`_choices`' ids and gate values,
    and the Switch load-balancing aux loss."""
    idx, gv, probs = _choices(logits, top_k, train, noise_key)
    e = probs.shape[-1]
    frac = F.one_hot(idx, e).to(torch.float32).mean(dim=0)   # [K, E]
    mean_p = probs.mean(dim=0)
    aux = e * (frac * mean_p[None, :]).sum(dim=-1).mean()
    return idx, gv, aux


def _capacity(s, top_k, capacity_factor, e, capacity):
    if capacity is not None:
        return capacity
    return max(4, int(math.ceil(s * top_k * capacity_factor / e)))


# Both directions of the dispatch and the combine are gathers with
# hand-written backward passes (the reference's custom VJPs, kept so
# that the sums run in the reference's k-major order).  Index tensors
# ride along as non-differentiable arguments.
class _GatherDispatch(torch.autograd.Function):
    """Token rows [S, M] -> expert buffer [slots, M].

    ft_slot[slot] = token feeding that slot, svalid[slot] = slot actually
    filled; dest[k-major entry] = slot fed by that entry (the dump slot
    when dropped), keep[entry] = entry in capacity."""

    @staticmethod
    def forward(ctx, x, ft_slot, svalid, dest, keep):
        ctx.save_for_backward(dest, keep)
        ctx.s, ctx.x_dtype = x.shape[0], x.dtype
        return torch.where(svalid[:, None], x[ft_slot], 0)

    @staticmethod
    def backward(ctx, dbuf):
        dest, keep = ctx.saved_tensors
        s, m = ctx.s, dbuf.shape[-1]
        k = dest.shape[0] // s
        # dest is k-major entry order, so the reshape IS the per-round split
        dent = dbuf[torch.clamp(dest, max=dbuf.shape[0] - 1)] \
            * keep[:, None].to(dbuf.dtype)
        dx = dent.reshape(k, s, m).sum(dim=0)
        return dx.to(ctx.x_dtype), None, None, None, None


class _GatherCombine(torch.autograd.Function):
    """Expert rows [slots, M] * gate values -> token rows [S, M]."""

    @staticmethod
    def forward(ctx, flat, gvf, ft, ft_slot, gv_slot, svalid, dest, keep, s):
        ctx.save_for_backward(flat, gvf, ft, ft_slot, gv_slot, svalid, dest,
                              keep)
        m = flat.shape[-1]
        k = dest.shape[0] // s
        back = flat[torch.clamp(dest, max=flat.shape[0] - 1)] \
            * (gvf * keep.to(gvf.dtype))[:, None]
        return back.reshape(k, s, m).sum(dim=0)

    @staticmethod
    def backward(ctx, dy):
        flat, gvf, ft, ft_slot, gv_slot, svalid, dest, keep = \
            ctx.saved_tensors
        # a slot gets its gradient from the unique entry that fills it
        dflat = torch.where(svalid[:, None],
                            gv_slot[:, None] * dy[ft_slot].to(flat.dtype), 0)
        # gate-value grad: <expert row, token cotangent> per entry, in f32
        dgv = keep.to(gvf.dtype) * (
            flat[torch.clamp(dest, max=flat.shape[0] - 1)].float()
            * dy[ft].float()).sum(dim=-1).to(gvf.dtype)
        return dflat, dgv, None, None, None, None, None, None, None


def _count_rank(idx, gv, e, dtype):
    """Counting-sort front-end shared by the capacity and tile-aligned
    dispatches: k-major flatten + per-expert rank via one-hot cumsum
    (round-0 choices rank before round-1)."""
    s, k = idx.shape
    n = s * k
    fe = idx.T.reshape(n)                  # k-major: round 0 first
    ft = torch.arange(s, device=idx.device).repeat(k)
    gvf = gv.T.reshape(n).to(dtype)
    onehot = F.one_hot(fe, e)
    # the running count down the entries, scanned along the contiguous
    # axis of the transpose (a scan down the n-long outer axis of [n, E]
    # runs ~30x slower on the card for the same integers)
    running = torch.cumsum(onehot.T.contiguous(), dim=1).T
    pos = (running * onehot).sum(dim=1) - 1
    counts = onehot.sum(dim=0)
    return n, fe, ft, gvf, pos, counts


def _slot_views(entry_of_slot, ft, gvf, n):
    """Slot-side maps from the inverted permutation: validity, feeding
    token, gate value."""
    svalid = entry_of_slot < n
    eos = torch.clamp(entry_of_slot, max=n - 1)
    return svalid, ft[eos], torch.where(svalid, gvf[eos], 0)


def _invert(dest, size, n):
    """slot -> entry: ``size`` slots, ``n`` (no entry) where none lands."""
    entry_of_slot = torch.full((size,), n, dtype=torch.int64,
                               device=dest.device)
    entry_of_slot[dest] = torch.arange(n, device=dest.device)
    return entry_of_slot


def sort_dispatch_combine(x, idx, gv, e, capacity, ffn):
    """Counting-sort dispatch/combine.

    x: [S, M] tokens; idx/gv: [S, K] expert choices (k-major priority:
    all first choices fill capacity before any second choice); ffn maps
    [E, C, M] -> [E, C, M].  Returns y [S, M]; entries past capacity
    contribute zero."""
    s, m = x.shape
    n, fe, ft, gvf, pos, _counts = _count_rank(idx, gv, e, x.dtype)
    keep = pos < capacity
    # dump slot e*capacity catches dropped entries; sliced off below
    dest = torch.where(keep, fe * capacity + pos,
                       torch.full_like(fe, e * capacity))
    # kept entries own unique slots; the dump slot's writer is arbitrary
    # and the [:e*capacity] slice discards it
    entry_of_slot = _invert(dest, e * capacity + 1, n)[:e * capacity]
    svalid, ft_slot, gv_slot = _slot_views(entry_of_slot, ft, gvf, n)

    expert_in = _GatherDispatch.apply(x, ft_slot, svalid, dest, keep)
    expert_out = ffn(expert_in.reshape(e, capacity, m))
    flat = expert_out.reshape(e * capacity, m)
    return _GatherCombine.apply(flat, gvf, ft, ft_slot, gv_slot, svalid,
                                dest, keep, s)


def _tile_layout(idx, gv, e, dtype):
    """The dropless tile-aligned buffer layout of ``grouped_dispatch_ffn``:
    (n entries, feeding token per entry, gate value per entry, buffer row
    per entry, slot validity, feeding token per slot, gate value per slot,
    emap int32 [R / TILE]).  Each expert's rows round up to TILE-row
    tiles; R = (ceil(n / TILE) + E) * TILE bounds the buffer statically,
    its trailing tiles clipped to expert E - 1."""
    from ..ops.pallas.grouped_ffn import TILE

    n, fe, ft, gvf, pos, counts = _count_rank(idx, gv, e, dtype)
    padded = (counts + TILE - 1) // TILE * TILE
    off = torch.cumsum(padded, dim=0) - padded   # tile-aligned expert starts
    r = (-(-n // TILE) + e) * TILE               # static row bound
    dest = off[fe] + pos                         # dropless: always kept
    svalid, ft_slot, gv_slot = _slot_views(_invert(dest, r, n), ft, gvf, n)
    # tile -> expert: experts own contiguous tile runs starting at off
    tile_starts = torch.arange(r // TILE, device=idx.device) * TILE
    emap = torch.clamp(torch.searchsorted(off, tile_starts, right=True) - 1,
                       0, e - 1).to(torch.int32)
    return n, ft, gvf, dest, svalid, ft_slot, gv_slot, emap


def grouped_dispatch_ffn(x, idx, gv, e, w1, b1, w2, b2, gated=False,
                         use_kernel=None):
    """DROPLESS dispatch + grouped expert FFN.

    Tokens counting-sort into a TILE-aligned buffer: each expert's rows
    round up to the 128-row tile, so every row tile belongs to one
    expert, and ``ops.pallas.grouped_ffn`` computes both expert products
    with the expert chosen per tile.  No capacity, no dropped tokens.

    x [S, M]; idx/gv [S, K]; w1 [E, M, F(*2)]; w2 [E, F, M].  Returns
    y [S, M].  use_kernel: None = the K9 kernels on CUDA and the plain
    ``grouped_ffn_xla`` (autograd) on the CPU; True = ``grouped_ffn``
    (its kernels on CUDA, their plain versions on the CPU); False = the
    plain ``grouped_ffn_xla`` on any device."""
    from ..ops.pallas.grouped_ffn import grouped_ffn, grouped_ffn_xla

    s = x.shape[0]
    n, ft, gvf, dest, svalid, ft_slot, gv_slot, emap = _tile_layout(
        idx, gv, e, x.dtype)
    keep = torch.ones((n,), dtype=torch.bool, device=x.device)
    x_buf = _GatherDispatch.apply(x, ft_slot, svalid, dest, keep)
    if use_kernel is None:
        use_kernel = x.device.type == "cuda"
    fn = grouped_ffn if use_kernel else grouped_ffn_xla
    out = fn(x_buf, w1, b1, w2, b2, emap, gated)
    return _GatherCombine.apply(out, gvf, ft, ft_slot, gv_slot, svalid,
                                dest, keep, s)


def moe_dispatch_combine(x, gate_w, w1, b1, w2, b2, *, top_k=2,
                         capacity_factor=1.25, activation=gelu, mesh=None,
                         ep_axis="ep", train=True, noise_key=None,
                         dispatch_mode="sort"):
    """Full MoE FFN over flat tokens.

    x: [S, M]; gate_w: [M, E]; w1: [E, M, F]; b1: [E, F]; w2: [E, F, M];
    b2: [E, M].  Returns (y [S, M], aux_loss f32).

    dispatch_mode "sort" (default): counting-sort dispatch at capacity
    ceil(S K capacity_factor / E) (at least 4), the expert FFN as two
    einsums; "grouped": dropless, on the grouped expert FFN (K9 on CUDA),
    silu only, one device; "dense": GShard's one-hot einsums.

    On a ``ProcessMesh`` of (dp, ep) ranks (module docstring): x is this
    rank's dp row [S / dp, M], w1/b1/w2/b2 its E / ep experts, gate_w
    whole; y is the row's output and aux the global one."""
    ep_sharded, lay = ep_layout(mesh, ep_axis)
    if lay is not None:
        return _ep_dispatch_combine(x, gate_w, w1, b1, w2, b2, lay, top_k,
                                    capacity_factor, activation, train,
                                    noise_key, dispatch_mode)
    logits = x @ gate_w.to(x.dtype)
    s, e = logits.shape
    cap = _capacity(s, top_k, capacity_factor, e, None)

    def ffn(expert_in):
        h = activation(torch.einsum("ecm,emf->ecf", expert_in, w1)
                       + b1[:, None, :])
        return torch.einsum("ecf,efm->ecm", h, w2) + b2[:, None, :]

    if dispatch_mode == "sort":
        idx, gv, aux = _topk_choices(logits, top_k, train, noise_key)
        y = sort_dispatch_combine(x, idx, gv, e, cap, ffn)
        return y, aux.float()
    if dispatch_mode == "grouped":
        # dropless tile-aligned grouped GEMM (no capacity, no drops);
        # single-device formulation, as in the reference
        if ep_sharded:
            raise NotImplementedError(
                "dispatch_mode='grouped' is single-device; use 'sort' "
                "under an ep-sharded mesh")
        if activation is not F.silu:
            raise NotImplementedError(
                "the grouped kernel implements the silu FFN "
                "(gated=True for swiglu via grouped_dispatch_ffn)")
        idx, gv, aux = _topk_choices(logits, top_k, train, noise_key)
        y = grouped_dispatch_ffn(x, idx, gv, e, w1, b1, w2, b2)
        return y, aux.float()
    if dispatch_mode != "dense":
        raise ValueError(f"dispatch_mode must be 'sort', 'grouped' or "
                         f"'dense', got {dispatch_mode!r}")

    combine, dispatch, aux = top_k_gating(
        logits, top_k=top_k, capacity_factor=capacity_factor,
        capacity=cap, train=train, noise_key=noise_key)
    combine = combine.to(x.dtype)
    # dispatch: [S, E, C] x [S, M] -> [E, C, M]; boolean mask, the gate
    # scaling happens only on the combine side
    expert_in = torch.einsum("sec,sm->ecm", dispatch.to(x.dtype), x)
    expert_out = ffn(expert_in)
    y = torch.einsum("sec,ecm->sm", combine, expert_out)
    return y, aux.float()


# ------------------------------------------------- expert parallelism
def _global_slots(idx, lay: EPLayout, e, capacity_factor):
    """The holder's entries (k-major, as :func:`_count_rank`) in the
    reference's global order: every holder's round-0 entries, holder by
    holder, before any round-1 entry.  All-gathers the per-round,
    per-expert counts [K, E] of every holder; returns (fe, keep, cpos,
    c_d, counts [H, K, E]): an entry is kept where its global position
    in its expert is under the global capacity, and cpos is its slot in
    its dp row's [E, c_d] buffer (the row's kept entries of that expert
    before it, in the global order)."""
    s, k = idx.shape
    onehot = F.one_hot(idx.T, e)                          # [K, S, E]
    # rank within (round, expert), scanned along the contiguous axis
    running = torch.cumsum(onehot.transpose(1, 2).contiguous(),
                           dim=2).transpose(1, 2)
    q = ((running * onehot).sum(dim=-1) - 1).reshape(-1)  # k-major
    mine = onehot.sum(dim=1)                              # [K, E]
    counts = C.all_gather(None, mine[None].contiguous(),
                          group=lay.group, axis=0)        # [H, K, E]
    cap = _capacity(s * lay.holders, k, capacity_factor, e, None)
    # global start of each holder's run of (round r, expert e) entries
    tot = counts.sum(dim=0)
    before_r = torch.cumsum(tot, dim=0) - tot             # rounds < r
    before_h = torch.cumsum(counts, dim=0) - counts       # holders < h
    start = before_r[None] + before_h
    kept = torch.clamp(cap - start, min=0)
    kept = torch.minimum(kept, counts)                    # [H, K, E]
    # per dp row, the kept entries before each run: rounds, then holders
    rows = kept.reshape(lay.dp, lay.ep, k, e).transpose(1, 2) \
        .reshape(lay.dp, k * lay.ep, e)
    base = (torch.cumsum(rows, dim=1) - rows).reshape(
        lay.dp, k, lay.ep, e).transpose(1, 2).reshape(lay.holders, k, e)
    c_d = max(1, int(rows[lay.d].sum(dim=0).max()))
    fe = idx.T.reshape(-1)
    r = torch.arange(k, device=idx.device).repeat_interleave(s)
    h = lay.holder
    keep = q < kept[h, r, fe]
    cpos = base[h, r, fe] + q
    return fe, keep, cpos, c_d, counts


def _ep_dispatch_combine(x, gate_w, w1, b1, w2, b2, lay: EPLayout, top_k,
                         capacity_factor, activation, train, noise_key,
                         dispatch_mode):
    """:func:`moe_dispatch_combine` on a (dp, ep) mesh (module
    docstring)."""
    if dispatch_mode == "grouped":
        raise NotImplementedError(
            "dispatch_mode='grouped' is single-device; use 'sort' under an "
            "ep-sharded mesh")
    if dispatch_mode not in ("sort", "dense"):
        raise ValueError(f"dispatch_mode must be 'sort', 'grouped' or "
                         f"'dense', got {dispatch_mode!r}")
    e = gate_w.shape[-1]
    if e % lay.ep or w1.shape[0] * lay.ep != e:
        raise ValueError(f"{e} experts over ep {lay.ep}: each rank holds "
                         f"E / ep of them, got {w1.shape[0]}")
    if x.shape[0] % lay.ep:
        raise ValueError(f"{x.shape[0]} tokens of a dp row do not split "
                         f"over ep {lay.ep}")
    xc = mp_ops.scatter_to(x, lay.ep_group, dim=0)        # the holder's
    s, m = xc.shape
    logits = xc @ mp_ops.copy_to(gate_w, lay.ep_group).to(x.dtype)
    idx, gv, probs = _choices(logits, top_k, train, noise_key)
    fe, keep, cpos, c_d, counts = _global_slots(idx, lay, e,
                                                capacity_factor)
    n_tok = s * lay.holders
    # the aux loss's global means: frac from the gathered counts, and this
    # holder's share of mean_p (reduce_from sums the shares over the mesh)
    frac = counts.sum(dim=0).to(torch.float32) / n_tok    # [K, E]
    part = e * (frac * probs.sum(dim=0)[None, :]).sum(dim=-1).mean() / n_tok
    aux = mp_ops.reduce_from(part, lay.group)

    def ffn(expert_in):
        h = activation(torch.einsum("ecm,emf->ecf", expert_in, w1)
                       + b1[:, None, :])
        return torch.einsum("ecf,efm->ecm", h, w2) + b2[:, None, :]

    def experts(buf):                        # [E, c_d, M] -> [E, c_d, M]
        # the reference's global_scatter / global_gather: each slot is
        # filled by at most one rank of the group, so a reduce-scatter
        # over the experts' dim merges the senders' buffers exactly, and
        # an all-gather brings every rank's experts' outputs back
        got = mp_ops.sp_scatter(buf, lay.ep_group, dim=0)
        return mp_ops.sp_gather(ffn(got), lay.ep_group, dim=0)

    n = fe.shape[0]
    ft = torch.arange(s, device=x.device).repeat(top_k)
    gvf = gv.T.reshape(n)
    if dispatch_mode == "sort":
        gvf = gvf.to(x.dtype)
        dest = torch.where(keep, fe * c_d + cpos,
                           torch.full_like(fe, e * c_d))
        entry_of_slot = _invert(dest, e * c_d + 1, n)[:e * c_d]
        svalid, ft_slot, gv_slot = _slot_views(entry_of_slot, ft, gvf, n)
        buf = _GatherDispatch.apply(xc, ft_slot, svalid, dest, keep)
        out = experts(buf.reshape(e, c_d, m)).reshape(e * c_d, m)
        y = _GatherCombine.apply(out, gvf, ft, ft_slot, gv_slot, svalid,
                                 dest, keep, s)
    else:
        # GShard's one-hots at the row's slots: each (token, expert, slot)
        # is filled by at most one entry
        at = (ft[keep], fe[keep], cpos[keep])
        dispatch = torch.zeros((s, e, c_d), dtype=x.dtype,
                               device=x.device).index_put(
            at, torch.ones_like(at[0], dtype=x.dtype))
        combine = torch.zeros((s, e, c_d), dtype=torch.float32,
                              device=x.device).index_put(at, gvf[keep])
        out = experts(torch.einsum("sec,sm->ecm", dispatch, xc))
        y = torch.einsum("sec,ecm->sm", combine.to(x.dtype), out)
    return mp_ops.gather_from(y, lay.ep_group, dim=0), aux.float()
