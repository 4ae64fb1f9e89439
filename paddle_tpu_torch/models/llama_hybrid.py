"""Hybrid-parallel (pp x dp x tp + sp) Llama pretraining step, in PyTorch.

Ports ``paddle_tpu/models/llama_hybrid.py``: ``build_mesh`` (``:48``),
``default_axes`` (``:57``), ``init_params`` (``:69``),
``param_shardings`` (``:107``), ``_rms``, ``_decoder_layer`` and
``_stage_fn`` (``:124-186``, ``remat`` True, False or "attn"),
``loss_fn`` (``:233``) with the GPipe trunk (``pipelined_trunk``,
``:188``), ``_chunked_ce_sum`` (``:259``), ``grad_1f1b`` (``:286``),
``AdamWState``/``init_adamw``, ``build_train_step`` (``:354``),
``zero1_shardings`` (``:462``) and ``setup`` (``:483``).

The reference is one SPMD program over a ('pp', 'dp', 'tp') mesh; here
each rank of the mesh is a process (``distributed/mesh.py``) holding its
own shard, and every collective is explicit:

* tp — Megatron: q/k/v/gate/up split by output column, o/down by input
  row, the embedding by hidden (``P(None, 'tp')``) and the head by
  vocabulary; the all-reduces (and, with ``sp``, the sequence
  all-gathers and reduce-scatters) live in the autograd functions of
  ``distributed/mp_ops.py``; the CE is vocabulary-parallel.  Each rank
  runs attention on its nh/tp query heads over its kvh/tp kv heads.
* sp — Megatron-SP when ``sp`` is set, tp > 1 and tp divides the
  sequence (reference ``:246-250``): outside attention and the MLP the
  activations hold this rank's 1/tp of the sequence, and the layer
  norms' gradients are summed over tp.  As in the reference, only the
  GPipe schedule honours it (``:305-311``).
* pp — the stages exchange activations and cotangents point to point:
  GPipe through ``distributed/pipelining.py``, 1F1B, interleaved (VPP)
  and zero bubble through ``distributed/pipeline_schedules.py``.  Stage
  s holds virtual stages {c·pp + s}; the embedding runs at stage 0, the
  final norm, head and CE at the last, and their gradients are summed
  over pp (the reference's psum).  With pp = 1 the whole batch runs at
  once (the reference vmaps its microbatches).
* dp — each rank takes its 1/dp of the batch's rows; the gradients are
  all-reduced over dp, or, under ZeRO-1, reduce-scattered: each dp rank
  keeps the float32 AdamW m and v of its 1/dp of each leaf's elements
  (:func:`zero1_shardings`), updates that part of the parameter, and the
  parts are all-gathered back, so parameters stay whole on every dp rank
  (the reference's stage-1 contract).

The math is the reference's: the same loss (CE summed and divided by the
global batch's tokens), the same AdamW update, the same stage ownership.
A step takes the global [B, S+1] batch on every rank.

The param tree keeps the reference's keys ``{"embed", "stages", "norm",
"head"}`` with ``[in, out]`` weights, but ``stages`` is a list of one
dict per layer (keys ``_LAYER_KEYS``) this rank holds, chunk by chunk,
instead of one stacked ``[pp, (v), lps, ...]`` leaf per weight: indexing
a stacked leaf per layer would make autograd allocate a full-size zero
gradient for every ``w[i]``.  ``models/convert.py`` carries trees across
(``hybrid_params_from_numpy`` gives one rank its shard of the
reference's tree, ``hybrid_params_to_numpy`` gathers every rank's shards
back).

Attention runs through ``sdpa``'s unmasked route: the K1 flash forward
and K2 backward CUDA kernels on the card, their plain versions on the
CPU.  ``remat=True`` is ``torch.utils.checkpoint`` per layer, so the
forward of every layer runs twice per step (K1 launches 2·L times).
``remat="attn"`` checkpoints each layer but keeps the attention's output
and its log-sum-exp (the reference saves ``"attn_out"``): the recompute
takes them from the first forward instead of launching K1 again, so K1
launches L times per step and K2 reads the saved lse.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .. import resolve_device
from ..distributed import collective as C
from ..distributed import mp_ops
from ..distributed.mesh import ProcessMesh
from ..distributed.pipeline_schedules import pipeline_1f1b
from ..distributed.pipelining import spmd_pipeline
from ..ops.pallas import flash_attention as FA
from ..ops.pallas.flash_attention import sdpa
from .llama import LlamaConfig, _rms, _rope_tables, apply_rotary_pos_emb

__all__ = ["AdamWState", "build_mesh", "build_train_step", "default_axes",
           "grad_1f1b", "init_adamw", "init_params", "loss_fn",
           "param_shardings", "rank_layers", "setup", "tree_leaves",
           "tree_map", "value_and_grad", "zero1_shardings"]

_LAYER_KEYS = ("input_ln", "q", "k", "v", "o", "post_ln", "gate", "up",
               "down")
# the dim of each leaf split over tp (None: every tp rank holds it whole):
# column-parallel q/k/v/gate/up, row-parallel o/down, the embedding by
# hidden and the head by vocabulary (reference param_shardings)
TP_DIM = {"embed": 1, "norm": None, "head": 1, "input_ln": None, "q": 1,
          "k": 1, "v": 1, "o": 0, "post_ln": None, "gate": 1, "up": 1,
          "down": 0}
# [B, S, V] f32 logits up to this many bytes take one wide head matmul;
# above it the CE runs in sequence chunks (reference ``:274``)
_CE_ONE_SHOT_BYTES = 1.1e9


# ------------------------------------------------------------ param trees
def tree_leaves(tree) -> list:
    """The tree's tensors in a fixed order: embed, layer by layer in
    ``_LAYER_KEYS`` order, norm, head."""
    out = [tree["embed"]]
    for lp in tree["stages"]:
        out.extend(lp[k] for k in _LAYER_KEYS)
    out += [tree["norm"], tree["head"]]
    return out


def _unflatten(like, leaves) -> dict:
    it = iter(leaves)
    tree = {"embed": next(it),
            "stages": [{k: next(it) for k in _LAYER_KEYS}
                       for _ in like["stages"]]}
    tree["norm"] = next(it)
    tree["head"] = next(it)
    return tree


def tree_map(fn, tree) -> dict:
    """A tree like ``tree`` holding ``fn`` of each tensor."""
    return _unflatten(tree, [fn(t) for t in tree_leaves(tree)])


# ------------------------------------------------------------------ mesh
def build_mesh(n_devices=None, pp=1, dp=1, tp=1) -> ProcessMesh:
    """A ('pp', 'dp', 'tp') mesh over ranks 0 .. n-1 of the initialised
    ``torch.distributed`` world, rank = (p·dp + d)·tp + t (the
    reference's device grid, reshaped).  The axis sizes must multiply to
    n, the world's size by default."""
    import torch.distributed as dist
    world = dist.get_world_size() if dist.is_initialized() else 1
    n = n_devices or world
    if pp * dp * tp != n:
        raise ValueError(f"pp {pp} x dp {dp} x tp {tp} != {n} ranks")
    if n > world:
        raise ValueError(f"a mesh of {n} ranks needs a world of {n} "
                         f"processes (init_parallel_env), got {world}")
    return ProcessMesh(np.arange(n).reshape(pp, dp, tp), ["pp", "dp", "tp"])


def default_axes(n):
    """Factorize n into the most BALANCED (pp, dp, tp) triple — every
    axis exercised when possible (8 -> 2x2x2, 64 -> 4x4x4)."""
    pp = max(d for d in range(1, int(round(n ** (1 / 3))) + 1)
             if n % d == 0)
    rem = n // pp
    tp = max(d for d in range(1, int(rem ** 0.5) + 1) if rem % d == 0)
    return pp, rem // tp, tp


class Layout(NamedTuple):
    """Where a rank sits: the axis sizes, its coordinates and its groups
    (None where an axis has one rank, or with no mesh)."""
    pp: int
    dp: int
    tp: int
    p: int
    d: int
    t: int
    pp_group: object
    dp_group: object
    tp_group: object


def layout(mesh, rank=None) -> Layout:
    """The :class:`Layout` of ``rank`` (default: this process) on
    ``mesh``: None (one device), a mapping of axis sizes whose every
    size is 1, or a ('pp', 'dp', 'tp') :class:`ProcessMesh`."""
    if mesh is None:
        return Layout(1, 1, 1, 0, 0, 0, None, None, None)
    if not isinstance(mesh, ProcessMesh):
        sizes = tuple(int(mesh.get(a, 1)) for a in ("pp", "dp", "tp"))
        if sizes != (1, 1, 1):
            raise ValueError(
                f"a mesh of pp={sizes[0]}, dp={sizes[1]}, tp={sizes[2]} is "
                "a ProcessMesh of processes: build_mesh(...) after "
                "distributed.init_parallel_env()")
        return Layout(1, 1, 1, 0, 0, 0, None, None, None)
    if mesh.dim_names != ["pp", "dp", "tp"]:
        raise ValueError(f"a hybrid mesh has axes ('pp', 'dp', 'tp'), got "
                         f"{mesh.dim_names}")
    import torch.distributed as dist
    me = dist.get_rank() if dist.is_initialized() else 0
    rank = me if rank is None else rank
    pp, dp, tp = mesh.shape
    at = mesh.coords(rank)
    # groups only for this process's own place (another rank's coordinates
    # serve to cut its shard, e.g. in a process that converts trees)
    groups = [mesh.group(a) if n > 1 and rank == me else None
              for a, n in zip(("pp", "dp", "tp"), (pp, dp, tp))]
    return Layout(pp, dp, tp, at["pp"], at["dp"], at["tp"], *groups)


def rank_layers(n_layers, pp, p, n_virtual=1):
    """The global layers pipeline stage ``p`` holds, chunk by chunk:
    chunk c is virtual stage c·pp + p (reference interleaved ownership,
    ``init_params`` ``:73-74``)."""
    sv = pp * n_virtual
    if n_layers % sv:
        raise ValueError(f"{n_layers} layers do not split into pp {pp} x "
                         f"n_virtual {n_virtual} stages")
    lps = n_layers // sv
    return [(c * pp + p) * lps + i for c in range(n_virtual)
            for i in range(lps)]


def shard(t, key, tp, ti):
    """Rank ``ti``'s part of leaf ``key`` under tp (``TP_DIM``), as an
    owned contiguous tensor."""
    dim = TP_DIM[key]
    if dim is None or tp == 1:
        return t
    n = t.shape[dim]
    if n % tp:
        raise ValueError(f"{key} {tuple(t.shape)}: dim {dim} does not "
                         f"split over tp {tp}")
    return t.narrow(dim, ti * (n // tp), n // tp).clone(
        memory_format=torch.contiguous_format)


def _check_config(config: LlamaConfig, tp):
    for name, n in (("num_attention_heads", config.num_attention_heads),
                    ("num_key_value_heads", config.num_key_value_heads),
                    ("intermediate_size", config.intermediate_size),
                    ("vocab_size", config.vocab_size),
                    ("hidden_size", config.hidden_size)):
        if n % tp:
            raise ValueError(f"{name} {n} does not split over tp {tp}")


def param_shardings(mesh=None, n_virtual: int = 1):
    """The tp rule, as the reference's PartitionSpecs name it, per leaf
    of one layer (the stage axes of the reference's stacked leaves are
    the rank's list of layers here, :func:`rank_layers`)."""
    spec = {k: (None,) if d is None else
            ((None, "tp") if d == 1 else ("tp", None))
            for k, d in TP_DIM.items()}
    return {"embed": spec["embed"],
            "stages": {k: spec[k] for k in _LAYER_KEYS},
            "norm": spec["norm"], "head": spec["head"]}


# ------------------------------------------------------------ parameters
def init_params(config: LlamaConfig, generator: torch.Generator,
                device=None, dtype=torch.float32, mesh=None, n_virtual=1,
                rank=None) -> dict:
    """Random params with the reference's init scales: matrices
    N(0, 1/fan_in), embedding N(0, 0.02^2), head N(0, 1/hidden), norms
    ones.  Made on ``device`` (default CUDA) from ``generator``, which
    must live on that device's type.  With a ``mesh``, the tree holds
    ``rank``'s shard (default this process's) of the one global init:
    every rank draws every leaf in the same order and keeps its part, so
    the shards of all meshes come from the same numbers."""
    dev = resolve_device(device)
    lay = layout(mesh, rank)
    _check_config(config, lay.tp)
    h, i = config.hidden_size, config.intermediate_size
    hd, nh, kvh = (config.head_dim, config.num_attention_heads,
                   config.num_key_value_heads)
    mine = rank_layers(config.num_hidden_layers, lay.pp, lay.p, n_virtual)

    def normal(key, *shape, std):
        t = torch.empty(shape, dtype=torch.float32, device=dev)
        t.normal_(0.0, std, generator=generator)
        return shard(t, key, lay.tp, lay.t).to(dtype)

    def ones(n):
        return torch.ones(n, dtype=dtype, device=dev)

    layers = {}
    for li in range(config.num_hidden_layers):
        lp = {
            "input_ln": ones(h),
            "q": normal("q", h, nh * hd, std=1 / math.sqrt(h)),
            "k": normal("k", h, kvh * hd, std=1 / math.sqrt(h)),
            "v": normal("v", h, kvh * hd, std=1 / math.sqrt(h)),
            "o": normal("o", nh * hd, h, std=1 / math.sqrt(nh * hd)),
            "post_ln": ones(h),
            "gate": normal("gate", h, i, std=1 / math.sqrt(h)),
            "up": normal("up", h, i, std=1 / math.sqrt(h)),
            "down": normal("down", i, h, std=1 / math.sqrt(i)),
        }
        if li in mine:
            layers[li] = lp
    return {"embed": normal("embed", config.vocab_size, h, std=0.02),
            "stages": [layers[li] for li in mine], "norm": ones(h),
            "head": normal("head", h, config.vocab_size,
                           std=1 / math.sqrt(h))}


# ------------------------------------------------------------- layer math
class _KeptAttention(torch.autograd.Function):
    """Causal flash attention ([B, H, S, D] views) whose output and lse
    are kept in ``store`` by the first forward: the checkpoint's
    recompute finds them there and launches no K1; the backward is K2 on
    the recomputed q, k, v and the kept out and lse."""

    @staticmethod
    def forward(ctx, q, k, v, store):
        scale = 1.0 / math.sqrt(q.shape[-1])
        if "out" in store:
            out, lse = store["out"].detach(), store["lse"]
        else:
            out, lse = FA._flash_fwd(q, k, v, True, scale)
            store["out"], store["lse"] = out.detach(), lse
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = FA._flash_bwd(q, k, v, out, lse, dout, True, ctx.scale)
        return dq, dk, dv, None


def _attention(q, k, v, store):
    """[B, S, H, D] causal attention: ``sdpa``'s unmasked route, or, with
    a ``store`` (remat="attn"), :class:`_KeptAttention`."""
    if store is None:
        return sdpa(q, k, v, is_causal=True)
    out = _KeptAttention.apply(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), store)
    return out.transpose(1, 2)


def _enter(h, tp_group, sp):
    """Before a column-parallel matmul: the sequence gathered under sp,
    else Megatron's f (identity forward, all-reduced gradient)."""
    if tp_group is None:
        return h
    return mp_ops.sp_gather(h, tp_group, 1) if sp else \
        mp_ops.copy_to(h, tp_group)


def _leave(o, tp_group, sp):
    """After a row-parallel matmul: summed over tp, and scattered by
    sequence under sp."""
    if tp_group is None:
        return o
    return mp_ops.sp_scatter(o, tp_group, 1) if sp else \
        mp_ops.reduce_from(o, tp_group)


def _decoder_layer(lp, x, cos, sin, config: LlamaConfig, tp_group=None,
                   sp=False, store=None):
    """One decoder layer. x: [mb, S, H] ([mb, S / tp, H] under sp); the
    rank's nh/tp query and kvh/tp kv heads."""
    tpn = 1 if tp_group is None else tp_group.nranks
    nh, kvh, hd = (config.num_attention_heads // tpn,
                   config.num_key_value_heads // tpn, config.head_dim)
    r = x
    h = _enter(_rms(x, lp["input_ln"], config.rms_norm_eps), tp_group, sp)
    b, sq, _ = h.shape
    q = (h @ lp["q"]).reshape(b, sq, nh, hd)
    k = (h @ lp["k"]).reshape(b, sq, kvh, hd)
    v = (h @ lp["v"]).reshape(b, sq, kvh, hd)
    q, k = apply_rotary_pos_emb(q, k, cos, sin)
    a = _attention(q, k, v, store)
    x = r + _leave(a.reshape(b, sq, nh * hd) @ lp["o"], tp_group, sp)
    r = x
    h = _enter(_rms(x, lp["post_ln"], config.rms_norm_eps), tp_group, sp)
    ff = F.silu(h @ lp["gate"]) * (h @ lp["up"])
    return r + _leave(ff @ lp["down"], tp_group, sp)


def _stage_fn(stage_params, x, cos, sin, config, remat=True, tp_group=None,
              sp=False):
    """Apply the layers of ``stage_params`` (a list of per-layer dicts).
    remat: True = checkpoint every layer (its forward runs again in the
    backward pass); "attn" = checkpoint every layer but keep its
    attention output and lse (K1 runs once per layer); False = keep
    every activation."""
    for lp in stage_params:
        if remat == "attn":
            x = checkpoint(_decoder_layer, lp, x, cos, sin, config,
                           tp_group, sp, {}, use_reentrant=False)
        elif remat:
            x = checkpoint(_decoder_layer, lp, x, cos, sin, config,
                           tp_group, sp, None, use_reentrant=False)
        else:
            x = _decoder_layer(lp, x, cos, sin, config, tp_group, sp)
    return x


def _embed(embed, ids, tp_group, sp):
    """Token embeddings from a hidden-split table, gathered over tp; the
    rank's 1/tp of the sequence under sp."""
    x = F.embedding(ids, embed)
    if tp_group is None:
        return x
    x = mp_ops.gather_from(x, tp_group, -1)
    return mp_ops.scatter_to(x, tp_group, 1) if sp else x


def _head_ce_sum(norm, head, y, lab, config, tp_group, sp):
    """Summed next-token CE of the trunk's output ``y``: the sequence
    gathered under sp, the final norm, then the vocabulary-parallel CE
    over the rank's columns of the head."""
    if tp_group is not None and sp:
        y = mp_ops.gather_from(y, tp_group, 1)
    h = _rms(y, norm, config.rms_norm_eps)
    if tp_group is not None:
        h = mp_ops.copy_to(h, tp_group)
    return _chunked_ce_sum(h, lab, head, tp_group)


def _ce_chunk(hc, lc, head, tp_group=None):
    logits = (hc @ head).float()
    if tp_group is not None:
        return mp_ops.vocab_parallel_ce(
            logits.reshape(-1, logits.shape[-1]), lc.reshape(-1),
            tp_group).sum()
    lse = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(-1, lc[..., None])[..., 0]
    return (lse - tgt).sum()


def _chunked_ce_sum(h, lab, head, tp_group=None):
    """Summed next-token CE: one wide head matmul while the f32 logits
    (of the whole vocabulary) stay under ``_CE_ONE_SHOT_BYTES``, else
    sequence chunks whose logits are recomputed in the backward pass
    (checkpoint), so the full [B, S, V] f32 logits never exist."""
    b, s = lab.shape
    tpn = 1 if tp_group is None else tp_group.nranks
    if b * s * head.shape[-1] * tpn * 4 <= _CE_ONE_SHOT_BYTES:
        return _ce_chunk(h.reshape(b * s, -1), lab.reshape(b * s), head,
                         tp_group)
    n_chunks = next(c for c in (8, 7, 6, 5, 4, 3, 2, 1) if s % c == 0)
    cs = s // n_chunks
    total = None
    for c in range(n_chunks):
        part = checkpoint(_ce_chunk, h[:, c * cs:(c + 1) * cs],
                          lab[:, c * cs:(c + 1) * cs], head, tp_group,
                          use_reentrant=False)
        total = part if total is None else total + part
    return total


# ------------------------------------------------------------- loss
def _sp_on(lay: Layout, sp, s):
    return bool(sp) and lay.tp > 1 and s % lay.tp == 0


def _dp_rows(ids, lay: Layout):
    """This dp rank's rows of the global batch."""
    b = ids.shape[0]
    if b % lay.dp:
        raise ValueError(f"batch {b} does not split over dp {lay.dp}")
    n = b // lay.dp
    return ids[lay.d * n:(lay.d + 1) * n]


def _local_loss(params, ids, config, lay: Layout, n_micro, remat, sp,
                n_tokens):
    """pp = 1: this rank's part of the loss over its rows ``ids``
    [b, S+1], summed CE over ``n_tokens`` (the global batch's)."""
    inp, lab = ids[:, :-1], ids[:, 1:]
    b, s = inp.shape
    if b % n_micro:
        raise ValueError(f"batch {b} does not split into {n_micro} "
                         "micro-batches")
    sp_on = _sp_on(lay, sp, s)
    x = _embed(params["embed"], inp, lay.tp_group, sp_on)
    cos, sin = _rope_tables(s, config.head_dim, config.rope_theta,
                            device=x.device)
    h = _stage_fn(params["stages"], x, cos, sin, config, remat, lay.tp_group,
                  sp_on)
    return _head_ce_sum(params["norm"], params["head"], h, lab, config,
                        lay.tp_group, sp_on) / n_tokens


def loss_fn(params, ids, config: LlamaConfig, mesh=None, n_micro=1,
            remat=True, sp=True):
    """Mean next-token CE over a [B, S+1] int64 token batch, as this
    rank computes it at pp = 1 (the reference runs the n_micro
    micro-batches as one vmapped batch, which is the whole batch at
    once).  With dp > 1 it is this rank's rows' part of the global mean
    (the dp all-reduce of :func:`value_and_grad` sums the parts).  A
    pipeline's loss is not one process's function: at pp > 1 use
    :func:`value_and_grad` or :func:`build_train_step`."""
    lay = layout(mesh)
    if lay.pp > 1:
        raise ValueError("loss_fn runs one pipeline stage's whole trunk; "
                         "at pp > 1 use value_and_grad")
    ids = _dp_rows(ids, lay)
    return _local_loss(params, ids, config, lay, n_micro, remat, sp,
                       ids.shape[0] * lay.dp * (ids.shape[1] - 1))


def _ln_grads_over_tp(grads, lay: Layout):
    """Under sp every tp rank normalised its own part of the sequence:
    the layer norms' gradients are summed over tp."""
    for lp in grads["stages"]:
        for key in ("input_ln", "post_ln"):
            C.all_reduce(lp[key], group=lay.tp_group)


def _pipelined(params, ids, config, lay: Layout, n_micro, remat, sp,
               n_tokens, schedule, n_virtual):
    """pp > 1: this stage's (loss, grads) of its dp rows ``ids`` through
    the GPipe, 1F1B or zero-bubble executor; the loss and the embedding,
    norm and head gradients come back summed over pp."""
    b, s = ids.shape[0], ids.shape[1] - 1
    if b % n_micro:
        raise ValueError(f"batch {b} does not split into {n_micro} "
                         "micro-batches")
    mb = b // n_micro
    # the reference honours sp in the GPipe schedule only (:305-311)
    sp_on = _sp_on(lay, sp, s) and schedule == "gpipe"
    cos, sin = _rope_tables(s, config.head_dim, config.rope_theta,
                            device=ids.device)
    inv_tok = 1.0 / n_tokens
    tpg = lay.tp_group
    lps = len(params["stages"]) // n_virtual
    chunks = [params["stages"][c * lps:(c + 1) * lps]
              for c in range(n_virtual)]
    first = {"embed": params["embed"]}
    last = {"norm": params["norm"], "head": params["head"]}

    def first_fn(fp, aux_j):
        return _embed(fp["embed"], aux_j[:, :-1], tpg, sp_on)

    def stage_fn(cp, x):
        return _stage_fn(cp, x, cos, sin, config, remat, tpg, sp_on)

    def last_fn(lp, y, aux_j):
        return _head_ce_sum(lp["norm"], lp["head"], y, aux_j[:, 1:], config,
                            tpg, sp_on) * inv_tok

    aux = list(ids.reshape(n_micro, mb, s + 1))
    act = ((mb, s // lay.tp if sp_on else s, config.hidden_size),
           params["embed"].dtype)
    if schedule == "gpipe":
        loss, d_stage, d_first, d_last = spmd_pipeline(
            stage_fn, first_fn, last_fn, chunks, first, last, aux,
            lay.pp_group, *act)
    else:
        loss, d_stage, d_first, d_last = pipeline_1f1b(
            stage_fn, first_fn, last_fn, chunks, first, last, aux,
            lay.pp_group, *act, n_virtual=n_virtual,
            zero_bubble=schedule == "zb")
    grads = {"embed": d_first["embed"],
             "stages": [lp for chunk in d_stage for lp in chunk],
             "norm": d_last["norm"], "head": d_last["head"]}
    if sp_on:
        _ln_grads_over_tp(grads, lay)
    return loss, grads


def _local_value_and_grad(params, ids, config, lay: Layout, n_micro, remat,
                          sp, n_tokens, schedule="gpipe", n_virtual=1):
    """(loss, grads) of this rank's dp rows ``ids``, before the dp
    reduction: the loss part and the gradient part those rows give."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    tree = _unflatten(params, leaves)
    with torch.enable_grad():
        if lay.pp > 1:
            loss, grads = _pipelined(tree, ids, config, lay, n_micro, remat,
                                     sp, n_tokens, schedule, n_virtual)
            return loss.detach(), grads
        loss = _local_loss(tree, ids, config, lay, n_micro, remat, sp,
                           n_tokens)
        grads = _unflatten(params, torch.autograd.grad(loss, leaves))
    if _sp_on(lay, sp, ids.shape[1] - 1):
        _ln_grads_over_tp(grads, lay)
    return loss.detach(), grads


def value_and_grad(params, ids, config: LlamaConfig, mesh=None, n_micro=1,
                   remat=True, sp=True, schedule="gpipe", n_virtual=1):
    """(loss, grads) of the global [B, S+1] batch ``ids`` on this rank:
    the loss of :func:`loss_fn` (whole on every rank) and the gradient of
    this rank's shard of every leaf, summed over dp, in the params'
    dtype.  params themselves are left as they are."""
    lay = layout(mesh)
    local = _dp_rows(ids, lay)
    loss, grads = _local_value_and_grad(
        params, local, config, lay, n_micro, remat, sp,
        ids.shape[0] * (ids.shape[1] - 1), schedule, n_virtual)
    if lay.dp > 1:
        C.all_reduce(loss, group=lay.dp_group)
        for g in tree_leaves(grads):
            C.all_reduce(g, group=lay.dp_group)
    return loss, grads


def grad_1f1b(params, ids, config: LlamaConfig, mesh, n_micro, n_virtual=1,
              remat=True, sp=True, zero_bubble=False):
    """(loss, grads) through the hand-scheduled 1F1B / interleaved /
    zero-bubble pipeline (reference ``:286``): embedding at stage 0,
    final norm + head + CE at the last stage, every microbatch's
    backward as soon as its forward leaves the pipe.  ``sp`` is ignored,
    as in the reference."""
    return value_and_grad(params, ids, config, mesh, n_micro, remat, sp,
                          "zb" if zero_bubble else "1f1b", n_virtual)


# ------------------------------------------------------------- optimizer
class AdamWState(NamedTuple):
    step: int      # updates taken so far
    m: dict        # f32 first moments, a tree like params
    v: dict        # f32 second moments


def _f32_zeros_like(params) -> dict:
    """f32 buffers matching the param tree (optimizer state and grad
    accumulators share this dtype/shape contract)."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)


def zero1_sharded(numel, dp) -> bool:
    """Whether a leaf of ``numel`` elements has its AdamW state split
    over dp (the reference splits the first dp-divisible axis and keeps
    the rest whole; here the flat leaf, when dp divides it)."""
    return dp > 1 and numel % dp == 0


def zero1_shardings(params, mesh, n_virtual=1) -> dict:
    """ZeRO-1 (reference ``:462``, fleet's sharding stage 1): for each
    leaf of this rank's tree, the (offset, length) of the flat elements
    whose float32 m and v this dp rank keeps, or None where the leaf's
    state stays whole (dp does not divide it)."""
    lay = layout(mesh)

    def one(p):
        n = p.numel()
        if not zero1_sharded(n, lay.dp):
            return None
        return (lay.d * (n // lay.dp), n // lay.dp)
    return _unflatten(params, [one(p) for p in tree_leaves(params)])


def init_adamw(params, mesh=None, zero1=False) -> AdamWState:
    """Zero AdamW state; under ``zero1`` each sharded leaf's m and v are
    this dp rank's flat part (:func:`zero1_shardings`)."""
    if not zero1:
        return AdamWState(0, _f32_zeros_like(params),
                          _f32_zeros_like(params))
    spans = tree_leaves(zero1_shardings(params, mesh))

    def zeros():
        return _unflatten(params, [
            torch.zeros(p.shape if span is None else (span[1],),
                        dtype=torch.float32, device=p.device)
            for p, span in zip(tree_leaves(params), spans)])
    return AdamWState(0, zeros(), zeros())


def build_train_step(config: LlamaConfig, mesh=None, lr=3e-4, wd=0.01,
                     n_micro=1, remat=True, sp=True, b1=0.9, b2=0.95,
                     eps=1e-8, grad_accum=1, schedule="gpipe", n_virtual=1,
                     zero1=False, device=None):
    """Returns ``step(params, opt, ids) -> (loss, params, opt)`` on
    ``device`` (default CUDA; raises with no card), for this rank of
    ``mesh`` (None: one device).

    ``ids`` is the global [B, S+1] token batch (numpy or tensor), the
    same on every rank; each dp rank takes its 1/dp of the rows.
    schedule: "gpipe" (AD-equivalent fill-drain), "1f1b" or "zb"
    (1F1B with the ZB-H1 deferred weight gradients); n_virtual > 1 is
    the interleaved schedule and needs "1f1b" or "zb" and pp > 1, as in
    the reference; the 1F1B schedules fall back to GPipe's at pp = 1,
    as the reference's do.  grad_accum > 1 splits the batch into
    sequential chunks and averages their grads in f32 before one AdamW
    update.  The update follows the reference's ``upd`` (``:411-433``):
    f32 m and v, bias correction with the step counted from 1, decoupled
    weight decay on the f32 param, then the cast back to the param
    dtype.  params and opt are updated in place and returned (the
    reference donates them), so a step holds no second copy of the model
    or of the optimizer state."""
    dev = resolve_device(device)
    lay = layout(mesh)
    _check_config(config, lay.tp)
    rank_layers(config.num_hidden_layers, lay.pp, lay.p, n_virtual)
    if schedule not in ("gpipe", "1f1b", "zb"):
        raise ValueError(f"schedule must be 'gpipe', '1f1b' or 'zb', got "
                         f"{schedule!r}")
    use_1f1b = schedule in ("1f1b", "zb") and lay.pp > 1
    if n_virtual > 1 and not use_1f1b:
        raise ValueError(
            "n_virtual > 1 (interleaved/VPP) requires schedule='1f1b' "
            f"or 'zb' and a pp axis > 1; got schedule={schedule!r}, "
            f"pp={lay.pp}")
    sched = schedule if use_1f1b else "gpipe"

    def grad_of(params, ids):
        b, s = ids.shape[0], ids.shape[1] - 1
        if b % grad_accum:
            raise ValueError(f"batch {b} does not split into {grad_accum} "
                             "accumulation chunks")
        n_tokens = b // grad_accum * lay.dp * s
        if grad_accum == 1:
            return _local_value_and_grad(params, ids, config, lay, n_micro,
                                         remat, sp, n_tokens, sched,
                                         n_virtual)
        lsum = torch.zeros((), dtype=torch.float32, device=dev)
        gsum = _f32_zeros_like(params)
        for chunk in ids.reshape(grad_accum, b // grad_accum, -1):
            loss, grads = _local_value_and_grad(
                params, chunk, config, lay, n_micro, remat, sp, n_tokens,
                sched, n_virtual)
            lsum = lsum + loss
            for acc, g in zip(tree_leaves(gsum), tree_leaves(grads)):
                acc.add_(g.float())
            del grads
        inv = 1.0 / grad_accum
        return lsum * inv, tree_map(lambda g: g.mul_(inv), gsum)

    def reduced(grads):
        """Each leaf's gradient summed over dp: whole, or, for a ZeRO-1
        leaf, this rank's flat part of the sum."""
        out = []
        for g in tree_leaves(grads):
            if lay.dp == 1:
                out.append(g)
            elif zero1 and zero1_sharded(g.numel(), lay.dp):
                out.append(C.reduce_scatter(None, g.reshape(-1),
                                            group=lay.dp_group))
            else:
                out.append(C.all_reduce(g, group=lay.dp_group))
        return out

    def step(params, opt: AdamWState, ids):
        ids = torch.as_tensor(ids).to(device=dev, dtype=torch.long)
        loss, grads = grad_of(params, _dp_rows(ids, lay))
        if lay.dp > 1:
            C.all_reduce(loss, group=lay.dp_group)
        t = opt.step + 1
        # the bias corrections in f32, as the reference computes them
        bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(t))
        bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(t))
        with torch.no_grad():
            for p, g, m, v in zip(tree_leaves(params), reduced(grads),
                                  tree_leaves(opt.m), tree_leaves(opt.v)):
                gf = g.float()
                m.mul_(b1).add_((1 - b1) * gf)
                v.mul_(b2).add_((1 - b2) * gf.square())
                part = p if m.shape == p.shape else \
                    p.view(-1).narrow(0, lay.d * m.numel(), m.numel())
                pf = part.float()
                pf = pf - lr * ((m / bc1) / ((v / bc2).sqrt() + eps)
                                + wd * pf)
                if part is p:
                    p.copy_(pf)
                else:       # ZeRO-1: every dp rank's part, gathered back
                    p.view(-1).copy_(C.all_gather(None, pf.to(p.dtype),
                                                  group=lay.dp_group))
        return loss, params, AdamWState(t, opt.m, opt.v)

    return step


def setup(config: LlamaConfig, seed=0, dtype=torch.float32, device=None,
          mesh=None, n_virtual=1, zero1=False):
    """Random params from ``seed`` (this rank's shard of them, with a
    ``mesh``) and a fresh AdamW state, on ``device`` (default CUDA).
    zero1=True keeps only this dp rank's part of m and v (pair with
    ``build_train_step(zero1=True)``)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = init_params(config, gen, dev, dtype, mesh, n_virtual)
    return params, init_adamw(params, mesh, zero1)
