"""Single-device Llama pretraining step (pp = dp = tp = 1), in PyTorch.

Ports the pp=dp=tp=1 slice of ``paddle_tpu/models/llama_hybrid.py``:
``init_params`` (``:69``), ``_rms`` (``:124``), ``_decoder_layer``
(``:130``), ``_stage_fn`` (``:160``), ``loss_fn`` (``:233``),
``_chunked_ce_sum`` (``:259``), ``AdamWState``/``init_adamw``/
``_f32_zeros_like`` and ``build_train_step`` (``:335-459``), and
``setup``.

The param tree keeps the reference's keys ``{"embed", "stages", "norm",
"head"}`` with ``[in, out]`` weights, but ``stages`` is a list of one
dict per layer (keys ``_LAYER_KEYS``) instead of one stacked ``[1, L,
...]`` leaf per weight: indexing a stacked leaf per layer would make
autograd allocate a full-size zero gradient for every ``w[i]``.
``models/convert.py`` carries trees across (``hybrid_params_from_numpy``
and its inverse).

Attention runs through ``sdpa``'s unmasked route: the K1 flash forward
and K2 backward CUDA kernels on the card, their plain versions on the
CPU.  Remat (``remat=True``) is ``torch.utils.checkpoint`` per layer,
so the forward of every layer runs twice per step.

Left out (each raises ``NotImplementedError``): ``remat="attn"``,
``schedule`` other than ``"gpipe"`` (1F1B, zero bubble), ``n_virtual >
1``, ``zero1`` and any mesh with pp, dp or tp above 1 (ROADMAP queue 1
item 8; ``remat="attn"`` is item 2's leftover).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .. import resolve_device
from ..ops.pallas.flash_attention import sdpa
from .llama import LlamaConfig, _rms, _rope_tables, apply_rotary_pos_emb

__all__ = ["AdamWState", "build_train_step", "init_adamw", "init_params",
           "loss_fn", "setup", "tree_leaves", "tree_map", "value_and_grad"]

_LAYER_KEYS = ("input_ln", "q", "k", "v", "o", "post_ln", "gate", "up",
               "down")
# [B, S, V] f32 logits up to this many bytes take one wide head matmul;
# above it the CE runs in sequence chunks (reference ``:274``)
_CE_ONE_SHOT_BYTES = 1.1e9
_LATER = "is not ported yet (ROADMAP queue 1 item 8: hybrid-parallel training)"
_REMAT_ATTN = ("remat='attn' (keep the attention outputs, recompute the "
               "rest) is not ported yet (ROADMAP queue 1 item 2, left out); "
               "use remat=True or False")


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


def _check_single_device(mesh):
    """``mesh``: None or a mapping of axis sizes ({"pp": 2, ...}); only
    pp = dp = tp = 1 is ported."""
    pp, dp, tp = (1, 1, 1) if mesh is None else (
        int(mesh.get(a, 1)) for a in ("pp", "dp", "tp"))
    if (pp, dp, tp) != (1, 1, 1):
        raise NotImplementedError(
            f"a mesh with pp={pp}, dp={dp}, tp={tp} {_LATER}; the port "
            "trains on one device")


# ------------------------------------------------------------ parameters
def init_params(config: LlamaConfig, generator: torch.Generator,
                device=None, dtype=torch.float32) -> dict:
    """Random params with the reference's init scales: matrices
    N(0, 1/fan_in), embedding N(0, 0.02^2), head N(0, 1/hidden), norms
    ones.  Made on ``device`` (default CUDA) from ``generator``, which
    must live on that device's type."""
    dev = resolve_device(device)
    h, i = config.hidden_size, config.intermediate_size
    hd, nh, kvh = (config.head_dim, config.num_attention_heads,
                   config.num_key_value_heads)

    def normal(*shape, std):
        t = torch.empty(shape, dtype=torch.float32, device=dev)
        t.normal_(0.0, std, generator=generator)
        return t.to(dtype)

    def ones(n):
        return torch.ones(n, dtype=dtype, device=dev)

    stages = [{
        "input_ln": ones(h),
        "q": normal(h, nh * hd, std=1 / math.sqrt(h)),
        "k": normal(h, kvh * hd, std=1 / math.sqrt(h)),
        "v": normal(h, kvh * hd, std=1 / math.sqrt(h)),
        "o": normal(nh * hd, h, std=1 / math.sqrt(nh * hd)),
        "post_ln": ones(h),
        "gate": normal(h, i, std=1 / math.sqrt(h)),
        "up": normal(h, i, std=1 / math.sqrt(h)),
        "down": normal(i, h, std=1 / math.sqrt(i)),
    } for _ in range(config.num_hidden_layers)]
    return {"embed": normal(config.vocab_size, h, std=0.02),
            "stages": stages, "norm": ones(h),
            "head": normal(h, config.vocab_size, std=1 / math.sqrt(h))}


# ------------------------------------------------------------- layer math
def _decoder_layer(lp, x, cos, sin, config: LlamaConfig):
    """One decoder layer. x: [mb, S, H]."""
    nh, kvh, hd = (config.num_attention_heads, config.num_key_value_heads,
                   config.head_dim)
    b, sq, _ = x.shape
    r = x
    h = _rms(x, lp["input_ln"], config.rms_norm_eps)
    q = (h @ lp["q"]).reshape(b, sq, nh, hd)
    k = (h @ lp["k"]).reshape(b, sq, kvh, hd)
    v = (h @ lp["v"]).reshape(b, sq, kvh, hd)
    q, k = apply_rotary_pos_emb(q, k, cos, sin)
    a = sdpa(q, k, v, is_causal=True)
    x = r + a.reshape(b, sq, nh * hd) @ lp["o"]
    r = x
    h = _rms(x, lp["post_ln"], config.rms_norm_eps)
    ff = F.silu(h @ lp["gate"]) * (h @ lp["up"])
    return r + ff @ lp["down"]


def _stage_fn(stage_params, x, cos, sin, config, remat=True):
    """Apply the layers of ``stage_params`` (a list of per-layer dicts).
    remat: True = checkpoint every layer (its forward runs again in the
    backward pass); False = keep every activation."""
    if remat == "attn":
        raise NotImplementedError(_REMAT_ATTN)
    for lp in stage_params:
        if remat:
            x = checkpoint(_decoder_layer, lp, x, cos, sin, config,
                           use_reentrant=False)
        else:
            x = _decoder_layer(lp, x, cos, sin, config)
    return x


# ------------------------------------------------------------- loss
def loss_fn(params, ids, config: LlamaConfig, mesh=None, n_micro=1,
            remat=True, sp=True):
    """Mean next-token CE over a [B, S+1] int64 token batch.  At pp=1
    the reference runs the n_micro micro-batches as one vmapped batch,
    which is the whole batch at once; ``sp`` only acts at tp > 1."""
    _check_single_device(mesh)
    inp, lab = ids[:, :-1], ids[:, 1:]
    b, s = inp.shape
    if b % n_micro:
        raise ValueError(f"batch {b} does not split into {n_micro} "
                         "micro-batches")
    x = F.embedding(inp, params["embed"])
    cos, sin = _rope_tables(s, config.head_dim, config.rope_theta,
                            device=x.device)
    h = _stage_fn(params["stages"], x, cos, sin, config, remat)
    h = _rms(h, params["norm"], config.rms_norm_eps)
    return _chunked_ce_sum(h, lab, params["head"]) / (b * s)


def _ce_chunk(hc, lc, head):
    logits = (hc @ head).float()
    lse = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(-1, lc[..., None])[..., 0]
    return (lse - tgt).sum()


def _chunked_ce_sum(h, lab, head):
    """Summed next-token CE: one wide head matmul while the f32 logits
    stay under ``_CE_ONE_SHOT_BYTES``, else sequence chunks whose logits
    are recomputed in the backward pass (checkpoint), so the full
    [B, S, V] f32 logits never exist."""
    b, s = lab.shape
    if b * s * head.shape[-1] * 4 <= _CE_ONE_SHOT_BYTES:
        return _ce_chunk(h.reshape(b * s, -1), lab.reshape(b * s), head)
    n_chunks = next(c for c in (8, 7, 6, 5, 4, 3, 2, 1) if s % c == 0)
    cs = s // n_chunks
    total = None
    for c in range(n_chunks):
        part = checkpoint(_ce_chunk, h[:, c * cs:(c + 1) * cs],
                          lab[:, c * cs:(c + 1) * cs], head,
                          use_reentrant=False)
        total = part if total is None else total + part
    return total


def value_and_grad(params, ids, config: LlamaConfig, mesh=None, n_micro=1,
                   remat=True, sp=True):
    """(loss, grads) of :func:`loss_fn`; grads is a tree like params, in
    the params' dtype.  params themselves are left as they are."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    with torch.enable_grad():
        loss = loss_fn(_unflatten(params, leaves), ids, config, mesh,
                       n_micro, remat, sp)
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), _unflatten(params, grads)


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


def init_adamw(params) -> AdamWState:
    return AdamWState(0, _f32_zeros_like(params), _f32_zeros_like(params))


def build_train_step(config: LlamaConfig, mesh=None, lr=3e-4, wd=0.01,
                     n_micro=1, remat=True, sp=True, b1=0.9, b2=0.95,
                     eps=1e-8, grad_accum=1, schedule="gpipe", n_virtual=1,
                     zero1=False, device=None):
    """Returns ``step(params, opt, ids) -> (loss, params, opt)`` on
    ``device`` (default CUDA; raises with no card).

    ``ids`` is a [B, S+1] token batch (numpy or tensor).  grad_accum > 1
    splits the batch into sequential chunks and averages their grads in
    f32 before one AdamW update.  The update follows the reference's
    ``upd`` (``:411-433``): f32 m and v, bias correction with the step
    counted from 1, decoupled weight decay on the f32 param, then the
    cast back to the param dtype.  params and opt are updated in place
    and returned (the reference donates them), so a step holds no second
    copy of the model or of the optimizer state."""
    dev = resolve_device(device)
    _check_single_device(mesh)
    if schedule != "gpipe":
        raise NotImplementedError(f"schedule={schedule!r} {_LATER}")
    if n_virtual != 1:
        raise NotImplementedError(f"n_virtual={n_virtual} (interleaved "
                                  f"pipeline) {_LATER}")
    if zero1:
        raise NotImplementedError(f"zero1 (sharded optimizer state) {_LATER}")
    if remat == "attn":
        raise NotImplementedError(_REMAT_ATTN)

    def grad_of(params, ids):
        if grad_accum == 1:
            return value_and_grad(params, ids, config, mesh, n_micro,
                                  remat, sp)
        b = ids.shape[0]
        if b % grad_accum:
            raise ValueError(f"batch {b} does not split into {grad_accum} "
                             "accumulation chunks")
        lsum = torch.zeros((), dtype=torch.float32, device=dev)
        gsum = _f32_zeros_like(params)
        for chunk in ids.reshape(grad_accum, b // grad_accum, -1):
            loss, grads = value_and_grad(params, chunk, config, mesh,
                                         n_micro, remat, sp)
            lsum = lsum + loss
            for acc, g in zip(tree_leaves(gsum), tree_leaves(grads)):
                acc.add_(g.float())
            del grads
        inv = 1.0 / grad_accum
        return lsum * inv, tree_map(lambda g: g.mul_(inv), gsum)

    def step(params, opt: AdamWState, ids):
        ids = torch.as_tensor(ids).to(device=dev, dtype=torch.long)
        loss, grads = grad_of(params, ids)
        t = opt.step + 1
        # the bias corrections in f32, as the reference computes them
        bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(t))
        bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(t))
        with torch.no_grad():
            for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                                  tree_leaves(opt.m), tree_leaves(opt.v)):
                gf = g.float()
                m.mul_(b1).add_((1 - b1) * gf)
                v.mul_(b2).add_((1 - b2) * gf.square())
                pf = p.float()
                pf = pf - lr * ((m / bc1) / ((v / bc2).sqrt() + eps)
                                + wd * pf)
                p.copy_(pf)
        return loss, params, AdamWState(t, opt.m, opt.v)

    return step


def setup(config: LlamaConfig, seed=0, dtype=torch.float32, device=None):
    """Random params from ``seed`` and a fresh AdamW state, on ``device``
    (default CUDA)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = init_params(config, gen, dev, dtype)
    return params, init_adamw(params)
