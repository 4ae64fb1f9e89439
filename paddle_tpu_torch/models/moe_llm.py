"""Mixture-of-Experts decoder LM with expert-parallel training, in
PyTorch.

Ports ``paddle_tpu/models/moe_llm.py``: ``MoEConfig`` and its presets
(``moe_tiny``, ``qwen2_moe_a14b``, ``deepseek_moe_16b``), ``build_mesh``
(``:96``), ``init_params`` (``:104``), ``param_shardings`` (``:145``),
``_layer`` (``:178``: fused q/k/v, rope, causal ``sdpa`` — the K1/K2
kernels on CUDA —, the MoE FFN on the ``"sort"`` dispatch of
``distributed.moe``, and the DeepSeekMoE / Qwen2-MoE shared experts),
``loss_fn`` (``:210``), ``build_train_step`` (``:244``, plain SGD) and
``setup`` (``:257``).

The reference is one SPMD program over a ('dp', 'ep') mesh; here each
rank of a ``ProcessMesh`` of (dp, ep) processes holds its own shard and
every collective is explicit:

* tokens: rank (d, j) takes dp row d of the global batch (the
  reference's ``P("dp", None, None)``); attention, the norms, the
  embedding and the head run on the row, replicated over ep, and each
  rank's gradient of those leaves is the row's;
* routed experts: rank (d, j) stores experts [j·E/ep, (j+1)·E/ep) of
  ``w1``/``b1``/``w2``/``b2`` (``P(None, "ep", ...)``);
  ``distributed.moe`` routes with the global capacity and drops and
  exchanges the capacity slots over the ep group;
* shared experts: Megatron column and row parallel over the ep group
  (``sw1`` ``P(None, None, "ep")``, ``sw2`` ``P(None, "ep", None)``):
  ``mp_ops.copy_to`` before ``sw1``, ``mp_ops.reduce_from`` after
  ``sw2``;
* dp: every leaf's gradient is summed over dp (the reference's psum of
  its dp-sharded batch); the loss is the reference's, CE summed over
  the global batch and divided by its B·S, plus ``aux_loss_weight`` x
  the router aux loss (a global mean) averaged over layers.

The param tree keeps the reference's keys ``{"embed", "layers", "norm",
"head"}`` with ``[in, out]`` weights, but ``layers`` is a list of one
dict per layer instead of one stacked ``[L, ...]`` leaf per key (so that
autograd makes no full-size zero gradient per ``w[i]``);
``models/convert.py`` carries trees across (``moe_params_from_numpy``,
by rank with a mesh, and its inverse).  The reference runs shallow
stacks unrolled and deep ones (L > 16) under ``lax.scan``: the same
math, one Python loop here.

The router weight ``gate`` stays float32 whatever the params' dtype, as
in the reference.  Like the reference's model, the layer takes the
``"sort"`` dispatch: the grouped FFN (K9) is reached through
``distributed.moe.moe_dispatch_combine(dispatch_mode="grouped")`` on one
device.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device
from ..distributed import collective as C
from ..distributed import mp_ops
from ..distributed.mesh import ProcessMesh
from ..distributed.moe import ep_layout, moe_dispatch_combine
from ..ops.pallas.flash_attention import sdpa
from .convert import _DTYPES
from .llama import _rms, _rope_tables, apply_rotary_pos_emb
from .llama_hybrid import _chunked_ce_sum

__all__ = ["EP_DIM", "MoEConfig", "build_mesh", "build_train_step",
           "deepseek_moe_16b", "init_params", "loss_fn", "moe_tiny",
           "param_shardings", "qwen2_moe_a14b", "setup", "shard",
           "tree_leaves", "tree_map", "value_and_grad"]

_LAYER_KEYS = ("input_ln", "q", "k", "v", "o", "post_ln", "gate", "w1", "b1",
               "w2", "b2")
_SHARED_KEYS = ("sw1", "sw2")
# the dim of each layer leaf split over ep (reference param_shardings
# :145-175, without the stacked L axis); every other leaf is whole
EP_DIM = {"w1": 0, "b1": 0, "w2": 0, "b2": 0, "sw1": 1, "sw2": 0}


@dataclass
class MoEConfig:
    vocab_size: int = 32000
    hidden_size: int = 1024
    moe_intermediate_size: int = 1408
    num_hidden_layers: int = 8
    num_attention_heads: int = 16
    num_key_value_heads: int = 16
    num_experts: int = 8
    top_k: int = 2
    num_shared_experts: int = 0     # DeepSeekMoE: always-on dense experts
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    dtype: str = "float32"

    @property
    def head_dim(self):
        return self.hidden_size // self.num_attention_heads


def moe_tiny(**kw) -> MoEConfig:
    cfg = dict(vocab_size=512, hidden_size=128, moe_intermediate_size=128,
               num_hidden_layers=2, num_attention_heads=4,
               num_key_value_heads=4, num_experts=4, top_k=2,
               max_position_embeddings=256)
    cfg.update(kw)
    return MoEConfig(**cfg)


def qwen2_moe_a14b() -> MoEConfig:
    """Qwen2-57B-A14B-shaped config; its shared expert is modelled as
    num_shared_experts * moe_intermediate_size, as in the reference."""
    return MoEConfig(
        vocab_size=151936, hidden_size=3584, moe_intermediate_size=2560,
        num_hidden_layers=28, num_attention_heads=28,
        num_key_value_heads=4, num_experts=64, top_k=8,
        num_shared_experts=8,
        max_position_embeddings=8192, dtype="bfloat16")


def deepseek_moe_16b() -> MoEConfig:
    """DeepSeekMoE-16B-shaped config: 64 fine-grained routed experts
    (top 6) plus 2 shared experts every token passes through."""
    return MoEConfig(
        vocab_size=102400, hidden_size=2048, moe_intermediate_size=1408,
        num_hidden_layers=28, num_attention_heads=16,
        num_key_value_heads=16, num_experts=64, top_k=6,
        num_shared_experts=2,
        max_position_embeddings=4096, dtype="bfloat16")


def build_mesh(n_devices=None, dp=1, ep=1, devices=None):
    """The port's mesh.  One device: the mapping ``{"dp": 1, "ep": 1}``.
    More: a ('dp', 'ep') ``ProcessMesh`` over ranks 0 .. n-1 of the
    initialised ``torch.distributed`` world, rank = d·ep + j (the
    reference's device grid, reshaped); dp x ep must be n."""
    n = n_devices or dp * ep
    if dp * ep != n:
        raise ValueError(f"dp {dp} x ep {ep} != {n} devices")
    if n == 1:
        return {"dp": 1, "ep": 1}
    import torch.distributed as dist
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n > world:
        raise ValueError(f"a mesh of {n} ranks needs a world of {n} "
                         f"processes (init_parallel_env), got {world}")
    return ProcessMesh(np.arange(n).reshape(dp, ep), ["dp", "ep"])


def layout(mesh):
    """This process's ``distributed.moe.EPLayout`` on ``mesh``; None at
    one device."""
    return ep_layout(mesh, "ep")[1]


def param_shardings(mesh=None, config=None, params=None):
    """The reference's sharding tree, as PartitionSpec tuples over its
    stacked ``[L, ...]`` leaves: routed experts over ep, the shared
    experts' inner dim over ep (with ``config.num_shared_experts`` or
    ``sw1`` in ``params``), every other leaf whole."""
    rep2, rep3 = (None, None), (None, None, None)
    layers = {k: rep3 for k in ("q", "k", "v", "o", "gate")}
    layers.update({"input_ln": rep2, "post_ln": rep2,
                   "w1": (None, "ep", None, None), "b1": (None, "ep", None),
                   "w2": (None, "ep", None, None), "b2": (None, "ep", None)})
    shared = (config is not None and config.num_shared_experts) or (
        params is not None and "sw1" in params["layers"][0])
    if shared:
        layers["sw1"] = (None, None, "ep")
        layers["sw2"] = (None, "ep", None)
    return {"embed": rep2, "layers": layers, "norm": (None,), "head": rep2}


def shard(t, key, ep, j):
    """Rank ``j``'s part over ep of layer leaf ``key`` (``EP_DIM``), as
    an owned contiguous tensor."""
    dim = EP_DIM.get(key)
    if dim is None or ep == 1:
        return t
    n = t.shape[dim]
    if n % ep:
        raise ValueError(f"{key} {tuple(t.shape)}: dim {dim} does not "
                         f"split over ep {ep}")
    return t.narrow(dim, j * (n // ep), n // ep).clone(
        memory_format=torch.contiguous_format)


def _check_config(config: MoEConfig, ep):
    f = config.moe_intermediate_size
    for name, n in (("num_experts", config.num_experts),
                    ("num_shared_experts * moe_intermediate_size",
                     config.num_shared_experts * f)):
        if n % ep:
            raise ValueError(f"{name} {n} does not split over ep {ep}")


# ------------------------------------------------------------ param trees
def _layer_keys(tree):
    return _LAYER_KEYS + (_SHARED_KEYS if "sw1" in tree["layers"][0] else ())


def tree_leaves(tree) -> list:
    """The tree's tensors in a fixed order: embed, layer by layer in
    ``_LAYER_KEYS`` order (then sw1, sw2), norm, head."""
    keys = _layer_keys(tree)
    out = [tree["embed"]]
    for lp in tree["layers"]:
        out.extend(lp[k] for k in keys)
    return out + [tree["norm"], tree["head"]]


def _unflatten(like, leaves) -> dict:
    keys = _layer_keys(like)
    it = iter(leaves)
    tree = {"embed": next(it),
            "layers": [{k: next(it) for k in keys} for _ in like["layers"]]}
    tree["norm"] = next(it)
    tree["head"] = next(it)
    return tree


def tree_map(fn, tree) -> dict:
    """A tree like ``tree`` holding ``fn`` of each tensor."""
    return _unflatten(tree, [fn(t) for t in tree_leaves(tree)])


# ------------------------------------------------------------ parameters
def init_params(config: MoEConfig, generator: torch.Generator, device=None,
                dtype=torch.float32, mesh=None) -> dict:
    """Random params with the reference's init scales: matrices
    N(0, 1/fan_in), embedding N(0, 0.02^2), head N(0, 1/hidden), norms
    ones, expert biases zeros; the router ``gate`` in float32.  Made on
    ``device`` (default CUDA) from ``generator``, which must live on that
    device's type.  With a ``mesh``, the tree holds this process's shard
    of the one global init: every rank draws every leaf in the same
    order and keeps its part."""
    dev = resolve_device(device)
    lay = layout(mesh)
    ep, j = (1, 0) if lay is None else (lay.ep, lay.j)
    _check_config(config, ep)
    h, f, e = (config.hidden_size, config.moe_intermediate_size,
               config.num_experts)
    hd, nh, kvh = (config.head_dim, config.num_attention_heads,
                   config.num_key_value_heads)
    sf = config.num_shared_experts * f

    def normal(key, *shape, std, dt=dtype):
        t = torch.empty(shape, dtype=torch.float32, device=dev)
        t.normal_(0.0, std, generator=generator)
        return shard(t, key, ep, j).to(dt)

    def full(key, *shape, value):
        return shard(torch.full(shape, value, dtype=dtype, device=dev), key,
                     ep, j)

    layers = []
    for _ in range(config.num_hidden_layers):
        lp = {
            "input_ln": full("input_ln", h, value=1.0),
            "q": normal("q", h, nh * hd, std=1 / math.sqrt(h)),
            "k": normal("k", h, kvh * hd, std=1 / math.sqrt(h)),
            "v": normal("v", h, kvh * hd, std=1 / math.sqrt(h)),
            "o": normal("o", nh * hd, h, std=1 / math.sqrt(nh * hd)),
            "post_ln": full("post_ln", h, value=1.0),
            "gate": normal("gate", h, e, std=1 / math.sqrt(h),
                           dt=torch.float32),
            "w1": normal("w1", e, h, f, std=1 / math.sqrt(h)),
            "b1": full("b1", e, f, value=0.0),
            "w2": normal("w2", e, f, h, std=1 / math.sqrt(f)),
            "b2": full("b2", e, h, value=0.0),
        }
        if config.num_shared_experts:
            lp["sw1"] = normal("sw1", h, sf, std=1 / math.sqrt(h))
            lp["sw2"] = normal("sw2", sf, h, std=1 / math.sqrt(sf))
        layers.append(lp)
    return {"embed": normal("embed", config.vocab_size, h, std=0.02),
            "layers": layers, "norm": full("norm", h, value=1.0),
            "head": normal("head", h, config.vocab_size,
                           std=1 / math.sqrt(h))}


# ------------------------------------------------------------- layer math
def _layer(lp, x, cos, sin, config: MoEConfig, mesh, lay=None):
    """One decoder layer, x [B, S, H] -> (x, router aux loss)."""
    nh, kvh, hd = (config.num_attention_heads, config.num_key_value_heads,
                   config.head_dim)
    b, sq, hdim = x.shape
    r = x
    h = _rms(x, lp["input_ln"], config.rms_norm_eps)
    # fused QKV projection: one [h, (nh+2kvh)*hd] matmul, as the reference
    qkv = h @ torch.cat([lp["q"], lp["k"], lp["v"]], dim=1)
    q = qkv[..., :nh * hd].reshape(b, sq, nh, hd)
    k = qkv[..., nh * hd:(nh + kvh) * hd].reshape(b, sq, kvh, hd)
    v = qkv[..., (nh + kvh) * hd:].reshape(b, sq, kvh, hd)
    q, k = apply_rotary_pos_emb(q, k, cos, sin)
    a = sdpa(q, k, v, is_causal=True)
    x = r + a.reshape(b, sq, nh * hd) @ lp["o"]
    r = x
    h = _rms(x, lp["post_ln"], config.rms_norm_eps)
    flat = h.reshape(b * sq, hdim)
    y, aux = moe_dispatch_combine(
        flat, lp["gate"], lp["w1"], lp["b1"], lp["w2"], lp["b2"],
        top_k=config.top_k, capacity_factor=config.capacity_factor,
        activation=F.silu, mesh=mesh, ep_axis="ep")
    if config.num_shared_experts:
        # shared experts: a dense FFN every token passes through, added to
        # the routed output (no gating); column then row parallel over ep
        if lay is None:
            y = y + F.silu(flat @ lp["sw1"]) @ lp["sw2"]
        else:
            inner = F.silu(mp_ops.copy_to(flat, lay.ep_group) @ lp["sw1"])
            y = y + mp_ops.reduce_from(inner @ lp["sw2"], lay.ep_group)
    return r + y.reshape(b, sq, hdim), aux


def _dp_rows(ids, lay):
    """This dp rank's rows of the global batch."""
    if lay is None:
        return ids
    b = ids.shape[0]
    if b % lay.dp:
        raise ValueError(f"batch {b} does not split over dp {lay.dp}")
    n = b // lay.dp
    return ids[lay.d * n:(lay.d + 1) * n]


def _loss_parts(params, ids, config: MoEConfig, mesh, lay):
    """(CE part, aux part) of this rank's dp rows ``ids`` [b, S+1]: the
    rows' CE summed over the global batch's B·S tokens, and
    ``aux_loss_weight`` x the layers' mean of the (global) aux loss."""
    inp, lab = ids[:, :-1], ids[:, 1:]
    b, s = inp.shape
    n_tokens = b * s * (1 if lay is None else lay.dp)
    x = F.embedding(inp, params["embed"])
    cos, sin = _rope_tables(s, config.head_dim, config.rope_theta,
                            device=x.device)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in params["layers"]:
        x, a = _layer(lp, x, cos, sin, config, mesh, lay)
        aux_total = aux_total + a
    h = _rms(x, params["norm"], config.rms_norm_eps)
    ce = _chunked_ce_sum(h, lab, params["head"]) / n_tokens
    return ce, config.aux_loss_weight * aux_total / config.num_hidden_layers


def loss_fn(params, ids, config: MoEConfig, mesh=None):
    """Mean next-token CE over a [B, S+1] int64 batch, plus
    ``aux_loss_weight`` times the router aux loss averaged over layers:
    the global loss on every rank.  On a mesh of dp > 1 its gradient is
    this rank's part (its rows' CE), which a sum over dp makes whole, as
    in :func:`value_and_grad`."""
    lay = layout(mesh)
    ce, aux = _loss_parts(params, _dp_rows(ids, lay), config, mesh, lay)
    if lay is not None and lay.dp > 1:
        total = C.all_reduce(ce.detach().clone(), group=lay.dp_group)
        ce = ce + (total - ce.detach())
    return ce + aux


def value_and_grad(params, ids, config: MoEConfig, mesh=None):
    """(loss, grads) of :func:`loss_fn` for the global [B, S+1] batch
    ``ids``: the loss whole on every rank, and the gradient of this
    rank's shard of every leaf, summed over dp, in the params' dtypes.
    params themselves are left as they are."""
    lay = layout(mesh)
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    with torch.enable_grad():
        ce, aux = _loss_parts(_unflatten(params, leaves), _dp_rows(ids, lay),
                              config, mesh, lay)
        # contiguous: the fused q/k/v's gradients are views of one
        # tensor, which an in-place all-reduce must not take
        grads = [g.contiguous() for g in torch.autograd.grad(ce + aux,
                                                             leaves)]
    ce = ce.detach()
    if lay is not None and lay.dp > 1:
        C.all_reduce(ce, group=lay.dp_group)
        for g in grads:
            C.all_reduce(g, group=lay.dp_group)
    return ce + aux.detach(), _unflatten(params, grads)


def build_train_step(config: MoEConfig, mesh=None, lr=3e-4, device=None):
    """Returns ``step(params, ids) -> (loss, params)`` on ``device``
    (default CUDA; raises with no card): the reference's plain SGD, each
    update in f32 and cast back to the param's dtype.  ``ids`` is the
    global [B, S+1] batch on every rank.  params are updated in place
    and returned (the reference donates them)."""
    dev = resolve_device(device)
    lay = layout(mesh)
    _check_config(config, 1 if lay is None else lay.ep)

    def step(params, ids):
        ids = torch.as_tensor(ids).to(device=dev, dtype=torch.long)
        loss, grads = value_and_grad(params, ids, config, mesh)
        with torch.no_grad():
            for p, g in zip(tree_leaves(params), tree_leaves(grads)):
                p.copy_(p.float() - lr * g.float())
        return loss, params

    return step


def setup(config: MoEConfig, mesh=None, seed=0, dtype=None, device=None):
    """Random params from ``seed`` (this rank's shard of them, on a
    mesh) on ``device`` (default CUDA), in ``dtype`` (default: the
    config's own, as the reference's setup)."""
    dev = resolve_device(device)
    if dtype is None:
        dtype = _DTYPES[config.dtype]
    gen = torch.Generator(device=dev).manual_seed(seed)
    return init_params(config, gen, dev, dtype, mesh)
