"""Mixture-of-Experts decoder LM, trained on one device, in PyTorch.

Ports ``paddle_tpu/models/moe_llm.py`` at dp = ep = 1: ``MoEConfig`` and
its presets (``moe_tiny``, ``qwen2_moe_a14b``, ``deepseek_moe_16b``),
``init_params`` (``:104``), ``_layer`` (``:178``: fused q/k/v, rope,
causal ``sdpa`` — the K1/K2 kernels on CUDA —, the MoE FFN on the
``"sort"`` dispatch of ``distributed.moe``, and the DeepSeekMoE /
Qwen2-MoE shared experts), ``loss_fn`` (``:210``), ``build_train_step``
(``:244``, plain SGD) and ``setup`` (``:257``).

The param tree keeps the reference's keys ``{"embed", "layers", "norm",
"head"}`` with ``[in, out]`` weights, but ``layers`` is a list of one
dict per layer instead of one stacked ``[L, ...]`` leaf per key (so that
autograd makes no full-size zero gradient per ``w[i]``);
``models/convert.py`` carries trees across (``moe_params_from_numpy``
and its inverse).  The reference runs shallow stacks unrolled and deep
ones (L > 16) under ``lax.scan``: the same math, one Python loop here.

The router weight ``gate`` stays float32 whatever the params' dtype, as
in the reference.  Like the reference's model, the layer takes the
``"sort"`` dispatch: the grouped FFN (K9) is reached through
``distributed.moe.moe_dispatch_combine(dispatch_mode="grouped")``.

Left out: expert parallelism and any mesh with dp or ep above 1 (each
raises ``NotImplementedError``; ROADMAP queue 1, hybrid-parallel
training).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from .. import resolve_device
from ..distributed.moe import moe_dispatch_combine
from ..ops.pallas.flash_attention import sdpa
from .convert import _DTYPES
from .llama import _rms, _rope_tables, apply_rotary_pos_emb
from .llama_hybrid import _chunked_ce_sum

__all__ = ["MoEConfig", "build_mesh", "build_train_step", "deepseek_moe_16b",
           "init_params", "loss_fn", "moe_tiny", "param_shardings",
           "qwen2_moe_a14b", "setup", "tree_leaves", "tree_map",
           "value_and_grad"]

_LAYER_KEYS = ("input_ln", "q", "k", "v", "o", "post_ln", "gate", "w1", "b1",
               "w2", "b2")
_SHARED_KEYS = ("sw1", "sw2")
_EP_LATER = ("is not ported yet (ROADMAP queue 1, hybrid-parallel "
             "training: expert parallelism); the port trains MoE on one "
             "device")


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
    """The port's mesh: a mapping of axis sizes, ``{"dp": 1, "ep": 1}``.
    Only one device is ported."""
    if dp * ep > 1 or (n_devices is not None and n_devices != 1):
        raise NotImplementedError(
            f"a mesh of dp={dp}, ep={ep} over {n_devices or dp * ep} "
            f"devices {_EP_LATER}")
    return {"dp": 1, "ep": 1}


def _check_mesh(mesh):
    dp, ep = (1, 1) if mesh is None else (int(mesh.get(a, 1))
                                         for a in ("dp", "ep"))
    if dp * ep > 1:
        raise NotImplementedError(f"a mesh with dp={dp}, ep={ep} {_EP_LATER}")


def param_shardings(mesh=None, config=None, params=None):
    """The reference's sharding tree places experts over ep: not ported."""
    raise NotImplementedError(f"param_shardings (expert sharding) {_EP_LATER}")


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
                dtype=torch.float32) -> dict:
    """Random params with the reference's init scales: matrices
    N(0, 1/fan_in), embedding N(0, 0.02^2), head N(0, 1/hidden), norms
    ones, expert biases zeros; the router ``gate`` in float32.  Made on
    ``device`` (default CUDA) from ``generator``, which must live on that
    device's type."""
    dev = resolve_device(device)
    h, f, e = (config.hidden_size, config.moe_intermediate_size,
               config.num_experts)
    hd, nh, kvh = (config.head_dim, config.num_attention_heads,
                   config.num_key_value_heads)
    sf = config.num_shared_experts * f

    def normal(*shape, std, dt=dtype):
        t = torch.empty(shape, dtype=torch.float32, device=dev)
        t.normal_(0.0, std, generator=generator)
        return t.to(dt)

    def full(*shape, value):
        return torch.full(shape, value, dtype=dtype, device=dev)

    layers = []
    for _ in range(config.num_hidden_layers):
        lp = {
            "input_ln": full(h, value=1.0),
            "q": normal(h, nh * hd, std=1 / math.sqrt(h)),
            "k": normal(h, kvh * hd, std=1 / math.sqrt(h)),
            "v": normal(h, kvh * hd, std=1 / math.sqrt(h)),
            "o": normal(nh * hd, h, std=1 / math.sqrt(nh * hd)),
            "post_ln": full(h, value=1.0),
            "gate": normal(h, e, std=1 / math.sqrt(h), dt=torch.float32),
            "w1": normal(e, h, f, std=1 / math.sqrt(h)),
            "b1": full(e, f, value=0.0),
            "w2": normal(e, f, h, std=1 / math.sqrt(f)),
            "b2": full(e, h, value=0.0),
        }
        if config.num_shared_experts:
            lp["sw1"] = normal(h, sf, std=1 / math.sqrt(h))
            lp["sw2"] = normal(sf, h, std=1 / math.sqrt(sf))
        layers.append(lp)
    return {"embed": normal(config.vocab_size, h, std=0.02),
            "layers": layers, "norm": full(h, value=1.0),
            "head": normal(h, config.vocab_size, std=1 / math.sqrt(h))}


# ------------------------------------------------------------- layer math
def _layer(lp, x, cos, sin, config: MoEConfig, mesh):
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
        # the routed output (no gating)
        y = y + F.silu(flat @ lp["sw1"]) @ lp["sw2"]
    return r + y.reshape(b, sq, hdim), aux


def loss_fn(params, ids, config: MoEConfig, mesh=None):
    """Mean next-token CE over a [B, S+1] int64 batch, plus
    ``aux_loss_weight`` times the router aux loss averaged over layers."""
    _check_mesh(mesh)
    inp, lab = ids[:, :-1], ids[:, 1:]
    b, s = inp.shape
    x = F.embedding(inp, params["embed"])
    cos, sin = _rope_tables(s, config.head_dim, config.rope_theta,
                            device=x.device)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in params["layers"]:
        x, a = _layer(lp, x, cos, sin, config, mesh)
        aux_total = aux_total + a
    h = _rms(x, params["norm"], config.rms_norm_eps)
    ce = _chunked_ce_sum(h, lab, params["head"]) / (b * s)
    return ce + config.aux_loss_weight * aux_total / config.num_hidden_layers


def value_and_grad(params, ids, config: MoEConfig, mesh=None):
    """(loss, grads) of :func:`loss_fn`; grads is a tree like params, in
    the params' dtypes.  params themselves are left as they are."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    with torch.enable_grad():
        loss = loss_fn(_unflatten(params, leaves), ids, config, mesh)
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), _unflatten(params, grads)


def build_train_step(config: MoEConfig, mesh=None, lr=3e-4, device=None):
    """Returns ``step(params, ids) -> (loss, params)`` on ``device``
    (default CUDA; raises with no card): the reference's plain SGD, each
    update in f32 and cast back to the param's dtype.  params are updated
    in place and returned (the reference donates them)."""
    dev = resolve_device(device)
    _check_mesh(mesh)

    def step(params, ids):
        ids = torch.as_tensor(ids).to(device=dev, dtype=torch.long)
        loss, grads = value_and_grad(params, ids, config, mesh)
        with torch.no_grad():
            for p, g in zip(tree_leaves(params), tree_leaves(grads)):
                p.copy_(p.float() - lr * g.float())
        return loss, params

    return step


def setup(config: MoEConfig, mesh=None, seed=0, dtype=None, device=None):
    """Random params from ``seed`` on ``device`` (default CUDA), in
    ``dtype`` (default: the config's own, as the reference's setup)."""
    dev = resolve_device(device)
    _check_mesh(mesh)
    if dtype is None:
        dtype = _DTYPES[config.dtype]
    gen = torch.Generator(device=dev).manual_seed(seed)
    return init_params(config, gen, dev, dtype)
