"""Model state for the port: carried over from the JAX package, or random.

A serving state is a flat dict of tensors with the reference's
``functional_state()`` keys (``llama.embed_tokens.weight``,
``llama.layers.{i}.self_attn.q_proj.weight``, ..., ``llama.norm.weight``,
``lm_head.weight``) and its ``[in, out]`` weight layout.  A training
param tree (``models/llama_hybrid.py``) is ``{"embed", "stages",
"norm", "head"}`` with one dict of tensors per layer in ``stages``;
:func:`hybrid_params_from_numpy` and :func:`hybrid_params_to_numpy`
carry it to and from the reference's stage-stacked tree.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from .llama import LlamaConfig

__all__ = ["hybrid_params_from_numpy", "hybrid_params_to_numpy",
           "init_state", "state_from_numpy"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def _to_tensor(a: np.ndarray) -> torch.Tensor:
    a = np.array(a)                      # an owned, writable C-order copy
    if a.dtype.name == "bfloat16":
        # ml_dtypes.bfloat16 (what a JAX bf16 array becomes in numpy):
        # same bits as torch.bfloat16, so reinterpret through int16
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def state_from_numpy(np_state: dict, device=None, dtype=None) -> dict:
    """``{key: numpy array}`` (e.g. the JAX package's
    ``{k: np.asarray(v) for k, v in model.functional_state().items()}``)
    -> ``{key: tensor}`` on ``device`` (default CUDA), optionally cast to
    ``dtype``.  bf16 arrays keep their exact bits."""
    dev = resolve_device(device)
    out = {}
    for k, a in np_state.items():
        t = _to_tensor(a)
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        out[k] = t.to(dev)
    return out


def init_state(config: LlamaConfig, generator: torch.Generator,
               device=None, dtype=None) -> dict:
    """A random state with the reference's keys, made directly on
    ``device`` (default CUDA) from ``generator`` (which must live on that
    device's type).  Matrices are N(0, 0.02^2), norms are ones; no
    weights are downloaded.  ``dtype`` defaults to ``config.dtype``."""
    dev = resolve_device(device)
    dtype = _DTYPES[config.dtype] if dtype is None else dtype
    h, i, v = (config.hidden_size, config.intermediate_size,
               config.vocab_size)
    nh, kvh, hd = (config.num_attention_heads,
                   config.num_key_value_heads, config.head_dim)

    def normal(*shape):
        w = torch.empty(shape, dtype=torch.float32, device=dev)
        w.normal_(0.0, 0.02, generator=generator)
        return w.to(dtype)

    def ones(n):
        return torch.ones(n, dtype=dtype, device=dev)

    state = {"llama.embed_tokens.weight": normal(v, h)}
    for li in range(config.num_hidden_layers):
        p = f"llama.layers.{li}."
        state.update({
            p + "self_attn.q_proj.weight": normal(h, nh * hd),
            p + "self_attn.k_proj.weight": normal(h, kvh * hd),
            p + "self_attn.v_proj.weight": normal(h, kvh * hd),
            p + "self_attn.o_proj.weight": normal(nh * hd, h),
            p + "mlp.gate_proj.weight": normal(h, i),
            p + "mlp.up_proj.weight": normal(h, i),
            p + "mlp.down_proj.weight": normal(i, h),
            p + "input_layernorm.weight": ones(h),
            p + "post_attention_layernorm.weight": ones(h),
        })
    state["llama.norm.weight"] = ones(h)
    if not config.tie_word_embeddings:
        state["lm_head.weight"] = normal(h, v)
    return state


def hybrid_params_from_numpy(np_tree: dict, device=None, dtype=None) -> dict:
    """The reference ``llama_hybrid.init_params`` tree as numpy (stage
    leaves ``[1, L, ...]``: pp = 1) -> the port's tree, with one owned
    tensor per layer weight, on ``device`` (default CUDA), optionally
    cast to ``dtype``.  Also takes AdamW m/v trees."""
    dev = resolve_device(device)

    def conv(a):
        t = _to_tensor(a)
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t.to(dev)

    stages = {k: np.asarray(a) for k, a in np_tree["stages"].items()}
    pp, n_layers = next(iter(stages.values())).shape[:2]
    if pp != 1:
        raise ValueError(f"stage leaves must be [1, L, ...] (pp = 1), got "
                         f"pp = {pp}")
    return {"embed": conv(np_tree["embed"]),
            "stages": [{k: conv(a[0, i]) for k, a in stages.items()}
                       for i in range(n_layers)],
            "norm": conv(np_tree["norm"]), "head": conv(np_tree["head"])}


def hybrid_params_to_numpy(tree: dict) -> dict:
    """The inverse of :func:`hybrid_params_from_numpy`: numpy arrays with
    stage leaves stacked to ``[1, L, ...]`` (bf16 tensors come out as
    float32, which holds them exactly)."""
    def conv(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    keys = tree["stages"][0].keys()
    return {"embed": conv(tree["embed"]),
            "stages": {k: np.stack([conv(lp[k]) for lp in tree["stages"]])[None]
                       for k in keys},
            "norm": conv(tree["norm"]), "head": conv(tree["head"])}
