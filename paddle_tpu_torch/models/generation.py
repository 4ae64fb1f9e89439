"""Llama layer math for generation and serving, in PyTorch.

Ports the single-device layer functions of
``paddle_tpu/models/generation.py`` that the serving engine runs:
prefill over a right-padded prompt (``_prefill_layer``) and one-token
decode over the paged KV pool (``_decode_layer_paged``).  Weights are a
state dict with the reference's keys and ``[in, out]`` layout, so
``h @ w`` reads the same as the JAX code.

The paged decode layer writes the new token's K/V into the pools in
place (the reference returns updated pools from a functional scatter).

A weight may be quantized (:class:`~paddle_tpu_torch.ops.pallas.
quant_matmul.QuantizedWeight`, or the legacy ``(int8, scale)`` pair):
``_mm`` sends it through ``weight_only_matmul`` (the K4 GEMV).  A
non-empty ``lora`` bank adds each row's rank-r adapter delta
(``lora_delta``: the K5 kernel for a per-slot index vector, plain
matmuls for a scalar index) exactly where the reference adds it;
``lora=()`` is the dense path, unchanged.  The generate path's fused
``quantize_state`` comes with the rest of generation (ROADMAP queue 1
item 3).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops.pallas.flash_attention import sdpa
from ..ops.pallas.lora_matmul import lora_delta
from ..ops.pallas.paged_attention import select_paged_attention
from ..ops.pallas.quant_matmul import QuantizedWeight, weight_only_matmul
from .llama import LlamaConfig, _rms, _rotate_half

__all__ = ["GenerationConfig"]


@dataclass
class GenerationConfig:
    max_new_tokens: int = 64
    do_sample: bool = False
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    eos_token_id: int | None = None
    pad_token_id: int = 0
    seed: int = 0


def _mm(h, w):
    """Matmul against a dense ``[in, out]`` weight, a legacy
    ``(int8, scale)`` pair, or a :class:`QuantizedWeight` (the K4
    weight-only GEMV at decode shapes)."""
    if isinstance(w, tuple):        # legacy (int8, scale) pair
        w = QuantizedWeight(w[0], w[1], kind="int8")
    if isinstance(w, QuantizedWeight):
        return weight_only_matmul(h, w)
    return h @ w


def _layer_weights(state, i):
    p = f"llama.layers.{i}."
    return {
        "ln1": state[p + "input_layernorm.weight"],
        "q": state[p + "self_attn.q_proj.weight"],
        "k": state[p + "self_attn.k_proj.weight"],
        "v": state[p + "self_attn.v_proj.weight"],
        "o": state[p + "self_attn.o_proj.weight"],
        "ln2": state[p + "post_attention_layernorm.weight"],
        "gate": state[p + "mlp.gate_proj.weight"],
        "up": state[p + "mlp.up_proj.weight"],
        "down": state[p + "mlp.down_proj.weight"],
    }


def _qkv_proj(w, h, lora=(), aidx=None, li=0):
    """(q, k, v) projections, plus each row's adapter delta when a
    ``lora`` bank is given (``aidx`` indexes it per row, or is one
    scalar for the whole call)."""
    q, k, v = _mm(h, w["q"]), _mm(h, w["k"]), _mm(h, w["v"])
    if lora:
        q = q + lora_delta(lora, "q", li, h, aidx)
        k = k + lora_delta(lora, "k", li, h, aidx)
        v = v + lora_delta(lora, "v", li, h, aidx)
    return q, k, v


def _ffn(w, h, lora=(), aidx=None, li=0):
    g, u = _mm(h, w["gate"]), _mm(h, w["up"])
    if lora:
        g = g + lora_delta(lora, "gate", li, h, aidx)
        u = u + lora_delta(lora, "up", li, h, aidx)
    act = torch.nn.functional.silu(g) * u
    out = _mm(act, w["down"])
    if lora:
        out = out + lora_delta(lora, "down", li, act, aidx)
    return out


def _out_proj(w, attn, lora=(), aidx=None, li=0):
    """The attention output projection, plus its adapter delta."""
    o = _mm(attn, w["o"])
    if lora:
        o = o + lora_delta(lora, "o", li, attn, aidx)
    return o


def _rope_at(cos, sin, pos):
    """cos/sin: [max_len, D]; pos: [...] -> [..., D]"""
    return cos[pos], sin[pos]


def _prefill_layer(w, x, cos, sin, mask, cfg: LlamaConfig, lora=(),
                   aidx=None, li=0):
    """x: [B, S, H]; mask [B, S] bool key padding (True = real token);
    returns (out, k, v) with k/v [B, S, kvH, D] post-rope."""
    b, s, _ = x.shape
    nh, kvh, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                   cfg.head_dim)
    h = _rms(x, w["ln1"], cfg.rms_norm_eps)
    qp, kp, vp = _qkv_proj(w, h, lora, aidx, li)
    q = qp.reshape(b, s, nh, hd)
    k = kp.reshape(b, s, kvh, hd)
    v = vp.reshape(b, s, kvh, hd)
    cos_c = cos[None, :, None, :].to(q.dtype)
    sin_c = sin[None, :, None, :].to(q.dtype)
    q = q * cos_c + _rotate_half(q) * sin_c
    k = k * cos_c + _rotate_half(k) * sin_c
    # causal + key-padding: the masked flash forward (CUDA K8 forward)
    attn = sdpa(q, k, v, attn_mask=mask[:, None, None, :],
                is_causal=True).reshape(b, s, nh * hd)
    x = x + _out_proj(w, attn, lora, aidx, li)
    h = _rms(x, w["ln2"], cfg.rms_norm_eps)
    return x + _ffn(w, h, lora, aidx, li), k, v


def _decode_layer_paged(w, x, kpool, vpool, table, cos1, sin1, pos,
                        cfg: LlamaConfig, lora=(), aidx=None, li=0):
    """Paged-cache decode layer: x [B, H] one token per sequence; pools
    [P, kvH, ps, D], updated IN PLACE with this token's K/V at page
    table[b, pos // ps], slot pos % ps; table [B, max_pages] int32; pos
    [B] int32 is the current token's position.  Attention runs the
    paged kernel with lens = pos + 1.  Returns the layer output [B, H]."""
    b = x.shape[0]
    nh, kvh, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                   cfg.head_dim)
    ps = kpool.shape[2]
    h = _rms(x, w["ln1"], cfg.rms_norm_eps)
    qp, kp, vp = _qkv_proj(w, h, lora, aidx, li)
    q = qp.reshape(b, nh, hd)
    k = kp.reshape(b, kvh, hd)
    v = vp.reshape(b, kvh, hd)
    cos_c = cos1[:, None, :].to(q.dtype)
    sin_c = sin1[:, None, :].to(q.dtype)
    q = q * cos_c + _rotate_half(q) * sin_c
    k = k * cos_c + _rotate_half(k) * sin_c

    pos_l = pos.long()
    page = table.long().gather(1, (pos_l // ps)[:, None])      # [B, 1]
    off = (pos_l % ps)[:, None]                                 # [B, 1]
    heads = torch.arange(kvh, device=x.device)[None, :]         # [1, kvh]
    kpool[page, heads, off] = k.to(kpool.dtype)
    vpool[page, heads, off] = v.to(vpool.dtype)

    attn = select_paged_attention()(
        q.contiguous(), kpool, vpool, table, pos + 1).reshape(b, nh * hd)
    x = x + _out_proj(w, attn, lora, aidx, li)
    h = _rms(x, w["ln2"], cfg.rms_norm_eps)
    return x + _ffn(w, h, lora, aidx, li)
