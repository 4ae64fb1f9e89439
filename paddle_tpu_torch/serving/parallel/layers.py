"""Transformer layers over int8 KV pages for the serving runner.

Ports the int8-KV-page bodies of ``paddle_tpu/serving/parallel/
layers.py`` (``decode_layer_paged_quant``, ``prefill_layer_cached_quant``)
for the single-device runner (``axis=None``).  The pools are int8 with
per-(page-row, head) f32 scale pools; new KV quantizes on write and
attention dequantizes fused into the page gather (plain PyTorch: the
reference runs these on XLA).  The decode layer updates the pools in
place, as the dense ``_decode_layer_paged`` does.  The tensor-parallel
bodies (``*_tp``, an axis name) come with serving tensor parallelism
(ROADMAP queue 1, serving tensor parallelism).
"""
from __future__ import annotations

import torch

from ...models.generation import _ffn, _out_proj, _qkv_proj
from ...models.llama import _rms, _rotate_half
from ...ops.pallas.flash_attention import sdpa
from ...ops.pallas.paged_attention import (gather_kv_pages_quant,
                                           paged_attention_quant,
                                           quantize_kv_rows)

__all__ = ["decode_layer_paged_quant", "prefill_layer_cached_quant"]


def _single_device(axis):
    if axis is not None:
        raise NotImplementedError(
            f"axis={axis!r}: the tensor-parallel layer bodies are not "
            "ported yet (ROADMAP queue 1, serving tensor parallelism)")


def _rope(x, cos, sin):
    return x * cos + _rotate_half(x) * sin


def decode_layer_paged_quant(w, x, kpool, vpool, kscale, vscale, table,
                             cos1, sin1, pos, cfg, axis=None, lora=(),
                             aidx=None, li=0):
    """Paged decode layer over int8 KV pools: quantize this token's k/v
    rows on write (per-(token, head) scale into the scale pools, all
    four updated IN PLACE), attend through the dequantizing gather.
    Returns the layer output [B, H]."""
    _single_device(axis)
    b = x.shape[0]
    nh, kvh, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                   cfg.head_dim)
    ps = kpool.shape[2]
    h = _rms(x, w["ln1"], cfg.rms_norm_eps)
    qp, kp, vp = _qkv_proj(w, h, lora, aidx, li)
    cos_c = cos1[:, None, :].to(qp.dtype)
    sin_c = sin1[:, None, :].to(qp.dtype)
    q = _rope(qp.reshape(b, nh, hd), cos_c, sin_c)
    k = _rope(kp.reshape(b, kvh, hd), cos_c, sin_c)
    v = vp.reshape(b, kvh, hd)

    pos_l = pos.long()
    page = table.long().gather(1, (pos_l // ps)[:, None])      # [B, 1]
    off = (pos_l % ps)[:, None]                                 # [B, 1]
    heads = torch.arange(kvh, device=x.device)[None, :]         # [1, kvh]
    qk, sk = quantize_kv_rows(k)
    qv, sv = quantize_kv_rows(v)
    kpool[page, heads, off] = qk
    vpool[page, heads, off] = qv
    kscale[page, heads, off] = sk
    vscale[page, heads, off] = sv

    attn = paged_attention_quant(q, kpool, vpool, kscale, vscale, table,
                                 pos + 1).reshape(b, nh * hd)
    x = x + _out_proj(w, attn, lora, aidx, li)
    h = _rms(x, w["ln2"], cfg.rms_norm_eps)
    return x + _ffn(w, h, lora, aidx, li)


def prefill_layer_cached_quant(w, x, kpool, vpool, kscale, vscale, row,
                               cos_s, sin_s, mask, cfg, axis=None,
                               lora=(), aidx=None, li=0):
    """Cached-suffix prefill layer over int8 KV pools: the resident
    prefix dequantizes through the scale-aware gather; the suffix's own
    k/v stay float here (the runner quantizes them at the pool write).
    Returns (out, k_suffix, v_suffix)."""
    _single_device(axis)
    b, s, _ = x.shape
    nh, kvh, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                   cfg.head_dim)
    h = _rms(x, w["ln1"], cfg.rms_norm_eps)
    qp, kp, vp = _qkv_proj(w, h, lora, aidx, li)
    cos_c = cos_s[None, :, None, :].to(qp.dtype)
    sin_c = sin_s[None, :, None, :].to(qp.dtype)
    q = _rope(qp.reshape(b, s, nh, hd), cos_c, sin_c)
    k = _rope(kp.reshape(b, s, kvh, hd), cos_c, sin_c)
    v = vp.reshape(b, s, kvh, hd)

    kpre = gather_kv_pages_quant(kpool, kscale, row, k.dtype)[None]
    vpre = gather_kv_pages_quant(vpool, vscale, row, v.dtype)[None]
    kcat = torch.cat([kpre, k], dim=1)
    vcat = torch.cat([vpre, v], dim=1)
    attn = sdpa(q, kcat, vcat, attn_mask=mask,
                is_causal=False).reshape(b, s, nh * hd)
    x = x + _out_proj(w, attn, lora, aidx, li)
    h = _rms(x, w["ln2"], cfg.rms_norm_eps)
    return x + _ffn(w, h, lora, aidx, li), k, v
