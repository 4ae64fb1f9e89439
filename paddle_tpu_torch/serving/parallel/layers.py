"""Transformer layers of the serving runner over int8 KV pages.

Ports the int8-KV half of ``paddle_tpu/serving/parallel/layers.py``:
int8 pools with per-(page-row, head) f32 scale pools; new KV quantizes
on write and attention dequantizes fused into the page gather (plain
PyTorch: the reference runs these on XLA).  Every decode body updates
the pools in place, as the dense ``_decode_layer_paged`` does.

The reference's dense ``*_tp`` bodies have no copy here: the dense
layers of ``models/generation`` (``_prefill_layer``,
``_decode_layer_paged``) and the runner's ``_prefill_layer_cached``
take the tp group as ``axis``, as the bodies below do.  Under a tp
group each rank projects its own query heads, kv heads and FFN
columns (head counts from the shards' widths), attends head-parallel
over its pool with no collective, and all-reduces the o and down
partial products (``collective.all_reduce`` over ``axis``, where the
reference ``psum``s over its mesh axis), a LoRA partial delta of o or
down inside the same sum.  ``axis=None`` is the single-device runner:
no collective runs.
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


def _rope(x, cos, sin):
    return x * cos + _rotate_half(x) * sin


def _proj_qkv(w, h, cfg, lora=(), aidx=None, li=0):
    """(q, k, v, nh_local, kvh_local): head counts from the projections'
    widths, so a rank of the mesh gets its own."""
    hd = cfg.head_dim
    qp, kp, vp = _qkv_proj(w, h, lora, aidx, li)
    return qp, kp, vp, qp.shape[-1] // hd, kp.shape[-1] // hd


def decode_layer_paged_quant(w, x, kpool, vpool, kscale, vscale, table,
                             cos1, sin1, pos, cfg, axis=None, lora=(),
                             aidx=None, li=0):
    """Paged decode layer over int8 KV pools: quantize this token's k/v
    rows on write (per-(token, head) scale into the scale pools, all
    four updated IN PLACE), attend through the dequantizing gather.
    ``axis`` None is the single-device runner; a tp group runs the same
    body on this rank's heads with the o/down all-reduces.  Returns the
    layer output [B, H]."""
    b = x.shape[0]
    hd = cfg.head_dim
    ps = kpool.shape[2]
    h = _rms(x, w["ln1"], cfg.rms_norm_eps)
    qp, kp, vp, nh_l, kvh_l = _proj_qkv(w, h, cfg, lora, aidx, li)
    cos_c = cos1[:, None, :].to(qp.dtype)
    sin_c = sin1[:, None, :].to(qp.dtype)
    q = _rope(qp.reshape(b, nh_l, hd), cos_c, sin_c)
    k = _rope(kp.reshape(b, kvh_l, hd), cos_c, sin_c)
    v = vp.reshape(b, kvh_l, hd)

    pos_l = pos.long()
    page = table.long().gather(1, (pos_l // ps)[:, None])      # [B, 1]
    off = (pos_l % ps)[:, None]                                 # [B, 1]
    heads = torch.arange(kvh_l, device=x.device)[None, :]
    qk, sk = quantize_kv_rows(k)
    qv, sv = quantize_kv_rows(v)
    kpool[page, heads, off] = qk
    vpool[page, heads, off] = qv
    kscale[page, heads, off] = sk
    vscale[page, heads, off] = sv

    attn = paged_attention_quant(q, kpool, vpool, kscale, vscale, table,
                                 pos + 1, tp_axis=axis).reshape(b, nh_l * hd)
    x = x + _out_proj(w, attn, lora, aidx, li, axis)
    h = _rms(x, w["ln2"], cfg.rms_norm_eps)
    return x + _ffn(w, h, lora, aidx, li, axis)


def prefill_layer_cached_quant(w, x, kpool, vpool, kscale, vscale, row,
                               cos_s, sin_s, mask, cfg, axis=None,
                               lora=(), aidx=None, li=0):
    """Cached-suffix prefill layer over int8 KV pools: the resident
    prefix dequantizes through the scale-aware gather; the suffix's own
    k/v stay float here (the runner quantizes them at the pool write).
    Returns (out, k_suffix, v_suffix)."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    h = _rms(x, w["ln1"], cfg.rms_norm_eps)
    qp, kp, vp, nh_l, kvh_l = _proj_qkv(w, h, cfg, lora, aidx, li)
    cos_c = cos_s[None, :, None, :].to(qp.dtype)
    sin_c = sin_s[None, :, None, :].to(qp.dtype)
    q = _rope(qp.reshape(b, s, nh_l, hd), cos_c, sin_c)
    k = _rope(kp.reshape(b, s, kvh_l, hd), cos_c, sin_c)
    v = vp.reshape(b, s, kvh_l, hd)

    kpre = gather_kv_pages_quant(kpool, kscale, row, k.dtype)[None]
    vpre = gather_kv_pages_quant(vpool, vscale, row, v.dtype)[None]
    kcat = torch.cat([kpre, k], dim=1)
    vcat = torch.cat([vpre, v], dim=1)
    attn = sdpa(q, kcat, vcat, attn_mask=mask,
                is_causal=False).reshape(b, s, nh_l * hd)
    x = x + _out_proj(w, attn, lora, aidx, li, axis)
    h = _rms(x, w["ln2"], cfg.rms_norm_eps)
    return x + _ffn(w, h, lora, aidx, li, axis), k, v
