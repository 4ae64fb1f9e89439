"""Llama-family configuration and the shared layer math, in PyTorch.

Ports ``paddle_tpu/models/llama.py`` (``LlamaConfig``, ``llama3_8b``,
``llama_tiny``, ``_rope_tables``, ``_rotate_half``,
``apply_rotary_pos_emb``) and ``_rms`` from
``paddle_tpu/models/llama_hybrid.py``.  The nn-Layer model classes come
with a later slice; serving works on a state dict (``models/convert.py``).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

__all__ = ["LlamaConfig", "apply_rotary_pos_emb", "llama3_8b",
           "llama_tiny"]


@dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False
    use_flash_attention: bool = True
    recompute: bool = False
    dtype: str = "float32"

    @property
    def head_dim(self):
        return self.hidden_size // self.num_attention_heads


def llama3_8b() -> LlamaConfig:
    return LlamaConfig(
        vocab_size=128256, hidden_size=4096, intermediate_size=14336,
        num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8,
        max_position_embeddings=8192, rope_theta=500000.0, dtype="bfloat16")


def llama_tiny(**kw) -> LlamaConfig:
    cfg = dict(vocab_size=512, hidden_size=128, intermediate_size=256,
               num_hidden_layers=2, num_attention_heads=4,
               num_key_value_heads=2, max_position_embeddings=256)
    cfg.update(kw)
    return LlamaConfig(**cfg)


def _rope_tables(seq_len, head_dim, theta, device=None,
                 dtype=torch.float32):
    """f32 rotary tables ``(cos, sin)``, each [seq_len, head_dim]."""
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                        device=device) / head_dim))
    t = torch.arange(seq_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv)                      # [S, D/2]
    emb = torch.cat([freqs, freqs], dim=-1)          # [S, D]
    return emb.cos().to(dtype), emb.sin().to(dtype)


def _rotate_half(x):
    h = x.shape[-1] // 2
    return torch.cat([-x[..., h:], x[..., :h]], dim=-1)


def apply_rotary_pos_emb(q, k, cos, sin):
    """q, k: [B, S, H, D]; cos, sin: [S, D] f32 tables, applied in q's
    dtype (reference ``models/llama.py:96-100``)."""
    cos = cos[None, :, None, :].to(q.dtype)
    sin = sin[None, :, None, :].to(q.dtype)
    return q * cos + _rotate_half(q) * sin, k * cos + _rotate_half(k) * sin


def _rms(x, w, eps):
    """RMSNorm with the reference's order: normalise in f32, cast back to
    x's dtype, THEN multiply by the weight (``llama_hybrid._rms``)."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w
