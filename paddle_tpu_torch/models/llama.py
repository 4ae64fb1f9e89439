"""Llama-family configuration, the shared layer math and the nn.Layer
model, in PyTorch.

Ports ``paddle_tpu/models/llama.py``: ``LlamaConfig``, ``llama3_8b``,
``llama_tiny``, ``_rope_tables``, ``_rotate_half``,
``apply_rotary_pos_emb``, the Layer classes (``:69-236``:
``LlamaRMSNorm``, ``LlamaAttention``, ``LlamaMLP``,
``LlamaDecoderLayer``, ``LlamaModel``, ``LlamaForCausalLM`` with its
``generate``, ``LlamaPretrainingCriterion``) and the registered ops
``llama_rope`` and ``flash_attention`` (``:276-283``); and ``_rms`` from
``paddle_tpu/models/llama_hybrid.py``.  ``flash_attention`` calls the
port's ``sdpa``, so the Layer model reaches the K1/K2 (and, with a
padding mask, K8) kernels through the op registry.  The state-dict form
the serving engine and the functional trainer use lives in
``models/convert.py``; a model's ``functional_state()`` has its keys.
``llama_tp_shard_fn`` waits with ``auto_parallel``.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .. import nn
from ..framework.tensor import Tensor
from ..nn import functional as F
from ..ops.pallas.flash_attention import sdpa
from ..ops.registry import op as _op

__all__ = ["LlamaAttention", "LlamaConfig", "LlamaDecoderLayer",
           "LlamaForCausalLM", "LlamaMLP", "LlamaModel",
           "LlamaPretrainingCriterion", "LlamaRMSNorm", "MATMUL_KEYS",
           "apply_rotary_pos_emb", "flash_attention", "llama3_8b",
           "llama_tiny", "rope_op"]

# the key suffixes of a layer's per-projection matmul weights in a state
# dict: what weight-only quantization converts (serving and generation)
MATMUL_KEYS = ("self_attn.q_proj.weight", "self_attn.k_proj.weight",
               "self_attn.v_proj.weight", "self_attn.o_proj.weight",
               "mlp.gate_proj.weight", "mlp.up_proj.weight",
               "mlp.down_proj.weight")


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


# ---------------------------------------------------------------- layers
class LlamaRMSNorm(nn.Layer):
    def __init__(self, config: LlamaConfig):
        super().__init__()
        self.hidden_size = config.hidden_size
        self.weight = self.create_parameter(
            [config.hidden_size],
            default_initializer=nn.initializer.Constant(1.0))
        self.variance_epsilon = config.rms_norm_eps

    def forward(self, x):
        return F.rms_norm(x, self.weight, epsilon=self.variance_epsilon)


def _rope_handles(seq_len, config, device):
    cos, sin = _rope_tables(seq_len, config.head_dim, config.rope_theta,
                            device=device)
    return Tensor(cos), Tensor(sin)


class LlamaAttention(nn.Layer):
    """GQA attention (reference test model LlamaAttention:93)."""

    def __init__(self, config: LlamaConfig):
        super().__init__()
        self.config = config
        h, hd = config.hidden_size, config.head_dim
        kvh = config.num_key_value_heads
        self.num_heads = config.num_attention_heads
        self.num_key_value_heads = kvh
        self.head_dim = hd
        self.q_proj = nn.Linear(h, self.num_heads * hd, bias_attr=False)
        self.k_proj = nn.Linear(h, kvh * hd, bias_attr=False)
        self.v_proj = nn.Linear(h, kvh * hd, bias_attr=False)
        self.o_proj = nn.Linear(self.num_heads * hd, h, bias_attr=False)

    def forward(self, hidden_states, attn_mask=None, cos=None, sin=None):
        b, s, _ = hidden_states.shape
        q = self.q_proj(hidden_states).reshape(
            [b, s, self.num_heads, self.head_dim])
        k = self.k_proj(hidden_states).reshape(
            [b, s, self.num_key_value_heads, self.head_dim])
        v = self.v_proj(hidden_states).reshape(
            [b, s, self.num_key_value_heads, self.head_dim])
        if cos is None:
            cos, sin = _rope_handles(s, self.config, hidden_states.place)
        q, k = rope_op(q, k, cos, sin)
        # causal always: attn_mask (e.g. padding) composes with, never
        # replaces, the causal structure of the LM
        out = flash_attention(q, k, v, attn_mask, is_causal=True)
        out = out.reshape([b, s, self.num_heads * self.head_dim])
        return self.o_proj(out)


class LlamaMLP(nn.Layer):
    """SwiGLU FFN (reference test model LlamaMLP:121)."""

    def __init__(self, config: LlamaConfig):
        super().__init__()
        h, i = config.hidden_size, config.intermediate_size
        self.gate_proj = nn.Linear(h, i, bias_attr=False)
        self.up_proj = nn.Linear(h, i, bias_attr=False)
        self.down_proj = nn.Linear(i, h, bias_attr=False)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaDecoderLayer(nn.Layer):
    def __init__(self, config: LlamaConfig):
        super().__init__()
        self.self_attn = LlamaAttention(config)
        self.mlp = LlamaMLP(config)
        self.input_layernorm = LlamaRMSNorm(config)
        self.post_attention_layernorm = LlamaRMSNorm(config)

    def forward(self, hidden_states, attn_mask=None, cos=None, sin=None):
        residual = hidden_states
        h = self.input_layernorm(hidden_states)
        h = self.self_attn(h, attn_mask=attn_mask, cos=cos, sin=sin)
        h = residual + h
        residual = h
        h = self.post_attention_layernorm(h)
        h = self.mlp(h)
        return residual + h


class LlamaModel(nn.Layer):
    def __init__(self, config: LlamaConfig):
        super().__init__()
        if config.recompute:
            raise NotImplementedError(
                "LlamaConfig.recompute needs distributed.fleet's recompute, "
                "which is not ported yet; train without it (or use "
                "models/llama_hybrid.build_train_step(remat=True))")
        self.config = config
        self.embed_tokens = nn.Embedding(config.vocab_size,
                                         config.hidden_size)
        self.layers = nn.LayerList(
            [LlamaDecoderLayer(config)
             for _ in range(config.num_hidden_layers)])
        self.norm = LlamaRMSNorm(config)

    def forward(self, input_ids, attn_mask=None):
        h = self.embed_tokens(input_ids)
        if self.config.dtype == "bfloat16":
            h = h.astype("bfloat16")
        cos, sin = _rope_handles(input_ids.shape[1], self.config, h.place)
        for layer in self.layers:
            h = layer(h, attn_mask=attn_mask, cos=cos, sin=sin)
        return self.norm(h)


class LlamaForCausalLM(nn.Layer):
    def __init__(self, config: LlamaConfig):
        super().__init__()
        self.config = config
        self.llama = LlamaModel(config)
        if config.tie_word_embeddings:
            self.lm_head = None
        else:
            self.lm_head = nn.Linear(config.hidden_size, config.vocab_size,
                                     bias_attr=False)

        if config.dtype == "bfloat16":
            self.bfloat16()

    def forward(self, input_ids, attn_mask=None):
        h = self.llama(input_ids, attn_mask=attn_mask)
        if self.lm_head is None:
            w = self.llama.embed_tokens.weight
            return h.matmul(w, transpose_y=True)
        return self.lm_head(h)

    def generate(self, input_ids, **kwargs):
        """KV-cache autoregressive decoding (``models/generation.py``)."""
        from .generation import generate as _generate
        return _generate(self, input_ids, **kwargs)


class LlamaPretrainingCriterion(nn.Layer):
    """Shifted next-token cross entropy in fp32 (reference test model's
    criterion; loss math must leave bf16)."""

    def forward(self, logits, labels):
        logits = logits.astype("float32")
        return F.cross_entropy(
            logits.reshape([-1, logits.shape[-1]]),
            labels.reshape([-1]), reduction="mean")


# --- fused ops (registered so autograd and AMP see them) -----------------
@_op(name="llama_rope")
def rope_op(q, k, cos, sin):
    return apply_rotary_pos_emb(q, k, cos, sin)


@_op(name="flash_attention")
def flash_attention(q, k, v, attn_mask=None, is_causal=False):
    return sdpa(q, k, v, attn_mask=attn_mask, is_causal=is_causal)
