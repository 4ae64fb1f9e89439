"""Autoregressive generation with a static-shape KV cache, in PyTorch.

Ports ``paddle_tpu/models/generation.py``: the user entry
:func:`generate` and its three builders (dense cache, paged cache, beam
search), the layer functions they run (also the serving engine's:
``_prefill_layer`` and ``_decode_layer_paged``), sampling, and the
fused weight-only ``quantize_state``.  Weights are a state dict with the
reference's keys and ``[in, out]`` layout, so ``h @ w`` reads the same
as the JAX code.

What changes in PyTorch:
  * the reference's jitted ``lax.scan`` over decode steps is a Python
    loop (eager PyTorch, one step after another).  Its step count is
    kept: ``max_new_tokens`` decode steps, the last step's token
    dropped (``max_new_tokens - 1`` steps for beam search).
  * the decode layers write the new token's K/V into the cache IN
    PLACE (the reference returns a new cache from a functional
    ``.at[].set``).
  * sampling draws from an explicit ``torch.Generator`` seeded from
    ``seed``; it cannot reproduce ``jax.random``'s bits.
  * there is no compiled-program cache (``_FN_CACHE``): a builder only
    closes over shapes, so eager PyTorch has nothing to keep.

A weight may be quantized (:class:`~paddle_tpu_torch.ops.pallas.
quant_matmul.QuantizedWeight`, or the legacy ``(int8, scale)`` pair):
``_mm`` sends it through ``weight_only_matmul`` (the K4 GEMV).  The
generation ``quantize_state`` adds fused q/k/v and gate/up leaves, which
``_qkv_proj`` and ``_ffn`` run as one GEMV each; the serving state has
no fused keys, so the engine's path does not change.  A non-empty
``lora`` bank adds each row's rank-r adapter delta (``lora_delta``: the
K5 kernel for a per-slot index vector, plain matmuls for a scalar
index) exactly where the reference adds it; ``lora=()`` is the dense
path, unchanged.

Tensor parallelism: ``_prefill_layer`` and ``_decode_layer_paged`` also
serve one rank of a serving mesh (``serving/parallel``).  Given a tp
group ``axis``, the weights are the rank's shards (q/k/v, gate and up
split by columns, o and down by rows), the head counts come from the
shards' widths, and the o and down partial products are all-reduced
over ``axis`` (the reference's ``psum``s; a LoRA partial delta of o or
down joins the same sum).  ``axis=None``, the default, is the identity:
no collective runs.

Attention: prompt prefill runs ``sdpa`` with a key-padding mask (the K8
forward), a dense-cache decode step runs ``decode_attention`` (K7) and a
paged one ``paged_attention`` (K3).
"""
from __future__ import annotations

import math
import weakref
from dataclasses import dataclass

import numpy as np
import torch

from .. import resolve_device
from ..distributed.collective import all_reduce
from ..nn.quant import weight_quantize
from ..ops.pallas import decode_attention as _DA
from ..ops.pallas.flash_attention import sdpa
from ..ops.pallas.lora_matmul import lora_delta
from ..ops.pallas.paged_attention import PagedPool, select_paged_attention
from ..ops.pallas.quant_matmul import QuantizedWeight, weight_only_matmul
from .llama import MATMUL_KEYS, LlamaConfig, _rms, _rope_tables, _rotate_half

__all__ = ["GenerationConfig", "build_generate_fn", "build_generate_fn_beam",
           "build_generate_fn_paged", "generate", "generate_from_state",
           "quantize_state"]


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


_FUSED_KEYS = ("qkv_fused.weight", "gateup_fused.weight")


def quantize_state(state, algo="weight_only_int8"):
    """Replace every matmul weight of a generation state dict, and
    ``lm_head``, with a :class:`QuantizedWeight` (embeddings and norms
    stay dense).  int4 weights are nibble-packed ``[K/2, N]``.

    q/k/v and gate/up are ALSO quantized fused (columns concatenated
    before the per-output-channel quantization, so each column's values
    and scale are those of the separate weight) as
    ``self_attn.qkv_fused.weight`` and ``mlp.gateup_fused.weight``: the
    decode loop runs one GEMV where it ran three.  Every per-projection
    key is quantized too, so a consumer reading ``q_proj.weight``
    directly still gets the quantized path.  Runs on the state's
    device; on the CPU the values and scales are bit-identical to the
    reference's."""
    kind = "int4" if algo.endswith("int4") else "int8"

    def quant(arr):
        q, scale = weight_quantize(arr, algo)
        return QuantizedWeight(q, scale, kind=kind, k=arr.shape[0])

    out = dict(state)
    for name in state:
        p, _, leaf = name.rpartition(".self_attn.q_proj.weight")
        if leaf == "" and p:
            pre = p + ".self_attn."
            out[pre + "qkv_fused.weight"] = quant(torch.cat(
                [state[pre + "q_proj.weight"], state[pre + "k_proj.weight"],
                 state[pre + "v_proj.weight"]], dim=1))
        p, _, leaf = name.rpartition(".mlp.gate_proj.weight")
        if leaf == "" and p:
            pre = p + ".mlp."
            out[pre + "gateup_fused.weight"] = quant(torch.cat(
                [state[pre + "gate_proj.weight"],
                 state[pre + "up_proj.weight"]], dim=1))
    for name, arr in state.items():
        if name.endswith(MATMUL_KEYS) or name == "lm_head.weight":
            out[name] = quant(arr)
    return out


def _layer_weights(state, i):
    p = f"llama.layers.{i}."
    w = {
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
    if p + "self_attn.qkv_fused.weight" in state:   # generation quant
        w["qkv"] = state[p + "self_attn.qkv_fused.weight"]
    if p + "mlp.gateup_fused.weight" in state:
        w["gateup"] = state[p + "mlp.gateup_fused.weight"]
    return w


def _qkv_proj(w, h, lora=(), aidx=None, li=0):
    """(q, k, v) projections -- one fused GEMV when the quantized
    generation state provides it, three matmuls otherwise -- plus each
    row's adapter delta when a ``lora`` bank is given (``aidx`` indexes
    it per row, or is one scalar for the whole call)."""
    if "qkv" in w:
        qkv = _mm(h, w["qkv"])
        nq, nk = w["q"].shape[1], w["k"].shape[1]
        q, k, v = qkv[..., :nq], qkv[..., nq:nq + nk], qkv[..., nq + nk:]
    else:
        q, k, v = _mm(h, w["q"]), _mm(h, w["k"]), _mm(h, w["v"])
    if lora:
        q = q + lora_delta(lora, "q", li, h, aidx)
        k = k + lora_delta(lora, "k", li, h, aidx)
        v = v + lora_delta(lora, "v", li, h, aidx)
    return q, k, v


def _psum(part, axis):
    """A row-sharded projection's all-reduce over the tp group ``axis``;
    the identity at ``axis=None``."""
    return part if axis is None else all_reduce(part, group=axis)


def _ffn(w, h, lora=(), aidx=None, li=0, axis=None):
    if "gateup" in w:
        gu = _mm(h, w["gateup"])
        half = gu.shape[-1] // 2
        g, u = gu[..., :half], gu[..., half:]
    else:
        g, u = _mm(h, w["gate"]), _mm(h, w["up"])
    if lora:
        g = g + lora_delta(lora, "gate", li, h, aidx)
        u = u + lora_delta(lora, "up", li, h, aidx)
    act = torch.nn.functional.silu(g) * u
    out = _mm(act, w["down"])
    if lora:
        out = out + lora_delta(lora, "down", li, act, aidx)
    return _psum(out, axis)


def _out_proj(w, attn, lora=(), aidx=None, li=0, axis=None):
    """The attention output projection, plus its adapter delta."""
    o = _mm(attn, w["o"])
    if lora:
        o = o + lora_delta(lora, "o", li, attn, aidx)
    return _psum(o, axis)


def _rope_at(cos, sin, pos):
    """cos/sin: [max_len, D]; pos: [...] -> [..., D]"""
    return cos[pos], sin[pos]


def _prefill_layer(w, x, cos, sin, mask, cfg: LlamaConfig, lora=(),
                   aidx=None, li=0, axis=None):
    """x: [B, S, H]; mask [B, S] bool key padding (True = real token);
    returns (out, k, v) with k/v [B, S, kvH, D] post-rope (``kvH`` this
    rank's heads under a tp ``axis``)."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    h = _rms(x, w["ln1"], cfg.rms_norm_eps)
    qp, kp, vp = _qkv_proj(w, h, lora, aidx, li)
    nh, kvh = qp.shape[-1] // hd, kp.shape[-1] // hd
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
    x = x + _out_proj(w, attn, lora, aidx, li, axis)
    h = _rms(x, w["ln2"], cfg.rms_norm_eps)
    return x + _ffn(w, h, lora, aidx, li, axis), k, v


def _decode_layer(w, x, kcache, vcache, cos1, sin1, pos,
                  cfg: LlamaConfig):
    """Dense-cache decode layer: x [B, H] one token per sequence; caches
    [B, kvH, T, D] (kv-head-major), updated IN PLACE with this token's
    K/V at position ``pos`` (the reference returns a new cache from
    ``.at[].set(mode="drop")``; generation never writes past T).  pos
    [B] int32 is the current token's position; attention runs
    ``decode_attention`` (K7) over keys t <= pos.  Returns the layer
    output [B, H]."""
    b = x.shape[0]
    nh, kvh, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                   cfg.head_dim)
    h = _rms(x, w["ln1"], cfg.rms_norm_eps)
    qp, kp, vp = _qkv_proj(w, h)
    q = qp.reshape(b, nh, hd)
    k = kp.reshape(b, kvh, hd)
    v = vp.reshape(b, kvh, hd)
    cos_c = cos1[:, None, :].to(q.dtype)
    sin_c = sin1[:, None, :].to(q.dtype)
    q = q * cos_c + _rotate_half(q) * sin_c
    k = k * cos_c + _rotate_half(k) * sin_c

    rows = torch.arange(b, device=x.device)
    pos_l = pos.long()
    kcache[rows, :, pos_l] = k.to(kcache.dtype)
    vcache[rows, :, pos_l] = v.to(vcache.dtype)

    attn = _DA.decode_attention(q.contiguous(), kcache, vcache,
                                pos).reshape(b, nh * hd)
    x = x + _mm(attn, w["o"])
    h = _rms(x, w["ln2"], cfg.rms_norm_eps)
    return x + _ffn(w, h)


def _decode_layer_paged(w, x, kpool, vpool, table, cos1, sin1, pos,
                        cfg: LlamaConfig, lora=(), aidx=None, li=0,
                        axis=None):
    """Paged-cache decode layer: x [B, H] one token per sequence; pools
    [P, kvH, ps, D], updated IN PLACE with this token's K/V at page
    table[b, pos // ps], slot pos % ps; table [B, max_pages] int32; pos
    [B] int32 is the current token's position.  Attention runs the
    paged kernel with lens = pos + 1.  Returns the layer output [B, H].
    With the generation quantize state, gate and up run as one fused
    GEMV (the reference's paged layer runs them apart; the columns are
    the same).  Under a tp ``axis`` the pools hold this rank's kv heads
    and attention runs head-parallel on them, with no collective."""
    b = x.shape[0]
    hd = cfg.head_dim
    ps = kpool.shape[2]
    h = _rms(x, w["ln1"], cfg.rms_norm_eps)
    qp, kp, vp = _qkv_proj(w, h, lora, aidx, li)
    nh, kvh = qp.shape[-1] // hd, kp.shape[-1] // hd
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

    attn = select_paged_attention(tp_axis=axis)(
        q.contiguous(), kpool, vpool, table, pos + 1).reshape(b, nh * hd)
    x = x + _out_proj(w, attn, lora, aidx, li, axis)
    h = _rms(x, w["ln2"], cfg.rms_norm_eps)
    return x + _ffn(w, h, lora, aidx, li, axis)


# --------------------------------------------------------------- sampling
def _filter_logits(logits, gen: GenerationConfig):
    """f32 logits after temperature, top-k and top-p, with the
    reference's sort, cumsum and cutoff rules; removed tokens are -inf.
    A sampled token always lies where the result is finite."""
    logits = logits.float()
    if gen.temperature != 1.0:
        logits = logits / max(gen.temperature, 1e-6)
    if gen.top_k and gen.top_k > 0:
        k = min(gen.top_k, logits.shape[-1])
        kth = torch.sort(logits, dim=-1).values[..., -k][..., None]
        logits = logits.masked_fill(logits < kth, -math.inf)
    if gen.top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        # keep the smallest prefix with cumulative prob >= top_p
        cutoff_idx = (cum < gen.top_p).sum(dim=-1, keepdim=True)
        cutoff = sorted_logits.gather(
            -1, cutoff_idx.clamp_max(logits.shape[-1] - 1))
        logits = logits.masked_fill(logits < cutoff, -math.inf)
    return logits


def _sample(logits, generator, gen: GenerationConfig):
    """Greedy (``torch.argmax``: the first index of a tie, as
    ``jnp.argmax``) or a draw from the filtered distribution, by the
    exponential race argmax(logits - log E) with E ~ Exp(1) from
    ``generator`` (a draw in proportion to softmax(logits))."""
    if not gen.do_sample:
        return torch.argmax(logits.float(), dim=-1)
    logits = _filter_logits(logits, gen)
    e = torch.empty_like(logits).exponential_(1.0, generator=generator)
    return torch.argmax(logits - e.log(), dim=-1)


def _top_k(x, k):
    """(values, indices) of the k largest entries of the last axis,
    largest first, the lower index first among equal values (as
    ``jax.lax.top_k``; ``torch.topk`` promises no order for ties)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


# ------------------------------------------------------------ paged main
def build_generate_fn_paged(config: LlamaConfig, gen: GenerationConfig,
                            prompt_len: int, page_size: int,
                            num_pages: int, max_pages: int):
    """Paged-cache generate: returns ``(state, ids, lengths, generator,
    table) -> ids [B, prompt_len + max_new_tokens]``.  The pools [L,
    num_pages, kvH, page_size, D] are allocated inside (zeros) from the
    :class:`PagedPool` reservation ``table`` [B, max_pages] int32;
    device memory scales with sum(len + new), not B * max_len.  Decode
    steps run ``_decode_layer_paged`` (K3)."""
    L = config.num_hidden_layers
    kvh, hd = config.num_key_value_heads, config.head_dim
    T = prompt_len + gen.max_new_tokens
    assert T <= config.max_position_embeddings
    ps = page_size
    prompt_pages = -(-prompt_len // ps)

    def run(state, ids, lengths, generator, table):
        b = ids.shape[0]
        dev = ids.device
        cos, sin = _rope_tables(max(T, prompt_pages * ps), hd,
                                config.rope_theta, device=dev)
        kpool = torch.zeros((L, num_pages, kvh, ps, hd),
                            dtype=state["llama.embed_tokens.weight"].dtype,
                            device=dev)
        vpool = torch.zeros_like(kpool)
        # the prompt's k/v go to its pages: a row whose reservation is
        # shorter than the prompt's pages writes its padding into the
        # dump page, which is never read
        spad = prompt_pages * ps - prompt_len
        pages = table[:, :prompt_pages].long()

        def write(i, k, v):
            for pool, rows in ((kpool, k), (vpool, v)):
                rows = torch.nn.functional.pad(rows, (0, 0, 0, 0, 0, spad))
                pool[i, pages] = rows.reshape(
                    b, prompt_pages, ps, kvh, hd).transpose(2, 3)

        last = _prefill(state, ids, lengths, cos, sin, config, write)
        new = _decode_loop(
            state, config, gen, last, lengths, cos, sin, generator,
            lambda i, w, h, cos1, sin1, pos: _decode_layer_paged(
                w, h, kpool[i], vpool[i], table, cos1, sin1, pos, config))
        return torch.cat([ids, new.to(ids.dtype)], dim=1)

    return run


# ------------------------------------------------------------------ main
def _cache_len(prompt_len, max_new_tokens):
    """Cache length: padded to 128 when the decode kernel is on, as the
    reference pads for its kernel's tiles (the CUDA kernel masks the
    ragged edge itself; the padding keeps the two packages' shapes
    equal).  Rope rows past max_position_embeddings exist but are never
    addressed."""
    T = prompt_len + max_new_tokens
    if _DA.PALLAS_DECODE:
        T = -(-T // 128) * 128
    return T


def _logits_fn(state, config):
    """h [B, H] -> logits [B, V]: ``lm_head`` (dense or quantized), or
    the tied embedding."""
    head = state.get("lm_head.weight")
    if head is not None:
        return lambda h: _mm(h, head)
    embed = state["llama.embed_tokens.weight"]
    return lambda h: h @ embed.T


def _next_token(logits, generator, gen, done):
    """Sample the next token; a finished row emits pad from then on."""
    nxt = _sample(logits, generator, gen)
    if gen.eos_token_id is not None:
        nxt = torch.where(done, gen.pad_token_id, nxt)
        done = done | (nxt == gen.eos_token_id)
    return nxt, done


def _prefill(state, ids, lengths, cos, sin, config, write):
    """Prompt prefill over the right-padded ids [B, S] (key padding from
    ``lengths``); ``write(i, k, v)`` stores layer i's post-rope k/v [B,
    S, kvH, D] in the caller's cache.  Returns [B, H]: the final-normed
    hidden of each prompt's last real token (the norm is row-wise, so
    normalising only those rows gives the reference's values there)."""
    b, s = ids.shape
    x = state["llama.embed_tokens.weight"][ids]
    pmask = torch.arange(s, device=ids.device)[None, :] < lengths[:, None]
    for i in range(config.num_hidden_layers):
        x, k, v = _prefill_layer(_layer_weights(state, i), x, cos[:s],
                                 sin[:s], pmask, config)
        write(i, k, v)
    last = x[torch.arange(b, device=ids.device), (lengths - 1).long()]
    return _rms(last, state["llama.norm.weight"], config.rms_norm_eps)


def _prefill_prompt(state, ids, lengths, cos, sin, config, T):
    """Prefill into a dense cache (greedy and beam paths): returns (last
    [B, H], kcache [L, B, kvH, T, D], vcache).  The caches are allocated
    once, zero past the prompt, and filled layer by layer (the reference
    pads and stacks per-layer caches)."""
    b, s = ids.shape
    kcache = torch.zeros((config.num_hidden_layers, b,
                          config.num_key_value_heads, T, config.head_dim),
                         dtype=state["llama.embed_tokens.weight"].dtype,
                         device=ids.device)
    vcache = torch.zeros_like(kcache)

    def write(i, k, v):
        kcache[i, :, :, :s] = k.transpose(1, 2)
        vcache[i, :, :, :s] = v.transpose(1, 2)

    last = _prefill(state, ids, lengths, cos, sin, config, write)
    return last, kcache, vcache


def _decode_loop(state, config, gen, last, lengths, cos, sin, generator,
                 layer):
    """The greedy or sampled decode loop of the dense and paged
    builders: the first token is sampled from the prompts' ``last``
    hidden rows, then ``max_new_tokens`` decode steps run, each through
    ``layer(i, w, h, cos1, sin1, pos)`` (decoder layer i over one token
    per sequence at position ``pos``, writing its cache).  toks[t] is
    the token sampled after t steps: exactly ``max_new_tokens`` new
    tokens, the last step's token dropped as in the reference's scan.
    Returns the new tokens [B, max_new_tokens]."""
    logits_of = _logits_fn(state, config)
    norm = state["llama.norm.weight"]
    embed = state["llama.embed_tokens.weight"]
    ws = [_layer_weights(state, i) for i in range(config.num_hidden_layers)]
    done = torch.zeros(last.shape[0], dtype=torch.bool, device=last.device)
    tok, done = _next_token(logits_of(last), generator, gen, done)
    pos = lengths.to(torch.int32)
    toks = []
    for _ in range(gen.max_new_tokens):
        toks.append(tok)
        h = embed[tok]
        cos1, sin1 = _rope_at(cos, sin, pos.long())
        for i, w in enumerate(ws):
            h = layer(i, w, h, cos1, sin1, pos)
        tok, done = _next_token(
            logits_of(_rms(h, norm, config.rms_norm_eps)), generator, gen,
            done)
        pos = pos + 1
    return torch.stack(toks, 1)


def build_generate_fn(config: LlamaConfig, gen: GenerationConfig,
                      prompt_len: int):
    """Returns ``(state, ids [B, prompt_len], lengths [B], generator) ->
    ids [B, prompt_len + max_new_tokens]``: dense-cache greedy or
    sampled decoding, one ``_decode_layer`` (K7) per layer per step."""
    T = _cache_len(prompt_len, gen.max_new_tokens)
    assert prompt_len + gen.max_new_tokens \
        <= config.max_position_embeddings

    def run(state, ids, lengths, generator):
        cos, sin = _rope_tables(T, config.head_dim, config.rope_theta,
                                device=ids.device)
        last, kcache, vcache = _prefill_prompt(state, ids, lengths, cos,
                                               sin, config, T)
        new = _decode_loop(
            state, config, gen, last, lengths, cos, sin, generator,
            lambda i, w, h, cos1, sin1, pos: _decode_layer(
                w, h, kcache[i], vcache[i], cos1, sin1, pos, config))
        return torch.cat([ids, new.to(ids.dtype)], dim=1)

    return run


def build_generate_fn_beam(config: LlamaConfig, gen: GenerationConfig,
                           prompt_len: int, num_beams: int):
    """Beam search with the dense KV cache (the reference's
    nn/decode.py BeamSearchDecoder semantics): a fixed-shape [B, K*V]
    top-K merge per step, beam ancestry resolved by a gather_tree
    backtrace.  Finished beams emit only eos at log-prob 0 (their score
    freezes), the reference's noend row.  Each step reorders the whole
    cache by ancestry (``kcache[:, gidx]``, a copy of [L, B*K, kvH, T,
    D]), as the reference does.  Returns ``(state, ids, lengths,
    generator) -> ids [B, prompt_len + max_new_tokens]``."""
    L = config.num_hidden_layers
    K = num_beams
    T = _cache_len(prompt_len, gen.max_new_tokens)
    assert prompt_len + gen.max_new_tokens \
        <= config.max_position_embeddings
    eos = gen.eos_token_id

    def run(state, ids, lengths, generator):
        b = ids.shape[0]
        dev = ids.device
        cos, sin = _rope_tables(T, config.head_dim, config.rope_theta,
                                device=dev)
        last, kcache, vcache = _prefill_prompt(state, ids, lengths, cos,
                                               sin, config, T)
        logits_of = _logits_fn(state, config)
        lp0 = torch.log_softmax(logits_of(last).float(), dim=-1)  # [B, V]
        V = lp0.shape[-1]
        # first step: top-K over the vocab seeds the beams
        log_probs, tok = _top_k(lp0, K)                          # [B, K]
        done = torch.zeros((b, K), dtype=torch.bool, device=dev)
        if eos is not None:
            done = done | (tok == eos)
        # beams share the prefill cache: expand to [L, B*K, kvh, T, D]
        kcache = kcache.repeat_interleave(K, dim=1)
        vcache = vcache.repeat_interleave(K, dim=1)
        noend = torch.full((V,), -1e9, dtype=torch.float32, device=dev)
        if eos is not None:
            noend[eos] = 0.0
        embed = state["llama.embed_tokens.weight"]
        ws = [_layer_weights(state, i) for i in range(L)]
        beams = torch.arange(K, device=dev).expand(b, K)
        rows = torch.arange(b, device=dev)[:, None] * K
        pos = lengths.to(torch.int32)
        toks, parents = [], [beams]
        for _ in range(gen.max_new_tokens - 1):
            toks.append(tok)
            h = embed[tok.reshape(b * K)]
            posf = pos.repeat_interleave(K)
            cos1, sin1 = _rope_at(cos, sin, posf.long())
            for i, w in enumerate(ws):
                h = _decode_layer(w, h, kcache[i], vcache[i], cos1, sin1,
                                  posf, config)
            h = _rms(h, state["llama.norm.weight"], config.rms_norm_eps)
            step_lp = torch.log_softmax(logits_of(h).float(), dim=-1) \
                .reshape(b, K, V)
            # finished beams: only eos continues, at zero cost
            step_lp = torch.where(done[:, :, None], noend, step_lp)
            cand = (log_probs[:, :, None] + step_lp).reshape(b, K * V)
            log_probs, flat_idx = _top_k(cand, K)                # [B, K]
            parent = flat_idx // V
            nxt = flat_idx % V
            # reorder beam state by ancestry
            gidx = (rows + parent).reshape(-1)
            kcache = kcache[:, gidx]
            vcache = vcache[:, gidx]
            done = done.gather(1, parent)
            if eos is not None:
                nxt = torch.where(done, gen.pad_token_id, nxt)
                done = done | (nxt == eos)
            parents.append(parent)
            tok = nxt
            pos = pos + 1
        toks.append(tok)
        # backtrace ancestry (nn.functional gather_tree semantics): the
        # time-t tokens pair with parents[t], which maps time-t beams to
        # time-(t-1) beams (the seed row has identity ancestry)
        beam = beams
        seq = []
        for t_tok, t_par in zip(reversed(toks), reversed(parents)):
            seq.append(t_tok.gather(1, beam))
            beam = t_par.gather(1, beam)
        seqs = torch.stack(seq[::-1])                            # [N, B, K]
        best = torch.argmax(log_probs, dim=-1)                   # [B]
        best_seq = seqs[:, torch.arange(b, device=dev), best].T  # [B, N]
        return torch.cat([ids, best_seq.to(ids.dtype)], dim=1)

    return run


# the last generate(weight_quant=...) conversion: its quantized leaves,
# keyed by the algorithm and weak references to the source tensors (the
# reference keeps it on the model object, which the port's state-dict
# entry does not have).  It holds no source tensor, and it is dropped
# when any source tensor is freed, so it dies with the caller's state.
_WQ_CACHE: dict = {}


def _drop_quantized(token):
    if _WQ_CACHE.get("token") is token:
        _WQ_CACHE.clear()


def _quantized(state, weight_quant):
    """``state`` with every matmul weight and ``lm_head`` quantized and
    the fused q/k/v and gate/up leaves added, converted once per (source
    tensors, algorithm): serving loops call generate() per request.
    Rebinding any source weight misses and converts again."""
    src = {k: v for k, v in state.items()
           if k.endswith(MATMUL_KEYS) or k == "lm_head.weight"}
    hit = (_WQ_CACHE.get("algo") == weight_quant
           and _WQ_CACHE["src"].keys() == src.keys()
           and all(_WQ_CACHE["src"][k]() is v for k, v in src.items()))
    if not hit:
        for fin in _WQ_CACHE.get("finalizers", ()):
            fin.detach()
        _WQ_CACHE.clear()
        qstate = quantize_state(state, f"weight_only_{weight_quant}")
        token = object()
        _WQ_CACHE.update(
            algo=weight_quant, token=token,
            src={k: weakref.ref(v) for k, v in src.items()},
            leaves={k: v for k, v in qstate.items()
                    if k in src or k.endswith(_FUSED_KEYS)},
            finalizers=[weakref.finalize(v, _drop_quantized, token)
                        for v in src.values()])
    return dict(state, **_WQ_CACHE["leaves"])


def _check_state_device(state, dev):
    for name, v in state.items():
        t = v.q if isinstance(v, QuantizedWeight) else (
            v[0] if isinstance(v, tuple) else v)
        if t.device.type != dev.type or (
                dev.index is not None and t.device.index != dev.index):
            raise ValueError(
                f"generate runs on {dev}, but state[{name!r}] lies on "
                f"{t.device}; move the state there first")


def generate(model_or_state, *args, **kwargs):
    """User entry, in the reference's form ``generate(model, input_ids,
    max_new_tokens=64, ...)`` — ``model`` a ``LlamaForCausalLM`` (any
    ``nn.Layer`` with ``config`` and ``functional_state()``), which runs
    on its parameters' device unless ``device`` says otherwise — or in
    the state form ``generate(state, config, input_ids, ...)`` of
    :func:`generate_from_state`.  The two are told apart by the first
    argument: a Layer has ``functional_state``, a state dict does not.
    ``input_ids`` and ``lengths`` may be Tensor handles."""
    if not hasattr(model_or_state, "functional_state"):
        return generate_from_state(model_or_state, *args, **kwargs)
    model = model_or_state
    input_ids, rest = (args[0], args[1:]) if args else \
        (kwargs.pop("input_ids"), ())
    state = model.functional_state()
    kwargs.setdefault("device", next(iter(state.values())).device)
    unwrap = (lambda x: getattr(x, "_data", x))
    if "lengths" in kwargs:
        kwargs["lengths"] = unwrap(kwargs["lengths"])
    return generate_from_state(state, model.config, unwrap(input_ids),
                               *rest, **kwargs)


@torch.no_grad()
def generate_from_state(state, config: LlamaConfig, input_ids,
                        max_new_tokens=64, do_sample=False, temperature=1.0,
                        top_k=0, top_p=1.0, eos_token_id=None,
                        pad_token_id=0, seed=0, lengths=None, cache="dense",
                        page_size=128, weight_quant=None, num_beams=1,
                        device=None):
    """``state`` is a llama state dict (``models/convert``) with
    ``config``; ``input_ids`` [B, S] (right-padded if ``lengths``
    is given; new tokens overwrite the padded slots in the cache).
    Returns int64 ids [B, S + max_new_tokens] on ``device`` (default
    CUDA; the state must already lie there).

    ``cache="paged"`` serves from a block-table pool (K3 at
    ``page_size``): memory and attention reads scale with each
    sequence's own length instead of the batch max.  ``weight_quant``
    ("int8" | "int4") runs every matmul, fused q/k/v and gate/up and
    ``lm_head`` through the K4 GEMV.  ``num_beams > 1`` runs beam search
    with the dense cache.  ``do_sample`` draws from ``torch.Generator``
    seeded with ``seed``."""
    dev = resolve_device(device)
    _check_state_device(state, dev)
    if isinstance(input_ids, torch.Tensor):
        ids = input_ids.to(dev, torch.int64)
    else:
        ids = torch.from_numpy(np.asarray(input_ids, np.int64)).to(dev)
    b, s = ids.shape
    if lengths is None:
        lengths_np = np.full((b,), s, np.int32)
    elif isinstance(lengths, torch.Tensor):
        lengths_np = lengths.cpu().numpy().astype(np.int32)
    else:
        lengths_np = np.asarray(lengths, np.int32)
    lengths_t = torch.from_numpy(lengths_np).to(dev)
    gen = GenerationConfig(
        max_new_tokens=max_new_tokens, do_sample=do_sample,
        temperature=temperature, top_k=top_k, top_p=top_p,
        eos_token_id=eos_token_id, pad_token_id=pad_token_id, seed=seed)
    if weight_quant is not None:
        if weight_quant not in ("int8", "int4"):
            raise ValueError(f"weight_quant must be int8|int4, "
                             f"got {weight_quant!r}")
        state = _quantized(state, weight_quant)
    generator = torch.Generator(device=dev).manual_seed(seed)

    if num_beams > 1:
        if do_sample:
            raise ValueError("num_beams > 1 requires do_sample=False "
                             "(beam search is deterministic)")
        if cache == "paged":
            raise NotImplementedError(
                "beam search currently uses the dense cache "
                "(paged-beam reordering needs per-beam block tables)")
        fn = build_generate_fn_beam(config, gen, s, num_beams)
        return fn(state, ids, lengths_t, generator)

    if cache == "paged":
        pool = PagedPool(lengths_np, gen.max_new_tokens,
                         page_size=page_size,
                         min_table_width=-(-s // page_size))
        fn = build_generate_fn_paged(config, gen, s, pool.page_size,
                                     pool.num_pages, pool.max_pages)
        return fn(state, ids, lengths_t, generator,
                  torch.from_numpy(pool.table).to(dev))

    return build_generate_fn(config, gen, s)(state, ids, lengths_t,
                                             generator)
