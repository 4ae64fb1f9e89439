"""Scaled-dot-product attention dispatch and flash attention (K1/K2).

Ports ``sdpa``, ``_xla_sdpa``, ``_pallas_sdpa``, ``flash_mha``,
``MASK_VAL`` and ``LSE_INVALID`` from
``paddle_tpu/ops/pallas/flash_attention.py`` (Paddle layout
[B, S, H, D] at ``sdpa``).  The dispatch mirrors the reference's
(``:249-339``), with ``_SHORT_SEQ_XLA = 0`` (``:246``):

  * no mask and no dropout runs :func:`_pallas_sdpa` ->
    :func:`flash_mha`, the flash forward with lse (the CUDA K1 kernel)
    whose backward is the recompute-from-lse dq and dk/dv kernels (K2),
    all in ``csrc/flash_attention.cu``;
  * a bool key-padding ``attn_mask`` [B, 1|H, 1, Sk] (the serving
    prefill mask) becomes flashmask intervals and an explicit
    ``flashmask`` [B|1, H|1, 2|4, Sk] goes as it is to the masked flash
    attention (``flash_mask.flash_mha_masked``, the CUDA K8 kernels);
  * a float ``attn_mask`` [B|1, H|1|kvH, Sq, Sk] is an additive bias for
    the biased flash attention (``flash_mask.flash_mha_biased``, the same
    K8 kernels with the bias operand, and the dbias kernel when the bias
    needs a gradient);
  * any other mask (an arbitrary bool mask such as the cached-suffix
    prefill's [1, 1, S, T], or a float mask of another shape such as a
    [B, 1, 1, Sk] additive padding mask) and dropout run
    :func:`_xla_sdpa`, as they do on the TPU.
The masked and biased routes are differentiable, like the unmasked one.

Numerics.  The CUDA kernels and the plain versions
(:func:`_flash_fwd_xla`, :func:`_flash_bwd_dq_xla`,
:func:`_flash_bwd_dkv_xla`) follow the Pallas kernels ``_fwd_kernel``
(``:523``), ``_bwd_dq_kernel`` (``:925``) and ``_bwd_dkv_kernel``
(``:960``), not the XLA path: f32 logits, row max and row sum;
unnormalised probabilities rounded to v's dtype before P.V; rows with
no visible key give zeros and ``lse = LSE_INVALID``; the backward
recomputes p from lse, takes ``delta = rowsum(out * dout)`` in f32 and
rounds ds to the input dtype before the dq and dk products.  The one
difference from the Pallas path: dk/dv of a GQA group are summed in f32
before the one rounding to k's dtype (the reference rounds per q head,
then sums) — identical in float32.

Head dims route as the reference's ``sdpa`` routes them
(``:264-269``), by :func:`_route`: on CUDA tensors d in
``KERNEL_HEAD_DIMS`` = {64, 128, 256} goes to the kernels, which are
built for each of the three, and every other d to the plain versions
(the reference's XLA route, chosen by the same shape rule: exactly what
a CPU tensor runs).

The reference's ``S >= 128`` floor, its padding to 128 and its
streamed-variant switch past 4096 tokens are TPU tiling and VMEM
limits: on the card one kernel of each kind takes every length, with the
ragged edge masked in-kernel.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from .. import cuda_lib

__all__ = ["sdpa", "flash_mha", "MASK_VAL", "LSE_INVALID"]

# Finite stand-in for -inf so blockwise max/exp arithmetic never forms
# (-inf) - (-inf): masked logits underflow exp() to exactly 0.
MASK_VAL = -0.7 * float(np.finfo(np.float32).max)
# lse sentinel for rows with no visible key: exp(s - BIG) == 0 for any
# representable s, so a backward treats the whole row as zero-probability.
LSE_INVALID = float(np.finfo(np.float32).max) * 0.5


def _xla_sdpa(q, k, v, attn_mask=None, is_causal=False, dropout_p=0.0,
              training=True, generator=None, scale=None):
    """Plain PyTorch attention with the reference ``_xla_sdpa``'s full
    semantics (whose name it keeps): f32 logits, probabilities cast to
    the input dtype, GQA by repeating kv heads, bottom-right causal
    alignment, bool masks (True = attend) or additive float masks, and
    rows with no visible key written as zeros.  ``scale`` defaults to
    1/sqrt(D)."""
    qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    d = q.shape[-1]
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    if kh.shape[1] != qh.shape[1]:            # grouped-query attention
        rep = qh.shape[1] // kh.shape[1]
        kh = kh.repeat_interleave(rep, dim=1)
        vh = vh.repeat_interleave(rep, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", qh.float(), kh.float()) * scale
    masked = None
    if is_causal:
        sq, sk = logits.shape[-2], logits.shape[-1]
        cmask = torch.ones(sq, sk, dtype=torch.bool,
                           device=q.device).tril(sk - sq)
        logits = logits.masked_fill(~cmask, -math.inf)
        masked = cmask.expand(logits.shape)
    if attn_mask is not None:
        if attn_mask.dtype == torch.bool:
            logits = logits.masked_fill(~attn_mask, -math.inf)
            am = attn_mask.expand(logits.shape)
            masked = am if masked is None else masked & am
        else:
            logits = logits + attn_mask.to(logits.dtype)
    if masked is not None:
        # rows with no visible key would softmax over all -inf -> NaN;
        # give them finite logits, then zero their probabilities
        row_ok = masked.any(dim=-1, keepdim=True)
        logits = torch.where(row_ok, logits, torch.zeros((), device=q.device))
        probs = torch.softmax(logits, dim=-1).to(q.dtype)
        probs = torch.where(row_ok, probs,
                            torch.zeros((), dtype=probs.dtype,
                                        device=q.device))
    else:
        probs = torch.softmax(logits, dim=-1).to(q.dtype)
    if dropout_p > 0.0 and training:
        keep = torch.rand(probs.shape, generator=generator,
                          device=probs.device) >= dropout_p
        probs = torch.where(keep, probs / (1.0 - dropout_p),
                            torch.zeros((), dtype=probs.dtype,
                                        device=probs.device))
    out = torch.einsum("bhqk,bhkd->bhqd", probs, vh)
    return out.transpose(1, 2)


def sdpa(q, k, v, attn_mask=None, dropout_p=0.0, is_causal=False,
         training=True, flashmask=None, generator=None):
    """Paddle-layout scaled-dot-product attention: [B, S, H, D] in/out
    (k/v may carry fewer heads: GQA).  See the module docstring for the
    routes."""
    from .flash_mask import dense_mask_from_intervals, \
        padding_mask_to_intervals

    if dropout_p > 0.0:
        if flashmask is not None:
            if attn_mask is not None:
                raise ValueError("pass attn_mask or flashmask, not both")
            attn_mask = dense_mask_from_intervals(flashmask, q.shape[1],
                                                  k.shape[1])
        return _xla_sdpa(q, k, v, attn_mask=attn_mask,
                         is_causal=is_causal, dropout_p=dropout_p,
                         training=training, generator=generator)
    mask_vecs = flashmask
    if attn_mask is not None and mask_vecs is None:
        if (attn_mask.dtype == torch.bool and attn_mask.dim() == 4
                and attn_mask.shape[2] == 1
                and attn_mask.shape[-1] == k.shape[1]):
            # key-padding mask (per-batch or per-head): columns allowed
            # for all rows or none
            mask_vecs = padding_mask_to_intervals(attn_mask[:, :, 0, :],
                                                  q.shape[1])
        elif (attn_mask.is_floating_point() and attn_mask.dim() == 4
              and attn_mask.shape[-2:] == (q.shape[1], k.shape[1])):
            return _sdpa_biased(q, k, v, attn_mask, is_causal)
        else:
            return _xla_sdpa(q, k, v, attn_mask=attn_mask,
                             is_causal=is_causal)
    if mask_vecs is None:
        return _pallas_sdpa(q, k, v, is_causal)
    return _sdpa_masked(q, k, v, mask_vecs, is_causal)


def _sdpa_masked(q, k, v, mask_vecs, causal):
    """[B, S, H, D] wrapper of the masked flash attention (the reference's
    ``_pallas_sdpa_masked`` without the 128-padding: the kernels take any
    length and read the transposed views through their strides)."""
    from .flash_mask import flash_mha_masked
    h, hm = q.shape[2], mask_vecs.shape[1]
    if hm not in (1, h):                 # per-kv-head mask under GQA
        mask_vecs = mask_vecs.repeat_interleave(h // hm, dim=1)
    out = flash_mha_masked(q.transpose(1, 2), k.transpose(1, 2),
                           v.transpose(1, 2), mask_vecs, causal,
                           1.0 / math.sqrt(q.shape[-1]))
    return out.transpose(1, 2)


def _sdpa_biased(q, k, v, bias, causal):
    """[B, S, H, D] wrapper of the biased flash attention (the reference's
    ``_pallas_sdpa_biased`` at ``:466-482``): a per-kv-head bias is
    repeated to q heads (its gradient flows back through the repeat); no
    128-padding and no -1e9 tail, since the kernels mask the ragged edge
    themselves."""
    from .flash_mask import flash_mha_biased
    h, hb = q.shape[2], bias.shape[1]
    if hb not in (1, h):
        bias = bias.repeat_interleave(h // hb, dim=1)
    out = flash_mha_biased(q.transpose(1, 2), k.transpose(1, 2),
                           v.transpose(1, 2), bias, causal,
                           1.0 / math.sqrt(q.shape[-1]))
    return out.transpose(1, 2)


def _pallas_sdpa(q, k, v, causal):
    """[B, S, H, D] wrapper of :func:`flash_mha` (the reference's
    ``_pallas_sdpa`` at ``:438`` without the padding: the kernels take any
    length and read the transposed views through their strides)."""
    out = flash_mha(q.transpose(1, 2), k.transpose(1, 2),
                    v.transpose(1, 2), causal, 1.0 / math.sqrt(q.shape[-1]))
    return out.transpose(1, 2)


# ------------------------------------------------------ plain versions
def _expand_kv(x, group):
    """[B, kvH, S, D] -> [B, H, S, D] (GQA: q head h reads kv head
    h // group)."""
    return x if group == 1 else x.repeat_interleave(group, dim=1)


def _masked_logits(q, k, causal, sm_scale):
    """f32 logits [B, H, Sq, Sk] = (q . k) * sm_scale, invisible keys set
    to MASK_VAL (``_visible``: bottom-right causal, offset Sk - Sq)."""
    kf = _expand_kv(k, q.shape[1] // k.shape[1]).float()
    s = torch.matmul(q.float(), kf.transpose(-1, -2)) * sm_scale
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        vis = torch.ones(sq, sk, dtype=torch.bool,
                         device=q.device).tril(sk - sq)
        s = s.masked_fill(~vis, MASK_VAL)
    return s


def _flash_fwd_xla(q, k, v, causal, sm_scale):
    """Plain version of the K1 forward (``_fwd_kernel``): [B, H, Sq, D]
    q, [B, kvH, Sk, D] k/v -> (out [B, H, Sq, D] in q's dtype, lse
    [B, H, Sq] f32).  Rows with no visible key: zeros, LSE_INVALID."""
    s = _masked_logits(q, k, causal, sm_scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    del s
    l = p.sum(dim=-1, keepdim=True)
    vv = _expand_kv(v, q.shape[1] // k.shape[1])
    acc = torch.matmul(p.to(v.dtype).float(), vv.float())
    row_ok = m > MASK_VAL * 0.5                 # some key was visible
    out = torch.where(row_ok, acc / torch.where(row_ok, l, 1.0), 0.0)
    lse = torch.where(row_ok, m + torch.log(torch.where(row_ok, l, 1.0)),
                      LSE_INVALID)
    return out.to(q.dtype), lse[..., 0]


def _bwd_p_ds(q, k, v, out, lse, dout, causal, sm_scale):
    """p = exp(s - lse) and ds = p * (dp - delta) * sm_scale, both f32
    [B, H, Sq, Sk]; delta = rowsum(out * dout) in f32."""
    p = torch.exp(_masked_logits(q, k, causal, sm_scale) - lse[..., None])
    vv = _expand_kv(v, q.shape[1] // k.shape[1])
    dp = torch.matmul(dout.float(), vv.float().transpose(-1, -2))
    delta = (out.float() * dout.float()).sum(dim=-1, keepdim=True)
    return p, p * (dp - delta) * sm_scale


def _flash_bwd_dq_xla(q, k, v, out, lse, dout, causal, sm_scale):
    """Plain version of the K2 dq kernel (``_bwd_dq_kernel``)."""
    _, ds = _bwd_p_ds(q, k, v, out, lse, dout, causal, sm_scale)
    kf = _expand_kv(k, q.shape[1] // k.shape[1]).float()
    return torch.matmul(ds.to(k.dtype).float(), kf).to(q.dtype)


def _group_sum(x, kvh):
    """[B, H, S, D] per-q-head f32 -> [B, kvH, S, D] summed per group."""
    b, h, s, d = x.shape
    return x.view(b, kvh, h // kvh, s, d).sum(dim=2)


def _flash_bwd_dkv_xla(q, k, v, out, lse, dout, causal, sm_scale):
    """Plain version of the K2 dk/dv kernel (``_bwd_dkv_kernel``, with
    the group sum of ``:1064-1066``): (dk, dv) [B, kvH, Sk, D]."""
    p, ds = _bwd_p_ds(q, k, v, out, lse, dout, causal, sm_scale)
    kvh = k.shape[1]
    dv = torch.matmul(p.to(dout.dtype).float().transpose(-1, -2),
                      dout.float())
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2), q.float())
    return (_group_sum(dk, kvh).to(k.dtype), _group_sum(dv, kvh).to(v.dtype))


def _flash_bwd_xla(q, k, v, out, lse, dout, causal, sm_scale):
    """Plain version of the K2 backward: (dq, dk, dv)."""
    dq = _flash_bwd_dq_xla(q, k, v, out, lse, dout, causal, sm_scale)
    dk, dv = _flash_bwd_dkv_xla(q, k, v, out, lse, dout, causal, sm_scale)
    return dq, dk, dv


# ------------------------------------------------------ kernel wrappers
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# dtype, head_dim, q, k, v, out, lse, B, H, group, sq, sk, causal, scale,
# strides, stream
_FWD_ARGS = (_I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P, _P)
# dq: dtype, head_dim, q, k, v, out, dout, lse, delta, dq, B, H, group,
# sq, sk, causal, scale, strides, stream; dk/dv: the same with (dout,
# lse, delta, dk, dv) in place of (out, dout, lse, delta, dq) and kvH
# in place of H
_BWD_ARGS = (_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
             _F, _P, _P)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# head dims the reference's sdpa sends to its kernels (:264-269), each
# of which the port's kernels are built for
KERNEL_HEAD_DIMS = (64, 128, 256)
_entries = {}                  # C entry name -> ctypes function


def _route(head_dim):
    """"kernel" or "plain": how a CUDA call at ``head_dim`` runs, by the
    reference's rule (K1/K2, and K8 through ``flash_mask``)."""
    return "kernel" if head_dim in KERNEL_HEAD_DIMS else "plain"


def _entry(symbol, argtypes):
    fn = _entries.get(symbol)
    if fn is None:
        fn = _entries[symbol] = cuda_lib.kernel("flash_attention", symbol,
                                                argtypes)
    return fn


def _strided_ok(t):
    vec = 16 // t.element_size()
    return (t.stride(3) == 1 and t.data_ptr() % 16 == 0
            and all(s % vec == 0 for s in t.stride()[:3]))


def _check(q, k, v, *more, name="flash_mha"):
    """Validate what the kernels take; raise on anything else."""
    tensors = (q, k, v, *more)
    if q.device.type != "cuda":
        raise ValueError(f"{name} kernels take CUDA tensors, got "
                         f"{q.device}")
    if any(t.device != q.device for t in tensors):
        raise ValueError(f"{name}: all inputs must be on one device, got "
                         f"{[str(t.device) for t in tensors]}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name} kernels take float32 or bfloat16 q/k/v "
                        f"of one dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"{name}: q {tuple(q.shape)} must be "
                         f"[B, H, Sq, D] and k/v {tuple(k.shape)}/"
                         f"{tuple(v.shape)} equal [B, kvH, Sk, D]")
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    if d not in KERNEL_HEAD_DIMS or k.shape[3] != d or k.shape[0] != b:
        raise ValueError(f"{name} kernels take head_dim "
                         f"{sorted(KERNEL_HEAD_DIMS)} (k's as q's) and "
                         f"matching batch, got q {tuple(q.shape)} k "
                         f"{tuple(k.shape)}")
    if h % kvh or sq < 1 or sk < 1:
        raise ValueError(f"{name}: {h} q heads must group onto {kvh} kv "
                         "heads, and Sq/Sk must be >= 1")
    for label, t in (("q", q), ("k", k), ("v", v)):
        if not _strided_ok(t):
            raise ValueError(
                f"{name}: {label} needs a contiguous head dim, a 16-byte "
                "aligned base and strides divisible by "
                f"{16 // t.element_size()} elements, got {t.stride()}")
    return b, h, sq, d, kvh, sk


def _bshd_empty_like(x):
    """An empty [B, H, S, D] tensor stored as [B, S, H, D] (what
    ``sdpa``'s transposes want: the transpose back is free)."""
    b, h, s, d = x.shape
    return torch.empty((b, s, h, d), dtype=x.dtype,
                       device=x.device).transpose(1, 2)


def _strides(*tensors):
    return (ctypes.c_longlong * (3 * len(tensors)))(
        *(s for t in tensors for s in t.stride()[:3]))


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _flash_fwd(q, k, v, causal, sm_scale):
    """K1 forward: (out [B, H, Sq, D], lse [B, H, Sq] f32).  CPU tensors
    and head dims that :func:`_route` sends to the plain version take
    :func:`_flash_fwd_xla`; other CUDA tensors launch the kernel."""
    if q.device.type == "cpu" or _route(q.shape[-1]) == "plain":
        return _flash_fwd_xla(q, k, v, causal, sm_scale)
    b, h, sq, d, kvh, sk = _check(q, k, v)
    out = _bshd_empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    err = _entry("flash_attention_fwd", _FWD_ARGS)(
        _DTYPES[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), lse.data_ptr(), b, h, h // kvh, sq, sk,
        int(bool(causal)), float(sm_scale), _strides(q, k, v, out),
        _stream(q))
    cuda_lib.check("flash_attention", err, "flash_mha forward launch")
    flash_mha.fwd_launches += 1
    return out, lse


def _bwd_inputs(q, k, v, lse, dout, *rows):
    """Validate the backward's inputs; returns the shapes and lse/dout
    (and the [B, H, Sq] f32 ``rows``, e.g. delta) as the kernels take
    them."""
    b, h, sq, d, kvh, sk = _check(q, k, v, lse, dout, *rows)
    if dout.dtype != q.dtype or dout.shape != q.shape:
        raise ValueError(f"flash_mha backward: dout must be {q.dtype} "
                         f"{tuple(q.shape)}, got {dout.dtype} "
                         f"{tuple(dout.shape)}")
    for name, t in (("lse", lse), *(("delta", r) for r in rows)):
        if t.dtype != torch.float32 or t.shape != (b, h, sq):
            raise ValueError(f"flash_mha backward: {name} must be float32 "
                             f"{(b, h, sq)}, got {t.dtype} {tuple(t.shape)}")
    if not _strided_ok(dout):          # e.g. an expanded cotangent
        dout = dout.contiguous()
    return ((b, h, sq, d, kvh, sk), lse.contiguous(), dout,
            *(r.contiguous() for r in rows))


def _flash_bwd_dq(q, k, v, out, lse, dout, causal, sm_scale):
    """K2 dq kernel: (dq, delta [B, H, Sq] f32).  The kernel derives
    delta = rowsum(out * dout) for its rows and writes it out for the
    dk/dv kernel."""
    (b, h, sq, d, kvh, sk), lse, dout = _bwd_inputs(q, k, v, lse, dout)
    if (out.device != q.device or out.dtype != q.dtype
            or out.shape != q.shape or not _strided_ok(out)):
        raise ValueError(f"flash_mha backward: out must be like q, got "
                         f"{out.dtype} {tuple(out.shape)} {out.stride()}")
    dq = _bshd_empty_like(q)
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    err = _entry("flash_attention_bwd_dq", _BWD_ARGS)(
        _DTYPES[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        dq.data_ptr(), b, h, h // kvh, sq, sk, int(bool(causal)),
        float(sm_scale), _strides(q, k, v, out, dout, dq), _stream(q))
    cuda_lib.check("flash_attention", err, "flash_mha dq launch")
    flash_mha.dq_launches += 1
    return dq, delta


def _flash_bwd_dkv(q, k, v, lse, delta, dout, causal, sm_scale):
    """K2 dk/dv kernel: one CTA per (64-key block, kv head, batch) loops
    over the group's q heads, so dk/dv come out summed per group."""
    (b, h, sq, d, kvh, sk), lse, dout, delta = _bwd_inputs(q, k, v, lse,
                                                           dout, delta)
    dk, dv = _bshd_empty_like(k), _bshd_empty_like(v)
    err = _entry("flash_attention_bwd_dkv", _BWD_ARGS)(
        _DTYPES[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), b, kvh, h // kvh, sq, sk, int(bool(causal)),
        float(sm_scale), _strides(q, k, v, dout, dk, dv), _stream(q))
    cuda_lib.check("flash_attention", err, "flash_mha dkv launch")
    flash_mha.dkv_launches += 1
    return dk, dv


def _flash_bwd(q, k, v, out, lse, dout, causal, sm_scale):
    """K2 backward: (dq, dk, dv).  CPU tensors take
    :func:`_flash_bwd_xla`; CUDA tensors launch the dq kernel, then the
    dk/dv kernel (which reads the delta the first one wrote)."""
    if q.device.type == "cpu" or _route(q.shape[-1]) == "plain":
        return _flash_bwd_xla(q, k, v, out, lse, dout, causal, sm_scale)
    dq, delta = _flash_bwd_dq(q, k, v, out, lse, dout, causal, sm_scale)
    dk, dv = _flash_bwd_dkv(q, k, v, lse, delta, dout, causal, sm_scale)
    return dq, dk, dv


class _FlashMHA(torch.autograd.Function):
    """The counterpart of the reference's ``custom_vjp`` (``:1071-1113``):
    the forward saves (q, k, v, out, lse); the backward recomputes p from
    lse.  Under ``torch.utils.checkpoint`` the forward runs again in the
    backward pass and saves the recomputed out and lse."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale):
        out, lse = _flash_fwd(q, k, v, causal, sm_scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(q, k, v, out, lse, dout, ctx.causal,
                                ctx.sm_scale)
        return dq, dk, dv, None, None


def flash_mha(q, k, v, causal, sm_scale):
    """[B, H, Sq, D] flash attention, differentiable, O(S) memory; k/v
    [B, kvH, Sk, D] with H % kvH == 0 (GQA, no repeat).  Any Sq, Sk;
    causal is bottom-right aligned.  CUDA inputs run the K1 forward and
    the K2 backward kernels (float32 or bfloat16, head_dim 64, 128 or
    256, strided views with a contiguous head dim); CPU inputs, and head
    dims outside {64, 128, 256}, run the plain versions."""
    return _FlashMHA.apply(q, k, v, bool(causal), float(sm_scale))


# kernel launches (the main-path witnesses), counted by the wrappers
flash_mha.fwd_launches = 0
flash_mha.dq_launches = 0
flash_mha.dkv_launches = 0
