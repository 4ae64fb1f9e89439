"""Decode-step attention over a dense KV cache.

Ports ``paddle_tpu/ops/pallas/decode_attention.py``: ONE query token per
sequence attends over its kv-head-major cache ``[B, kvh, T, D]``, keys
``t <= pos[b]``; rep = nh / kvh query heads share each kv head (GQA).
Inference only.

:func:`decode_attention` is the wrapper of the CUDA kernel
``csrc/decode_attention.cu`` (the port of the TPU kernel K7,
``_pallas_decode``).  On CPU tensors it runs :func:`_xla_decode`, the
plain version (the reference's XLA path, whose name it keeps).  On CUDA
tensors it launches the kernel or raises, unless the caller turned the
kernel off with ``PALLAS_DECODE = False``: then the plain version runs
on the card too.

The default differs from the reference's, on purpose.  The reference
keeps its kernel off because on a v5e the TPU's sequential grid lost to
XLA's fused einsum.  On the H100 the alternative is the plain eager
version, which writes the whole cache ``rep`` times (the head repeat)
and runs an f32 einsum and a softmax over it; so the port's kernel is
on by default and off is the explicit opt-out.

The kernel rounds the unnormalised probabilities to v's dtype before
P.V (as the TPU kernel does), the plain version rounds the normalised
ones.  In float32 that is no difference; in bf16 it is within one bf16
rounding of the output.  A row with ``pos < 0`` sees no key: the kernel
writes zeros there and the plain version NaN (generation never passes
one).
"""
from __future__ import annotations

import ctypes
import math

import torch

from .. import cuda_lib

__all__ = ["decode_attention"]

PALLAS_DECODE = True           # False: the plain version runs on the card
_MAX_REP = 16                  # kMaxRep in the kernel
_HEAD_DIM = 128                # the one head_dim the kernel is built for
_CHUNK = 256                   # kChunk: keys per CTA of the first pass
_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = (_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
             ctypes.c_float, _P)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_launch = None                 # the C entry, resolved at first CUDA use


def decode_attention(q, kcache, vcache, pos):
    """One-token cache attention: q [B, nh, D], caches [B, kvh, T, D]
    (kv-head-major), pos [B] int32, the index of the CURRENT token
    (entries t <= pos attend).  Returns [B, nh, D] in q's dtype."""
    global _launch
    if q.device.type == "cpu" or not PALLAS_DECODE:
        return _xla_decode(q, kcache, vcache, pos)
    b, nh, d, kvh, t = _check(q, kcache, vcache, pos)
    n_chunks = -(-t // _CHUNK)
    out = torch.empty_like(q)
    part_m = torch.empty((b, nh, n_chunks), dtype=torch.float32,
                         device=q.device)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((b, nh, n_chunks, d), dtype=torch.float32,
                           device=q.device)
    if _launch is None:
        _launch = cuda_lib.kernel("decode_attention", "decode_attention_fwd",
                                  _ARGTYPES)
    err = _launch(_DTYPES[q.dtype], d, q.data_ptr(), kcache.data_ptr(),
                  vcache.data_ptr(), pos.data_ptr(), out.data_ptr(),
                  part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr(),
                  b, kvh, nh // kvh, t, n_chunks, 1.0 / math.sqrt(d),
                  torch.cuda.current_stream(q.device).cuda_stream)
    cuda_lib.check("decode_attention", err, "decode_attention launch")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0  # kernel launches (the main-path witness)


def _check(q, kcache, vcache, pos):
    """Validate what the kernel takes; raise on anything else."""
    tensors = (q, kcache, vcache, pos)
    if any(t.device != q.device for t in tensors):
        raise ValueError("decode_attention: all inputs must be on one "
                         f"device, got {[str(t.device) for t in tensors]}")
    if q.dtype not in _DTYPES or kcache.dtype != q.dtype \
            or vcache.dtype != q.dtype:
        raise TypeError(
            "decode_attention kernel takes float32 or bfloat16 q/k/v of "
            f"one dtype, got {q.dtype}/{kcache.dtype}/{vcache.dtype}")
    if pos.dtype != torch.int32:
        raise TypeError(f"decode_attention: pos must be int32, got "
                        f"{pos.dtype}")
    if q.dim() != 3 or kcache.dim() != 4 or kcache.shape != vcache.shape:
        raise ValueError(
            f"decode_attention: q {tuple(q.shape)} must be [B, nh, D] and "
            f"caches {tuple(kcache.shape)}/{tuple(vcache.shape)} equal "
            "[B, kvh, T, D]")
    b, nh, d = q.shape
    kvh, t = kcache.shape[1], kcache.shape[2]
    if d != _HEAD_DIM or kcache.shape[3] != d:
        raise ValueError(f"decode_attention kernel takes head_dim "
                         f"{_HEAD_DIM}, got q {d} / cache {kcache.shape[3]}")
    if kcache.shape[0] != b or tuple(pos.shape) != (b,):
        raise ValueError(
            f"decode_attention: caches {tuple(kcache.shape)} and pos "
            f"{tuple(pos.shape)} must have B={b} rows")
    if nh % kvh or not 1 <= nh // kvh <= _MAX_REP:
        raise ValueError(f"decode_attention: {nh} q heads must group onto "
                         f"{kvh} kv heads, at most {_MAX_REP} per group")
    if t < 1:
        raise ValueError("decode_attention: the cache holds no position")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("decode_attention kernel takes contiguous inputs")
    if q.data_ptr() % 16 or kcache.data_ptr() % 16 \
            or vcache.data_ptr() % 16:
        raise ValueError("decode_attention: q and caches must be 16-byte "
                         "aligned")
    return b, nh, d, kvh, t


def _xla_decode(q, kcache, vcache, pos):
    """The plain version, with the reference's numerics: f32 logits over
    the head-repeated cache, keys t <= pos, f32 softmax, probabilities
    cast to q's dtype, then P.V."""
    b, nh, d = q.shape
    kvh = kcache.shape[1]
    rep = nh // kvh
    kq = kcache.repeat_interleave(rep, dim=1)           # [B, nh, T, D]
    vq = vcache.repeat_interleave(rep, dim=1)
    logits = torch.einsum("bhd,bhtd->bht", q.float(), kq.float()) \
        / math.sqrt(d)
    tpos = torch.arange(kcache.shape[2], device=q.device)
    valid = tpos[None, None, :] <= pos.to(q.device)[:, None, None]
    logits = logits.masked_fill(~valid, -math.inf)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bht,bhtd->bhd", probs, vq)
