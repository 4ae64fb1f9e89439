"""Decode-step attention over a dense KV cache.

Ports ``paddle_tpu/ops/pallas/decode_attention.py``: ONE query token per
sequence attends over its kv-head-major cache ``[B, kvh, T, D]``, keys
``t <= pos[b]``; rep = nh / kvh query heads share each kv head (GQA).
Inference only.

Routes, as the reference's ``decode_attention`` (``:164-172``) takes
them: head dims 64, 128 and 256 with ``nh % kvh == 0`` reach the kernel,
any GQA group; every other head dim runs the plain version
:func:`_xla_decode` (the reference's XLA path, whose name it keeps), on
the card too.  :func:`_route` is that rule.

:func:`decode_attention` is the wrapper of the CUDA kernel
``csrc/decode_attention.cu`` (the port of the TPU kernel K7,
``_pallas_decode``).  On CPU tensors it runs the plain version.  On CUDA
tensors it launches the kernel or raises, unless the head dim routes to
the plain version or the caller turned the kernel off with
``PALLAS_DECODE = False``: then the plain version runs on the card too.

The default differs from the reference's, on purpose.  The reference
keeps its kernel off because on a v5e the TPU's sequential grid lost to
XLA's fused einsum.  On the H100 the alternative is the plain eager
version, which writes the whole cache ``rep`` times (the head repeat)
and runs an f32 einsum and a softmax over it; so the port's kernel is
on by default and off is the explicit opt-out.

The kernel makes one launch per call.  It splits the keys of each
(sequence, kv head, group of 16 query heads) over :func:`_splits` CTAs,
chosen from the CTA count, the head dim and the cache length T (the
longest visible length the host knows without a sync), and the last CTA
of a row merges the splits, using a counter per row that it leaves at
zero.  The partials and counters live in buffers kept per device and
stream (:func:`cuda_lib.scratch`), so calls on one device must run on
one stream at a time.

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
# head dims the reference's decode_attention sends to its kernel
# (decode_attention.py:164-172); the port's kernel is built for each
KERNEL_HEAD_DIMS = (64, 128, 256)
_TILE = 64                     # kTile: keys per ring stage
_MIN_CHUNK = 256               # keys of a split, at least
_MAX_SPLIT = 64                # kMaxSplit
_F32_CHUNK = 256               # kChunkF32: keys per CTA of the f32 pass
_SMEM_PER_SM = 228 * 1024      # shared memory of an sm_90 SM
_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = (_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
             ctypes.c_float, _P)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_launch = None                 # the C entry, resolved at first CUDA use


def _route(head_dim):
    """"kernel" or "plain": how a CUDA call at ``head_dim`` runs, by the
    reference's rule (any GQA group goes to the kernel)."""
    return "kernel" if head_dim in KERNEL_HEAD_DIMS else "plain"


def _splits(ctas, t, sms, d=128):
    """(n_split, chunk): key splits of ``chunk`` keys (a multiple of 64)
    for ``ctas`` (sequence, kv head, group) rows over a cache of ``t``
    keys, as many as the card holds at once: ``sms`` times the CTAs an
    SM takes at head_dim ``d`` (by shared memory: 4, 2 and 1 at d 64,
    128 and 256, so that at d 128 the grid covers two waves of the SMs);
    one split where the rows fill those slots already or t fits one
    chunk.  A last wave that only part of the card runs would set the
    time."""
    slots = sms * (_SMEM_PER_SM // (_smem(d) + 1024))
    if ctas * 2 > slots or t <= _MIN_CHUNK:
        return 1, -(-t // _TILE) * _TILE
    want = min(slots // ctas, -(-t // _MIN_CHUNK), _MAX_SPLIT)
    chunk = -(-(-(-t // want)) // _TILE) * _TILE
    return -(-t // chunk), chunk


def _smem(d):
    """The bf16 kernel's shared memory at head_dim d (Smem<D>::kBytes):
    Q [16, d] and three stages of K and V [64, d] tiles."""
    return (16 + 3 * 2 * _TILE) * d * 2


def decode_attention(q, kcache, vcache, pos):
    """One-token cache attention: q [B, nh, D], caches [B, kvh, T, D]
    (kv-head-major), pos [B] int32, the index of the CURRENT token
    (entries t <= pos attend).  Returns [B, nh, D] in q's dtype."""
    global _launch
    if (q.device.type == "cpu" or not PALLAS_DECODE
            or _route(q.shape[-1]) == "plain"):
        return _xla_decode(q, kcache, vcache, pos)
    b, nh, d, kvh, t = _check(q, kcache, vcache, pos)
    rep = nh // kvh
    dev = q.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    out = torch.empty_like(q)
    part_ml = part_o = tickets = None
    if q.dtype == torch.float32:
        n_split, chunk = -(-t // _F32_CHUNK), _F32_CHUNK
        n_ml, n_o = b * nh * n_split * 2, b * nh * n_split * d
    else:
        ctas = b * kvh * -(-rep // 16)
        n_split, chunk = _splits(ctas, t, cuda_lib.sm_count(dev), d)
        n_ml, n_o = ctas * n_split * 16 * 2, ctas * n_split * 16 * d
        if n_split > 1:
            tickets = cuda_lib.scratch("decode_attention.tickets", dev,
                                       stream, ctas, torch.int32,
                                       zeroed=True).data_ptr()
    if q.dtype == torch.float32 or n_split > 1:
        part = cuda_lib.scratch("decode_attention.partials", dev, stream,
                                n_ml + n_o, torch.float32)
        part_ml, part_o = part.data_ptr(), part.data_ptr() + 4 * n_ml
    if _launch is None:
        _launch = cuda_lib.kernel("decode_attention", "decode_attention_fwd",
                                  _ARGTYPES)
    err = _launch(_DTYPES[q.dtype], d, q.data_ptr(), kcache.data_ptr(),
                  vcache.data_ptr(), pos.data_ptr(), out.data_ptr(),
                  part_ml, part_o, tickets, b, kvh, rep, t, n_split, chunk,
                  1.0 / math.sqrt(d), stream)
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
    if d not in KERNEL_HEAD_DIMS or kcache.shape[3] != d:
        raise ValueError(f"decode_attention kernel takes head_dim "
                         f"{KERNEL_HEAD_DIMS}, got q {d} / cache "
                         f"{kcache.shape[3]}")
    if kcache.shape[0] != b or tuple(pos.shape) != (b,):
        raise ValueError(
            f"decode_attention: caches {tuple(kcache.shape)} and pos "
            f"{tuple(pos.shape)} must have B={b} rows")
    if nh % kvh:
        raise ValueError(f"decode_attention: {nh} q heads must group onto "
                         f"{kvh} kv heads")
    if t < 1:
        raise ValueError("decode_attention: the cache holds no position")
    if b * kvh > 65535:
        raise ValueError(f"decode_attention: B * kvh = {b * kvh} rows, at "
                         "most 65535")
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
