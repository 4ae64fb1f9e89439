"""Batched gather-LoRA matmul for multi-adapter decode.

Ports ``paddle_tpu/ops/pallas/lora_matmul.py``.  One base matmul plus a
rank-r delta per row, where each row may point at a different adapter
of a packed bank (``A [N, r, K]`` / ``B [N, r, M]``, bank row 0 the
all-zero "no adapter" row)::

    delta[s] = (x[s] @ A[idx[s]].T) @ B[idx[s]] * scale[idx[s]]

:func:`lora_gather_matmul` is the wrapper of the CUDA kernels
``csrc/lora_matmul.cu`` (the port of the TPU kernel K5).  On CPU tensors
it runs :func:`_xla_gather_matmul`, the plain version (the reference's
XLA path, whose name it keeps); on CUDA tensors with at most 64 rows it
launches the kernels or raises (no probe, no quiet fallback); more rows
are prefill-shaped and take the plain version on the card too, as they
take XLA in the reference.  A call on the card is two launches, the
shrink h = x A^T split over K (:func:`_splits`, a rule of shapes) and
the expand h B by column blocks; ``lora_gather_matmul.launches`` counts
calls that launched them, one per call.

The two differ where the reference's two paths differ: the kernel
rounds h = x A^T to the bank's dtype before the second product (the
Pallas body, ``lora_matmul.py:60``), the plain version keeps h in f32.
With the serving runner's f32 bank that is no difference; with a bf16
bank it is one bf16 rounding of h, which the tests' tolerance covers.
"""
from __future__ import annotations

import ctypes

import torch

from .. import cuda_lib

__all__ = ["lora_delta", "lora_gather_matmul"]

# decode-shaped calls (at most this many slot rows) take the kernel;
# larger row counts are prefill-shaped
_GATHER_MAX_ROWS = 64
_MAX_RANK = 64                 # kMaxRank in the kernel
_MIN_CHUNK = 256               # K elements a shrink CTA reads at least
_CHUNK_ALIGN = 128             # 32 lanes x 4-element vectors
_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = (_I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
             _I, _P)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_launch = None                 # the C entry, resolved at first CUDA use


def _xla_gather_matmul(x, a, b, scale, idx):
    """The plain version: gather + two f32 einsums, [S, K] -> [S, M]."""
    il = idx.long()
    xf = x.float()
    aw = a[il].float()                                   # [S, r, K]
    bw = b[il].float()                                   # [S, r, M]
    h = torch.einsum("sk,srk->sr", xf, aw)
    out = torch.einsum("sr,srm->sm", h, bw)
    return (out * scale[il].float()[:, None]).to(x.dtype)


def _splits(k, s, sms):
    """(splits, chunk) of the shrink over K for ``s`` slots on ``sms``
    SMs: about two (split, slot) CTAs per SM (only the first slot of each
    adapter works, and a decode batch's slots name fewer adapters than
    slots), chunks of at least ``_MIN_CHUNK`` elements, each a multiple
    of ``_CHUNK_ALIGN``, and no empty split."""
    want = max(1, -(-2 * sms // s))
    most = max(1, -(-k // _MIN_CHUNK))
    chunk = -(-k // min(want, most))
    chunk = -(-chunk // _CHUNK_ALIGN) * _CHUNK_ALIGN
    return -(-k // chunk), chunk


def _aligned(t, elems):
    """Whether ``t``'s data lies on a boundary of ``elems`` elements."""
    return t.data_ptr() % (elems * t.element_size()) == 0


def _kernel(x, a, b, scale, idx):
    global _launch
    tensors = (x, a, b, scale, idx)
    if any(t.device != x.device for t in tensors):
        raise ValueError("lora_gather_matmul: all inputs must be on one "
                         f"device, got {[str(t.device) for t in tensors]}")
    if x.dtype not in _DTYPES or a.dtype not in _DTYPES \
            or b.dtype != a.dtype:
        raise TypeError("lora_gather_matmul kernel takes float32 or "
                        "bfloat16 x and one float32 or bfloat16 bank "
                        f"dtype, got {x.dtype}/{a.dtype}/{b.dtype}")
    if scale.dtype != torch.float32 or idx.dtype != torch.int32:
        raise TypeError("lora_gather_matmul: scale must be float32 and idx "
                        f"int32, got {scale.dtype}/{idx.dtype}")
    s, k = x.shape
    n, r, m = b.shape
    if tuple(scale.shape) != (n,) or tuple(idx.shape) != (s,):
        raise ValueError(
            f"lora_gather_matmul: scale {tuple(scale.shape)} must be [{n}] "
            f"and idx {tuple(idx.shape)} [{s}]")
    if not 1 <= r <= _MAX_RANK:
        raise ValueError(f"lora_gather_matmul kernel takes rank 1.."
                         f"{_MAX_RANK}, got {r}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("lora_gather_matmul kernel takes contiguous inputs")
    out = torch.empty((s, m), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    splits, chunk = _splits(k, s, cuda_lib.sm_count(x.device))
    part = cuda_lib.scratch("lora_part", x.device, stream, splits * s * r,
                            torch.float32)
    vec_x = k % 4 == 0 and _aligned(x, 4) and _aligned(a, 4)
    vec_b = m % 4 == 0 and _aligned(b, 4) and _aligned(out, 4)
    if _launch is None:
        _launch = cuda_lib.kernel("lora_matmul", "lora_gather_fwd",
                                  _ARGTYPES)
    err = _launch(_DTYPES[x.dtype], _DTYPES[a.dtype], x.data_ptr(),
                  a.data_ptr(), b.data_ptr(), scale.data_ptr(),
                  idx.data_ptr(), part.data_ptr(), out.data_ptr(), s, k, r,
                  m, splits, chunk, int(vec_x), int(vec_b), stream)
    cuda_lib.check("lora_matmul", err, "lora_gather_matmul launch")
    lora_gather_matmul.launches += 1
    return out


def lora_gather_matmul(x, a, b, scale, idx):
    """Per-row adapter delta: ``x [S, K]`` against banks ``a [N, r, K]``
    / ``b [N, r, M]`` with per-bank-row ``scale [N]`` (alpha / r) and
    per-row bank indices ``idx [S]`` int32 -> ``[S, M]`` in x's dtype."""
    if x.dim() != 2:
        raise ValueError(f"x must be [S, K], got {tuple(x.shape)}")
    if a.shape[0] != b.shape[0] or a.shape[1] != b.shape[1]:
        raise ValueError(f"bank mismatch: a {tuple(a.shape)} vs b "
                         f"{tuple(b.shape)}")
    if x.shape[1] != a.shape[2]:
        raise ValueError(f"matmul K mismatch: x has {x.shape[1]}, "
                         f"bank A {a.shape[2]}")
    if x.device.type == "cpu" or x.shape[0] > _GATHER_MAX_ROWS:
        return _xla_gather_matmul(x, a, b, scale, idx)
    return _kernel(x, a, b, scale, idx)


lora_gather_matmul.launches = 0   # calls that launched the kernels
#                                   (the main-path witness)


def lora_delta(lora, key, li, x, idx):
    """Adapter delta for projection ``key`` at layer ``li`` of a packed
    bank (``lora["a"][key] [L, N, r, K]``, ``lora["b"][key]
    [L, N, r, M]``, ``lora["scale"] [N]``).

    ``x`` is ``[..., K]``; ``idx`` is an int32 per-row bank-index vector
    aligned with ``x``'s flattened leading dims (the decode step: the
    K5 kernel), or a scalar — an int or a 0-d tensor — when the whole
    call runs under one adapter (the per-sequence prefill shape: plain
    f32 matmuls, as in the reference)."""
    a = lora["a"][key][li]                              # [N, r, K]
    b = lora["b"][key][li]                              # [N, r, M]
    scale = lora["scale"]
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if not torch.is_tensor(idx) or idx.dim() == 0:
        i = int(idx)
        h = x2.float() @ a[i].float().T
        out = ((h @ b[i].float()) * scale[i].float()).to(x.dtype)
    else:
        out = lora_gather_matmul(x2, a, b, scale, idx)
    return out.reshape(*lead, out.shape[-1])
