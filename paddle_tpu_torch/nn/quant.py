"""Weight-only quantization for serving (``paddle.nn.quant``).

Ports the per-channel branch of ``paddle_tpu/nn/quant.py``
(``weight_quantize``, ``weight_dequantize``): symmetric scales per
output column, int8 values ``[K, N]`` or int4 values nibble-packed
``[K/2, N]`` (row 2k in the low nibble).  The arithmetic is the
reference's, in the same order and in float32 — IEEE division and
round half to even on both sides — so on the CPU the values and scales
are bit-identical to the JAX package's.  Grouped scales (``group_size``
64 or 128) are not ported yet (ROADMAP queue 1, Paddle API surface).
"""
from __future__ import annotations

import torch

from ..ops.pallas.quant_matmul import pack_int4, unpack_int4

__all__ = ["weight_dequantize", "weight_quantize"]

_BOUNDS = {"weight_only_int8": 127.0, "weight_only_int4": 7.0,
           "llm.int8": 127.0}


def _check(algo, group_size):
    if algo not in _BOUNDS:
        raise ValueError(
            f"algo must be one of {sorted(_BOUNDS)}, got {algo!r}")
    if group_size not in (-1, 64, 128):
        raise ValueError(f"group_size must be -1, 64 or 128, "
                         f"got {group_size}")
    if group_size != -1:
        raise NotImplementedError(
            f"group_size={group_size}: grouped scales are not ported yet "
            "(ROADMAP queue 1, Paddle API surface)")


def weight_quantize(x, algo="weight_only_int8", arch=None, group_size=-1):
    """[K, N] float weight -> (quantized values, f32 scales [N]).

    int8: values [K, N] int8.  int4: values nibble-packed [K/2, N] int8.
    Runs on x's device."""
    _check(algo, group_size)
    bound = _BOUNDS[algo]
    xf = x.float()
    k = xf.shape[0]
    if algo == "weight_only_int4" and k % 2:
        raise ValueError(f"int4 packing needs even K, got {k}")
    absmax = xf.abs().amax(dim=0)                          # [N]
    scale = torch.clamp(absmax / bound, min=1e-8)
    q = torch.clamp(torch.round(xf / scale), -bound, bound).to(torch.int8)
    if algo == "weight_only_int4":
        q = pack_int4(q)
    return q, scale


def weight_dequantize(x, scale, algo="weight_only_int8", group_size=-1):
    """Inverse of :func:`weight_quantize` -> f32 [K, N] (for int4 the
    input is the packed [K/2, N] layout)."""
    _check(algo, group_size)
    if algo == "weight_only_int4":
        x = unpack_int4(x)
    return x.float() * scale
