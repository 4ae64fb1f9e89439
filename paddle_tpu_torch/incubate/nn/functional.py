"""paddle.incubate.nn.functional — fused ops, on torch tensors.

Ports ``paddle_tpu/incubate/nn/functional.py``.  So far
:func:`fused_rms_norm` (``:27-41``), the one function of that module that
reaches a TPU kernel (K6, through ``ops.pallas.rms_norm``).  The rest of
the module (``fused_layer_norm``, ``fused_dropout_add``, ``fused_linear``
and the others) is not ported yet (ROADMAP queue 1,
``incubate.nn.functional``).
"""
from __future__ import annotations

from ...ops.pallas.rms_norm import rms_norm as _rms_norm

__all__ = ["fused_rms_norm"]


def fused_rms_norm(x, norm_weight, norm_bias=None, epsilon=1e-6,
                   begin_norm_axis=-1, bias=None, residual=None,
                   quant_scale=-1, **kwargs):
    """RMSNorm over the last axis of ``x + residual + bias`` (each add
    optional), plus ``norm_bias``.  Returns ``out``, or ``(out,
    residual_out)`` when a residual is given, ``residual_out`` being the
    normalised input.  ``begin_norm_axis``, ``quant_scale`` and extra
    keywords are accepted and ignored, as the reference ignores them."""
    if residual is not None:
        x = x + residual
    if bias is not None:
        x = x + bias
    out = _rms_norm(x, norm_weight, eps=epsilon)
    if norm_bias is not None:
        out = out + norm_bias
    if residual is not None:
        return out, x          # the reference returns (out, residual_out)
    return out
