"""Fused RMSNorm.

Ports ``paddle_tpu/ops/pallas/rms_norm.py``.  :func:`rms_norm` is
differentiable (a ``torch.autograd.Function``): its forward follows the
reference's routing and its backward is the reference's closed form
(``_rms_vjp_bwd``) in plain PyTorch, which is not a kernel there either.

Routes of the forward, as the reference routes them (``:51-58``):

* ``d % 128 != 0``: :func:`_xla_rms`, the reference's plain body, on
  any device.  It rounds the normalised row to x's dtype *before* the
  weight multiply (so a float32 weight promotes the result to float32).
  The reference never runs its kernel at such widths, so this is a
  route, not a fallback.
* every other width: the K6 kernel's numerics, statistics and weight
  multiply in f32, one cast to x's dtype.  On CUDA tensors that is
  :func:`_kernel` (``csrc/rms_norm.cu``, the port of ``_pallas_rms``),
  which launches or raises; on CPU tensors the plain version
  :func:`_plain_rms` with the same numerics.

That last choice is where the port and the reference differ: on its CPU
backend the reference takes the plain body at every width.  In float32
the two orders agree to rounding; in bf16 they differ by up to one bf16
rounding of the output (the weight multiply before or after the cast).
"""
from __future__ import annotations

import ctypes

import torch

from .. import cuda_lib

__all__ = ["rms_norm"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = (_I, _I, _P, _P, _P, _I, _I, ctypes.c_float, _P)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_KERNEL_WIDTH = 128            # the reference runs its kernel at d % 128 == 0
_launch = None                 # the C entry, resolved at first CUDA use


def _xla_rms(x, weight, eps):
    """The reference's plain body: normalise in f32, cast to x's dtype,
    then multiply by the weight."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * weight


def _plain_rms(x, weight, eps):
    """The kernel's numerics: the weight multiply in f32, then one cast."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)


def _kernel(x2d, weight, eps):
    """K6 on a contiguous [N, d] CUDA tensor; weight [d]."""
    global _launch
    if weight.device != x2d.device:
        raise ValueError("rms_norm: x and weight must be on one device, got "
                         f"{x2d.device} and {weight.device}")
    if x2d.dtype not in _DTYPES or weight.dtype not in _DTYPES:
        raise TypeError("rms_norm kernel takes float32, bfloat16 or float16 "
                        f"x and weight, got {x2d.dtype}/{weight.dtype}")
    n, d = x2d.shape
    if tuple(weight.shape) != (d,):
        raise ValueError(f"rms_norm: weight {tuple(weight.shape)} must be "
                         f"[{d}]")
    if d % 8:
        raise ValueError(f"rms_norm kernel takes d in multiples of 8, got {d}")
    if not (x2d.is_contiguous() and weight.is_contiguous()):
        raise ValueError("rms_norm kernel takes contiguous inputs")
    if x2d.data_ptr() % 16:
        raise ValueError("rms_norm kernel takes a 16-byte aligned x")
    out = torch.empty_like(x2d)
    if n == 0:
        return out
    if _launch is None:
        _launch = cuda_lib.kernel("rms_norm", "rms_norm_fwd", _ARGTYPES)
    err = _launch(_DTYPES[x2d.dtype], _DTYPES[weight.dtype], x2d.data_ptr(),
                  weight.data_ptr(), out.data_ptr(), n, d, float(eps),
                  torch.cuda.current_stream(x2d.device).cuda_stream)
    cuda_lib.check("rms_norm", err, "rms_norm launch")
    rms_norm.launches += 1
    return out


def _forward(x, weight, eps):
    d = x.shape[-1]
    if d % _KERNEL_WIDTH:
        return _xla_rms(x, weight, eps)
    if x.device.type == "cpu":
        return _plain_rms(x, weight, eps)
    return _kernel(x.reshape(-1, d).contiguous(), weight, eps).reshape(
        x.shape)


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, eps):
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        return _forward(x, weight, eps)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        xf, gf, wf = x.float(), g.float(), w.float()
        d = xf.shape[-1]
        r = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + ctx.eps)
        gw = gf * wf
        dx = (gw * r - xf * ((gw * xf).sum(dim=-1, keepdim=True)
                             * (r * r * r) / d)).to(x.dtype)
        dw = (xf * r * gf).reshape(-1, d).sum(dim=0).to(w.dtype)
        return dx, dw, None


def rms_norm(x, weight, eps=1e-6):
    """[..., d] fused RMSNorm; weight [d].  Differentiable in x and
    weight (the backward is the closed form, in plain PyTorch)."""
    return _RMSNorm.apply(x, weight, eps)


rms_norm.launches = 0          # kernel launches (the main-path witness)
