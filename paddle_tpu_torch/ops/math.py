"""Elementwise & scalar math ops (ports ``paddle_tpu/ops/math.py``).

Bodies are plain PyTorch.  Type promotion is the reference's, not
torch's: a python scalar takes the tensor's dtype (``_promote_binary``,
reference ``:13``; an int tensor plus 2.5 adds 2, as there), and two
tensors of different dtypes meet at their promoted dtype whatever their
ranks (torch would let a 0-d tensor of a wider float lose to an n-d
one).
"""
from __future__ import annotations

import builtins as _builtins

import torch

from .registry import op

_SCALARS = (bool, int, float, _builtins.complex)


def _scalar_as(v, dtype):
    """A python scalar cast to a tensor dtype's kind (jnp.asarray(v,
    dtype)): truncated for ints, a bool for bool."""
    if dtype == torch.bool:
        return _builtins.bool(v)
    if dtype.is_complex:
        return _builtins.complex(v)
    if dtype.is_floating_point:
        return float(v)
    return int(v)


def _promote_binary(x, y):
    """The reference's promotion: scalars take the tensor's dtype (as
    0-d CPU tensors, which torch combines with tensors on any device);
    mixed tensor dtypes promote."""
    xt, yt = isinstance(x, torch.Tensor), isinstance(y, torch.Tensor)
    if xt and not yt and isinstance(y, _SCALARS):
        y = torch.tensor(_scalar_as(y, x.dtype), dtype=x.dtype)
    elif yt and not xt and isinstance(x, _SCALARS):
        x = torch.tensor(_scalar_as(x, y.dtype), dtype=y.dtype)
    elif xt and yt and x.dtype != y.dtype:
        ct = torch.promote_types(x.dtype, y.dtype)
        x, y = x.to(ct), y.to(ct)
    return x, y


@op
def add(x, y, name=None):
    x, y = _promote_binary(x, y)
    return torch.add(x, y)


@op
def subtract(x, y, name=None):
    x, y = _promote_binary(x, y)
    return torch.sub(x, y)


@op
def multiply(x, y, name=None):
    x, y = _promote_binary(x, y)
    return torch.mul(x, y)


@op
def divide(x, y, name=None):
    x, y = _promote_binary(x, y)
    if not (x.is_floating_point() or x.is_complex()):
        return torch.true_divide(x.double(), y.double()).float()
    return torch.true_divide(x, y)


@op
def floor_divide(x, y, name=None):
    x, y = _promote_binary(x, y)
    return torch.floor_divide(x, y)


@op
def remainder(x, y, name=None):
    x, y = _promote_binary(x, y)
    return torch.remainder(x, y)


mod = remainder


@op
def pow(x, y, name=None):
    x, y = _promote_binary(x, y)
    return torch.pow(x, y)


@op
def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    if transpose_x and x.dim() > 1:
        x = x.transpose(-1, -2)
    if transpose_y and y.dim() > 1:
        y = y.transpose(-1, -2)
    return torch.matmul(x, y)


@op
def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None, name=None):
    s = scale.to(x.dtype) if isinstance(scale, torch.Tensor) else \
        torch.tensor(_scalar_as(scale, x.dtype), dtype=x.dtype)
    b = torch.tensor(_scalar_as(bias, x.dtype), dtype=x.dtype)
    return x * s + b if bias_after_scale else (x + b) * s


# --- unary ---
def _unary(name, fn):
    @op(name=name)
    def _f(x, name=None, _fn=fn):
        return _fn(x)
    _f.__name__ = name
    return _f


def _real_part(x):
    return torch.real(x) if x.is_complex() else x


def _imag_part(x):
    return torch.imag(x) if x.is_complex() else torch.zeros_like(x)


neg = _unary("neg", torch.neg)
abs = _unary("abs", torch.abs)
exp = _unary("exp", torch.exp)
expm1 = _unary("expm1", torch.expm1)
log = _unary("log", torch.log)
log2 = _unary("log2", torch.log2)
log10 = _unary("log10", torch.log10)
log1p = _unary("log1p", torch.log1p)
sqrt = _unary("sqrt", torch.sqrt)
rsqrt = _unary("rsqrt", torch.rsqrt)
square = _unary("square", torch.square)
sin = _unary("sin", torch.sin)
cos = _unary("cos", torch.cos)
tan = _unary("tan", torch.tan)
asin = _unary("asin", torch.asin)
acos = _unary("acos", torch.acos)
atan = _unary("atan", torch.atan)
sinh = _unary("sinh", torch.sinh)
cosh = _unary("cosh", torch.cosh)
tanh = _unary("tanh", torch.tanh)
asinh = _unary("asinh", torch.asinh)
acosh = _unary("acosh", torch.acosh)
atanh = _unary("atanh", torch.atanh)
erf = _unary("erf", torch.erf)
erfinv = _unary("erfinv", torch.erfinv)
floor = _unary("floor", torch.floor)
ceil = _unary("ceil", torch.ceil)
round = _unary("round", torch.round)
trunc = _unary("trunc", torch.trunc)
sign = _unary("sign", torch.sign)
reciprocal = _unary("reciprocal", torch.reciprocal)
sigmoid = _unary("sigmoid", torch.sigmoid)
digamma = _unary("digamma", torch.digamma)
lgamma = _unary("lgamma", torch.lgamma)
i0 = _unary("i0", torch.special.i0)
frac = _unary("frac", lambda x: x - torch.trunc(x))
deg2rad = _unary("deg2rad", torch.deg2rad)
rad2deg = _unary("rad2deg", torch.rad2deg)
angle = _unary("angle", torch.angle)
conj = _unary("conj", lambda x: torch.conj(x).resolve_conj()
              if x.is_complex() else x)
real = _unary("real", _real_part)
imag = _unary("imag", _imag_part)


def _bound(v, x):
    if v is None or isinstance(v, torch.Tensor):
        return v
    return _scalar_as(v, x.dtype)


@op
def clip(x, min=None, max=None, name=None):
    return torch.clamp(x, _bound(min, x), _bound(max, x))


@op
def maximum(x, y, name=None):
    x, y = _promote_binary(x, y)
    return torch.maximum(x, y)


@op
def minimum(x, y, name=None):
    x, y = _promote_binary(x, y)
    return torch.minimum(x, y)


@op
def fmax(x, y, name=None):
    x, y = _promote_binary(x, y)
    return torch.fmax(x, y)


@op
def fmin(x, y, name=None):
    x, y = _promote_binary(x, y)
    return torch.fmin(x, y)


@op
def atan2(x, y, name=None):
    x, y = _promote_binary(x, y)
    return torch.atan2(x, y)


@op
def hypot(x, y, name=None):
    return torch.hypot(x, y)


@op
def lerp(x, y, weight, name=None):
    return x + (y - x) * weight


@op
def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    return scale_b * torch.tanh(scale_a * x)


@op
def logit(x, eps=None, name=None):
    if eps is not None:
        x = torch.clamp(x, eps, 1.0 - eps)
    return torch.log(x / (1.0 - x))


@op
def multiplex(inputs, index, name=None):
    stacked = torch.stack(list(inputs), dim=0)
    idx = index.reshape(-1)
    return stacked[idx, torch.arange(stacked.shape[1], device=idx.device)]


@op
def isnan(x, name=None):
    return torch.isnan(x)


@op
def isinf(x, name=None):
    return torch.isinf(x)


@op
def isfinite(x, name=None):
    return torch.isfinite(x)


@op
def nan_to_num(x, nan=0.0, posinf=None, neginf=None, name=None):
    return torch.nan_to_num(x, nan=nan, posinf=posinf, neginf=neginf)


def _flat_axis(x, axis):
    if axis is None:
        return x.reshape(-1), 0
    return x, axis


def _keep_int(out, x):
    """jnp's cumulative ops keep an integer input's dtype (torch widens
    to int64)."""
    return out if x.is_floating_point() or x.is_complex() else \
        out.to(x.dtype)


@op
def cumsum(x, axis=None, dtype=None, name=None):
    x, axis = _flat_axis(x, axis)
    out = _keep_int(torch.cumsum(x, dim=axis), x)
    return out.to(_dtype(dtype)) if dtype is not None else out


@op
def cumprod(x, dim=None, dtype=None, name=None):
    x, dim = _flat_axis(x, dim)
    out = _keep_int(torch.cumprod(x, dim=dim), x)
    return out.to(_dtype(dtype)) if dtype is not None else out


def _dtype(d):
    from ..framework.dtype import to_torch_dtype
    return to_torch_dtype(d)


@op
def cummax(x, axis=None, dtype="int64", name=None):
    x, axis = _flat_axis(x, axis)
    vals, idx = torch.cummax(x, dim=axis)
    return vals, idx.to(_dtype(dtype))


@op
def cummin(x, axis=None, dtype="int64", name=None):
    x, axis = _flat_axis(x, axis)
    vals, idx = torch.cummin(x, dim=axis)
    return vals, idx.to(_dtype(dtype))


@op
def logcumsumexp(x, axis=None, dtype=None, name=None):
    x, axis = _flat_axis(x, axis)
    return torch.logcumsumexp(x, dim=axis)


@op
def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):
    return beta * input + alpha * torch.matmul(x, y)


@op
def inner(x, y, name=None):
    return torch.inner(x, y)


@op
def outer(x, y, name=None):
    return torch.outer(x.reshape(-1), y.reshape(-1))


@op
def heaviside(x, y, name=None):
    return torch.heaviside(x, y)


@op
def gcd(x, y, name=None):
    x, y = _promote_binary(x, y)
    return torch.gcd(x, y)


@op
def lcm(x, y, name=None):
    x, y = _promote_binary(x, y)
    return torch.lcm(x, y)


@op
def diff(x, n=1, axis=-1, prepend=None, append=None, name=None):
    return torch.diff(x, n=n, dim=axis, prepend=prepend, append=append)


@op
def trace(x, offset=0, axis1=0, axis2=1, name=None):
    return torch.diagonal(x, offset=offset, dim1=axis1, dim2=axis2).sum(-1)


@op
def kron(x, y, name=None):
    return torch.kron(x, y)


@op
def cross(x, y, axis=9, name=None):
    if axis == 9:
        axis = next(i for i, s in enumerate(x.shape) if s == 3)
    return torch.linalg.cross(x, y, dim=axis)


@op
def dot(x, y, name=None):
    return torch.sum(x * y, dim=-1)


@op
def polygamma(x, n, name=None):
    return torch.special.polygamma(n, x)
