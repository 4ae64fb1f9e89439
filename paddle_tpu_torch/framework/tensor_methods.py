"""Attach tensor methods + operator dunders to Tensor.

Ports ``paddle_tpu/framework/tensor_methods.py`` for the ops the port
has (``ops/math``, ``reduction``, ``manipulation``, ``creation``,
``comparison``, ``indexing`` and the bitwise ops of ``linalg``); the
methods over the rest of ``linalg`` and ``math_extra`` come with those
modules.  Called once from the package
``__init__``.
"""
from __future__ import annotations

import math as _math

import torch

from .tensor import Tensor, _link_view, _strict_views_on
from ..ops import math as m, reduction as r, manipulation as mp, \
    creation as c, comparison as cmp, indexing as ix, linalg as lg
from .random import generator_for

# method name -> op callable taking (self, ...)
_METHODS = dict(
    # math
    add=m.add, subtract=m.subtract, multiply=m.multiply, divide=m.divide,
    floor_divide=m.floor_divide, remainder=m.remainder, mod=m.remainder,
    pow=m.pow, matmul=m.matmul, scale=m.scale, neg=m.neg, abs=m.abs,
    exp=m.exp, expm1=m.expm1, log=m.log, log2=m.log2, log10=m.log10,
    log1p=m.log1p, sqrt=m.sqrt, rsqrt=m.rsqrt, square=m.square,
    sin=m.sin, cos=m.cos, tan=m.tan, asin=m.asin, acos=m.acos, atan=m.atan,
    sinh=m.sinh, cosh=m.cosh, tanh=m.tanh, asinh=m.asinh, acosh=m.acosh,
    atanh=m.atanh, erf=m.erf, erfinv=m.erfinv, floor=m.floor, ceil=m.ceil,
    round=m.round, trunc=m.trunc, sign=m.sign, reciprocal=m.reciprocal,
    sigmoid=m.sigmoid, digamma=m.digamma, lgamma=m.lgamma, frac=m.frac,
    conj=m.conj, real=m.real, imag=m.imag, angle=m.angle,
    clip=m.clip, maximum=m.maximum, minimum=m.minimum, fmax=m.fmax,
    fmin=m.fmin, atan2=m.atan2, lerp=m.lerp, logit=m.logit,
    isnan=m.isnan, isinf=m.isinf, isfinite=m.isfinite,
    nan_to_num=m.nan_to_num, cumsum=m.cumsum, cumprod=m.cumprod,
    cummax=m.cummax, cummin=m.cummin, logcumsumexp=m.logcumsumexp,
    addmm=m.addmm, inner=m.inner, outer=m.outer, heaviside=m.heaviside,
    gcd=m.gcd, lcm=m.lcm, diff=m.diff, trace=m.trace, kron=m.kron,
    cross=m.cross, dot=m.dot, hypot=m.hypot, i0=m.i0,
    polygamma=m.polygamma,
    # reduction
    sum=r.sum_, mean=r.mean, max=r.max_, min=r.min_, amax=r.amax,
    amin=r.amin, prod=r.prod, all=r.all_, any=r.any_, var=r.var, std=r.std,
    nansum=r.nansum, nanmean=r.nanmean, count_nonzero=r.count_nonzero,
    logsumexp=r.logsumexp, argmax=r.argmax, argmin=r.argmin, median=r.median,
    nanmedian=r.nanmedian, quantile=r.quantile, kthvalue=r.kthvalue,
    mode=r.mode,
    # manipulation
    reshape=mp.reshape, transpose=mp.transpose, squeeze=mp.squeeze,
    unsqueeze=mp.unsqueeze, flatten=mp.flatten, tile=mp.tile,
    expand=mp.expand, expand_as=mp.expand_as, broadcast_to=mp.broadcast_to,
    gather=mp.gather, gather_nd=mp.gather_nd, scatter=mp.scatter,
    scatter_nd_add=mp.scatter_nd_add, index_select=mp.index_select,
    index_add=mp.index_add, index_put=mp.index_put,
    index_sample=mp.index_sample,
    take_along_axis=mp.take_along_axis, put_along_axis=mp.put_along_axis,
    flip=mp.flip, roll=mp.roll, rot90=mp.rot90, where=mp.where,
    nonzero=mp.nonzero, masked_select=mp.masked_select,
    masked_fill=mp.masked_fill, topk=mp.topk, sort=mp.sort,
    argsort=mp.argsort, unique=mp.unique,
    unique_consecutive=mp.unique_consecutive, tril=mp.tril, triu=mp.triu,
    diag=mp.diag, diagonal=mp.diagonal, diag_embed=mp.diag_embed,
    cast=mp.cast, pad=mp.pad, repeat_interleave=mp.repeat_interleave,
    moveaxis=mp.moveaxis, swapaxes=mp.swapaxes, as_strided=mp.as_strided,
    split=mp.split, chunk=mp.chunk, unstack=mp.unstack, unfold=mp.unfold,
    numel=mp.numel, increment=mp.increment, bincount=mp.bincount,
    histogram=mp.histogram, searchsorted=mp.searchsorted,
    bucketize=mp.bucketize, unbind=mp.unstack, view=mp.view,
    # comparison
    equal=cmp.equal, not_equal=cmp.not_equal, greater_than=cmp.greater_than,
    greater_equal=cmp.greater_equal, less_than=cmp.less_than,
    less_equal=cmp.less_equal, equal_all=cmp.equal_all,
    allclose=cmp.allclose, isclose=cmp.isclose,
    logical_and=cmp.logical_and, logical_or=cmp.logical_or,
    logical_xor=cmp.logical_xor, logical_not=cmp.logical_not,
    # linalg (the bitwise ops only)
    bitwise_and=lg.bitwise_and, bitwise_or=lg.bitwise_or,
    bitwise_xor=lg.bitwise_xor, bitwise_not=lg.bitwise_not,
    # creation-likes
    zeros_like=c.zeros_like, ones_like=c.ones_like, full_like=c.full_like,
    clone=c.clone, bernoulli=c.bernoulli, multinomial=c.multinomial,
)

# in-place variants: run the op then rebind the handle (the reference's
# list, less the methods of modules not ported yet)
_INPLACE = [
    "add", "subtract", "multiply", "divide", "remainder", "floor_divide",
    "pow", "scale", "clip", "exp", "log", "sqrt", "rsqrt", "square", "abs",
    "neg", "floor", "ceil", "round", "trunc", "reciprocal", "sigmoid",
    "tanh", "erfinv", "cast", "reshape", "squeeze", "unsqueeze", "flatten",
    "transpose", "tril", "triu", "lerp", "masked_fill", "scatter",
    "index_add", "index_put", "put_along_axis", "nan_to_num", "where",
    "sin", "cos", "tan", "asin", "acos", "atan", "sinh", "cosh", "asinh",
    "acosh", "atanh", "erf", "expm1", "log2", "log10", "log1p", "digamma",
    "lgamma", "polygamma", "gcd", "lcm", "hypot", "i0", "frac",
    "cumsum", "cumprod", "logit", "logical_and", "logical_or",
    "logical_xor", "logical_not", "bitwise_and", "bitwise_or",
    "bitwise_xor", "bitwise_not", "equal", "not_equal", "greater_than",
    "greater_equal", "less_than", "less_equal", "mod", "addmm",
]


def _make_method(fn):
    def method(self, *args, **kwargs):
        return fn(self, *args, **kwargs)
    method.__name__ = fn.__name__
    return method


def _make_inplace(fn):
    def method(self, *args, **kwargs):
        return self._rebind_(fn(self, *args, **kwargs))
    method.__name__ = fn.__name__ + "_"
    return method


def _draw(self, fn):
    """Rebind to fresh random values drawn on this tensor's device from
    the default generator (no gradient)."""
    new = fn(generator_for(self._data.device)).to(self._data.dtype)
    self._drain()
    self._data = new
    self._sg = True
    return self


def _patch():
    for name, fn in _METHODS.items():
        setattr(Tensor, name, _make_method(fn))
    for name in _INPLACE:
        setattr(Tensor, name + "_", _make_inplace(_METHODS[name]))

    Tensor.astype = lambda self, dtype: mp.cast(self, dtype)
    Tensor.type_as = lambda self, other: mp.cast(self, other.dtype)

    def normal_(self, mean=0.0, std=1.0):
        return _draw(self, lambda g: torch.randn(
            self.shape, device=self._data.device, generator=g) * std + mean)
    Tensor.normal_ = normal_

    def uniform_(self, min=-1.0, max=1.0, seed=0):
        return self._rebind_(c.uniform(self.shape, dtype=self.dtype,
                                       min=min, max=max, seed=seed)
                             .to(self._data.device))
    Tensor.uniform_ = uniform_

    Tensor.zero_ = lambda self: self._rebind_(c.zeros_like(self))
    Tensor.fill_ = lambda self, value: self._rebind_(
        c.full_like(self, value))
    Tensor.exponential_ = lambda self, lam=1.0: self._rebind_(
        c.exponential_(self, lam))

    def bernoulli_(self, p=0.5):
        return _draw(self, lambda g: (torch.rand(
            self.shape, device=self._data.device, generator=g) < p))
    Tensor.bernoulli_ = bernoulli_

    def cauchy_(self, loc=0, scale=1):
        return _draw(self, lambda g: loc + scale * torch.tan(_math.pi * (
            torch.rand(self.shape, device=self._data.device, generator=g)
            - 0.5)))
    Tensor.cauchy_ = cauchy_

    def geometric_(self, probs):
        return _draw(self, lambda g: torch.ceil(torch.log(
            torch.rand(self.shape, device=self._data.device, generator=g)
            .clamp_min(1e-7)) / _math.log1p(-probs)))
    Tensor.geometric_ = geometric_

    def log_normal_(self, mean=1.0, std=2.0):
        return _draw(self, lambda g: torch.exp(mean + std * torch.randn(
            self.shape, device=self._data.device, generator=g)))
    Tensor.log_normal_ = log_normal_

    Tensor.is_complex = lambda self: self._data.is_complex()
    Tensor.is_floating_point = lambda self: self._data.is_floating_point()
    Tensor.is_integer = lambda self: self.dtype.is_integer
    Tensor.element_size = lambda self: self._data.element_size()
    Tensor.grad_fn = property(lambda self: self._data.grad_fn)

    # ---------------- operator dunders ----------------
    Tensor.__add__ = lambda s, o: m.add(s, o)
    Tensor.__radd__ = lambda s, o: m.add(s, o)
    Tensor.__sub__ = lambda s, o: m.subtract(s, o)
    Tensor.__rsub__ = lambda s, o: m.subtract(o, s)
    Tensor.__mul__ = lambda s, o: m.multiply(s, o)
    Tensor.__rmul__ = lambda s, o: m.multiply(s, o)
    Tensor.__truediv__ = lambda s, o: m.divide(s, o)
    Tensor.__rtruediv__ = lambda s, o: m.divide(o, s)
    Tensor.__floordiv__ = lambda s, o: m.floor_divide(s, o)
    Tensor.__rfloordiv__ = lambda s, o: m.floor_divide(o, s)
    Tensor.__mod__ = lambda s, o: m.remainder(s, o)
    Tensor.__rmod__ = lambda s, o: m.remainder(o, s)
    Tensor.__pow__ = lambda s, o: m.pow(s, o)
    Tensor.__rpow__ = lambda s, o: m.pow(o, s)
    Tensor.__matmul__ = lambda s, o: m.matmul(s, o)
    Tensor.__rmatmul__ = lambda s, o: m.matmul(o, s)
    Tensor.__neg__ = lambda s: m.neg(s)
    Tensor.__abs__ = lambda s: m.abs(s)
    # ~ & | ^: logical on bool tensors, bitwise on all others
    Tensor.__invert__ = lambda s: cmp.logical_not(s) \
        if s.dtype.name == "bool" else lg.bitwise_not(s)
    Tensor.__and__ = lambda s, o: cmp.logical_and(s, o) \
        if s.dtype.name == "bool" else lg.bitwise_and(s, o)
    Tensor.__or__ = lambda s, o: cmp.logical_or(s, o) \
        if s.dtype.name == "bool" else lg.bitwise_or(s, o)
    Tensor.__xor__ = lambda s, o: cmp.logical_xor(s, o) \
        if s.dtype.name == "bool" else lg.bitwise_xor(s, o)
    Tensor.__eq__ = lambda s, o: cmp.equal(s, o)
    Tensor.__ne__ = lambda s, o: cmp.not_equal(s, o)
    Tensor.__lt__ = lambda s, o: cmp.less_than(s, o)
    Tensor.__le__ = lambda s, o: cmp.less_equal(s, o)
    Tensor.__gt__ = lambda s, o: cmp.greater_than(s, o)
    Tensor.__ge__ = lambda s, o: cmp.greater_equal(s, o)
    Tensor.__getitem__ = lambda self, idx: ix.getitem(self, idx)

    def _setitem(self, idx, value):
        self._rebind_(ix.setitem(self, idx, value))
    Tensor.__setitem__ = _setitem


def _patch_strict_views():
    """Wrap the view-creating methods so FLAGS_strict_view_semantics can
    link base<->view (tensor.py _link_view / _check_view_mutation).  The
    flag gate runs before _link_view, so the off-path costs one dict
    get."""
    for name in ("reshape", "view", "squeeze", "unsqueeze", "flatten",
                 "detach", "__getitem__"):
        orig = getattr(Tensor, name)

        def _mk(orig):
            def method(self, *args, **kwargs):
                out = orig(self, *args, **kwargs)
                if _strict_views_on() and isinstance(out, Tensor):
                    _link_view(self, out)
                return out
            method.__name__ = getattr(orig, "__name__", "view_method")
            return method

        setattr(Tensor, name, _mk(orig))


_patch()
_patch_strict_views()
