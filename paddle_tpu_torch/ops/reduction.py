"""Reduction ops (ports ``paddle_tpu/ops/reduction.py``).  Paddle's
``axis=None`` reduces all dims; ``keepdim`` keeps rank."""
from __future__ import annotations

import torch

from .registry import op
from .math import inexact
from ..framework.dtype import to_torch_dtype


def _axis(axis):
    if axis is None:
        return None
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    if isinstance(axis, torch.Tensor):
        return tuple(int(a) for a in axis.reshape(-1).tolist())
    return int(axis)


def _dims(x, axis):
    """``axis`` as the dim tuple torch's reductions take (all dims for
    None)."""
    a = _axis(axis)
    if a is None:
        return tuple(range(x.dim()))
    return a if isinstance(a, tuple) else (a,)


def _reduce(fn, x, axis, keepdim, **kw):
    dims = _dims(x, axis)
    if not dims:                       # a 0-d tensor
        return fn(x, **kw)
    return fn(x, dim=dims, keepdim=keepdim, **kw)


@op(name="sum")
def sum_(x, axis=None, dtype=None, keepdim=False, name=None):
    out = _reduce(torch.sum, x, axis, keepdim)
    if dtype is not None:
        out = out.to(to_torch_dtype(dtype))
    return out


@op
def mean(x, axis=None, keepdim=False, name=None):
    return _reduce(torch.mean, inexact(x), axis, keepdim)


@op(name="max")
def max_(x, axis=None, keepdim=False, name=None):
    return _reduce(torch.amax, x, axis, keepdim)


@op(name="min")
def min_(x, axis=None, keepdim=False, name=None):
    return _reduce(torch.amin, x, axis, keepdim)


@op
def amax(x, axis=None, keepdim=False, name=None):
    return _reduce(torch.amax, x, axis, keepdim)


@op
def amin(x, axis=None, keepdim=False, name=None):
    return _reduce(torch.amin, x, axis, keepdim)


@op
def prod(x, axis=None, keepdim=False, dtype=None, name=None):
    dims = _dims(x, axis)
    out = x if x.is_floating_point() or x.is_complex() else x.long()
    for d in sorted((d % max(x.dim(), 1) for d in dims), reverse=True):
        out = torch.prod(out, dim=d, keepdim=keepdim)
    if dtype is not None:
        out = out.to(to_torch_dtype(dtype))
    return out


@op(name="all")
def all_(x, axis=None, keepdim=False, name=None):
    return _reduce(torch.all, x.bool(), axis, keepdim)


@op(name="any")
def any_(x, axis=None, keepdim=False, name=None):
    return _reduce(torch.any, x.bool(), axis, keepdim)


@op
def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    return torch.var(inexact(x), dim=_dims(x, axis),
                     correction=1 if unbiased else 0, keepdim=keepdim)


@op
def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    return torch.std(inexact(x), dim=_dims(x, axis),
                     correction=1 if unbiased else 0, keepdim=keepdim)


@op
def nansum(x, axis=None, dtype=None, keepdim=False, name=None):
    out = _reduce(torch.nansum, x, axis, keepdim)
    if dtype is not None:
        out = out.to(to_torch_dtype(dtype))
    return out


@op
def nanmean(x, axis=None, keepdim=False, name=None):
    return _reduce(torch.nanmean, inexact(x), axis, keepdim)


@op
def count_nonzero(x, axis=None, keepdim=False, name=None):
    return _reduce(torch.sum, x != 0, axis, keepdim).to(torch.int64)


@op
def logsumexp(x, axis=None, keepdim=False, name=None):
    return torch.logsumexp(inexact(x), dim=_dims(x, axis), keepdim=keepdim)


def _arg(fn, x, axis, keepdim, dtype):
    if x.dtype == torch.bool:          # torch's arg-reductions take no bool
        x = x.to(torch.uint8)
    if axis is None:
        out = fn(x.reshape(-1))
        if keepdim:
            out = out.reshape([1] * x.dim())
    else:
        out = fn(x, dim=int(axis), keepdim=keepdim)
    return out.to(to_torch_dtype(dtype))


@op
def argmax(x, axis=None, keepdim=False, dtype="int64", name=None):
    return _arg(torch.argmax, x, axis, keepdim, dtype)


@op
def argmin(x, axis=None, keepdim=False, dtype="int64", name=None):
    return _arg(torch.argmin, x, axis, keepdim, dtype)


def _quantile(x, q, axis, keepdim, method="linear", nan=False):
    """numpy-style quantile over ``axis`` (None: all), in the float dtype
    jnp gives ``x``; float16 and bfloat16 are computed in float32 (torch
    has no half quantile)."""
    x = inexact(x)
    if x.dtype in (torch.float16, torch.bfloat16):
        return _quantile(x.float(), q, axis, keepdim, method,
                         nan).to(x.dtype)
    fn = torch.nanquantile if nan else torch.quantile
    qt = torch.as_tensor(q, dtype=x.dtype, device=x.device)
    if axis is None:
        out = fn(x.reshape(-1), qt, dim=0, interpolation=method)
        if keepdim:
            out = out.reshape(tuple(qt.shape) + (1,) * x.dim())
        return out
    dims = _dims(x, axis)
    if len(dims) == 1:
        return fn(x, qt, dim=dims[0], keepdim=keepdim, interpolation=method)
    nd = x.dim()
    dims = tuple(d % nd for d in dims)
    rest = [d for d in range(nd) if d not in dims]
    moved = x.permute(rest + list(dims)).reshape(
        [x.shape[d] for d in rest] + [-1])
    out = fn(moved, qt, dim=-1, interpolation=method)
    if keepdim:
        shape = [1 if d in dims else x.shape[d] for d in range(nd)]
        out = out.reshape(tuple(qt.shape) + tuple(shape))
    return out


@op
def median(x, axis=None, keepdim=False, mode="avg", name=None):
    return _quantile(x, 0.5, axis, keepdim)


@op
def nanmedian(x, axis=None, keepdim=False, name=None):
    return _quantile(x, 0.5, axis, keepdim, nan=True)


@op
def quantile(x, q, axis=None, keepdim=False, interpolation="linear",
             name=None):
    return _quantile(x, q, axis, keepdim, interpolation)


@op
def kthvalue(x, k, axis=-1, keepdim=False, name=None):
    vals, idxs = torch.sort(x, dim=axis, stable=True)
    taken = vals.select(axis, k - 1)
    taken_i = idxs.select(axis, k - 1).to(torch.int64)
    if keepdim:
        taken, taken_i = taken.unsqueeze(axis), taken_i.unsqueeze(axis)
    return taken, taken_i


@op
def mode(x, axis=-1, keepdim=False, name=None):
    """Most frequent value along ``axis`` (the smallest among ties, as
    the reference's ``jnp.unique`` + argmax) and its last index."""
    moved = x.movedim(axis, -1)
    n = moved.shape[-1]
    flat = moved.reshape(-1, n)
    svals, _ = torch.sort(flat, dim=-1)
    counts = (svals[:, :, None] == svals[:, None, :]).sum(-1)
    # first maximum over the sorted values: the smallest most-frequent
    best = torch.argmax(counts, dim=-1)
    val = svals.gather(-1, best[:, None])[:, 0]
    pos = torch.arange(n, device=x.device).expand_as(flat)
    idx = torch.where(flat == val[:, None], pos, -1).amax(-1)
    out_shape = moved.shape[:-1]
    vals, idxs = val.reshape(out_shape), idx.reshape(out_shape)
    if keepdim:
        vals, idxs = vals.unsqueeze(axis), idxs.unsqueeze(axis)
    return vals, idxs.to(torch.int64)

