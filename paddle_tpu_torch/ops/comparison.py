"""Comparison & logical ops (ports ``paddle_tpu/ops/comparison.py``)."""
from __future__ import annotations

import torch

from .registry import op
from .math import _promote_binary as _co


@op
def equal(x, y, name=None):
    x, y = _co(x, y)
    return torch.eq(x, y)


@op
def not_equal(x, y, name=None):
    x, y = _co(x, y)
    return torch.ne(x, y)


@op
def greater_than(x, y, name=None):
    x, y = _co(x, y)
    return torch.gt(x, y)


@op
def greater_equal(x, y, name=None):
    x, y = _co(x, y)
    return torch.ge(x, y)


@op
def less_than(x, y, name=None):
    x, y = _co(x, y)
    return torch.lt(x, y)


@op
def less_equal(x, y, name=None):
    x, y = _co(x, y)
    return torch.le(x, y)


@op
def equal_all(x, y, name=None):
    same = x.shape == y.shape and bool(torch.equal(x, y.to(x.dtype)))
    return torch.tensor(same, device=x.device)


@op
def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    return torch.tensor(torch.allclose(x, y, rtol=float(rtol),
                                       atol=float(atol),
                                       equal_nan=equal_nan), device=x.device)


@op
def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    return torch.isclose(x, y, rtol=float(rtol), atol=float(atol),
                         equal_nan=equal_nan)


@op
def logical_and(x, y, out=None, name=None):
    return torch.logical_and(*_co(x, y))


@op
def logical_or(x, y, out=None, name=None):
    return torch.logical_or(*_co(x, y))


@op
def logical_xor(x, y, out=None, name=None):
    return torch.logical_xor(*_co(x, y))


@op
def logical_not(x, out=None, name=None):
    return torch.logical_not(x)


@op
def is_empty(x, name=None):
    return torch.tensor(any(s == 0 for s in x.shape), device=x.device)
