"""Creation & random ops (ports ``paddle_tpu/ops/creation.py``).

New tensors go to the current device (``device.set_device``).  Random
ops draw from the default generator's stream on that device
(``framework/random.py``), so ``paddle.seed`` reproduces a run of the
port; the reference's JAX streams are matched in distribution only.
"""
from __future__ import annotations

import numpy as np
import torch

from .registry import op
from ..framework.dtype import to_torch_dtype
from ..framework.random import generator_for


def _dev():
    from ..device import current_device
    return current_device()


def _shape(shape):
    if isinstance(shape, int):
        return (shape,)
    if isinstance(shape, torch.Tensor):
        return tuple(int(s) for s in shape.reshape(-1).tolist())
    if isinstance(shape, np.ndarray):
        return tuple(int(s) for s in shape.reshape(-1))
    return tuple(int(s) for s in shape)


def _dt(dtype, default="float32"):
    return to_torch_dtype(dtype or default)


@op
def zeros(shape, dtype="float32", name=None):
    return torch.zeros(_shape(shape), dtype=_dt(dtype), device=_dev())


@op
def ones(shape, dtype="float32", name=None):
    return torch.ones(_shape(shape), dtype=_dt(dtype), device=_dev())


@op
def full(shape, fill_value, dtype=None, name=None):
    if isinstance(fill_value, torch.Tensor):
        fill_value = fill_value.item()
    if dtype is None:
        if isinstance(fill_value, bool):
            dtype = "bool"
        elif isinstance(fill_value, int):
            dtype = "int64"
        else:
            dtype = "float32"
    return torch.full(_shape(shape), fill_value, dtype=_dt(dtype),
                      device=_dev())


@op
def empty(shape, dtype="float32", name=None):
    return torch.zeros(_shape(shape), dtype=_dt(dtype), device=_dev())


def _like_dtype(x, dtype):
    return to_torch_dtype(dtype) if dtype else x.dtype


@op
def zeros_like(x, dtype=None, name=None):
    return torch.zeros_like(x, dtype=_like_dtype(x, dtype))


@op
def ones_like(x, dtype=None, name=None):
    return torch.ones_like(x, dtype=_like_dtype(x, dtype))


@op
def full_like(x, fill_value, dtype=None, name=None):
    return torch.full_like(x, fill_value, dtype=_like_dtype(x, dtype))


@op
def empty_like(x, dtype=None, name=None):
    return torch.zeros_like(x, dtype=_like_dtype(x, dtype))


@op
def arange(start=0, end=None, step=1, dtype=None, name=None):
    def _v(a):
        return a.item() if hasattr(a, "item") else a
    start, end, step = _v(start), _v(end), _v(step)
    if end is None:
        start, end = 0, start
    if dtype is None:
        dtype = "int64" if all(isinstance(v, int) for v in (start, end, step)) \
            else "float32"
    return torch.arange(start, end, step, dtype=_dt(dtype), device=_dev())


@op
def linspace(start, stop, num, dtype=None, name=None):
    return torch.linspace(float(start), float(stop), int(num),
                          dtype=_dt(dtype), device=_dev())


@op
def logspace(start, stop, num, base=10.0, dtype=None, name=None):
    return torch.logspace(float(start), float(stop), int(num),
                          base=float(base), dtype=_dt(dtype), device=_dev())


@op
def eye(num_rows, num_columns=None, dtype="float32", name=None):
    return torch.eye(int(num_rows), int(num_columns)
                     if num_columns is not None else int(num_rows),
                     dtype=_dt(dtype), device=_dev())


@op
def clone(x, name=None):
    return x.clone()


@op
def complex(real, imag, name=None):
    return torch.complex(real, imag)


@op
def polar(abs, angle, name=None):
    return torch.polar(abs, angle)


# ----------------------------------------------------------------- random
@op
def rand(shape, dtype="float32", name=None):
    dev = _dev()
    return torch.rand(_shape(shape), dtype=_dt(dtype), device=dev,
                      generator=generator_for(dev))


@op
def randn(shape, dtype="float32", name=None):
    dev = _dev()
    return torch.randn(_shape(shape), dtype=_dt(dtype), device=dev,
                       generator=generator_for(dev))


@op
def uniform(shape, dtype="float32", min=-1.0, max=1.0, seed=0, name=None):
    dev = _dev()
    gen = torch.Generator(device=dev).manual_seed(seed) if seed else \
        generator_for(dev)
    out = torch.empty(_shape(shape), dtype=torch.float32, device=dev)
    return out.uniform_(float(min), float(max), generator=gen).to(_dt(dtype))


@op
def normal(mean=0.0, std=1.0, shape=None, name=None):
    if isinstance(mean, torch.Tensor) and mean.dim() > 0:
        shape, dev = mean.shape, mean.device
    elif isinstance(std, torch.Tensor) and std.dim() > 0:
        shape, dev = std.shape, std.device
    else:
        shape, dev = (_shape(shape) if shape is not None else ()), _dev()
    z = torch.randn(tuple(shape), dtype=torch.float32, device=dev,
                    generator=generator_for(dev))
    return z * std + mean


@op
def gaussian(shape, mean=0.0, std=1.0, seed=0, dtype="float32", name=None):
    dev = _dev()
    gen = torch.Generator(device=dev).manual_seed(seed) if seed else \
        generator_for(dev)
    z = torch.randn(_shape(shape), dtype=torch.float32, device=dev,
                    generator=gen)
    return (z * std + mean).to(_dt(dtype))


@op
def randint(low=0, high=None, shape=(1,), dtype="int64", name=None):
    if high is None:
        low, high = 0, low
    dev = _dev()
    return torch.randint(int(low), int(high), _shape(shape),
                         dtype=_dt(dtype, "int64"), device=dev,
                         generator=generator_for(dev))


@op
def randint_like(x, low=0, high=None, dtype=None, name=None):
    if high is None:
        low, high = 0, low
    return torch.randint(int(low), int(high), x.shape,
                         dtype=_like_dtype(x, dtype), device=x.device,
                         generator=generator_for(x.device))


@op
def randperm(n, dtype="int64", name=None):
    dev = _dev()
    return torch.randperm(int(n), device=dev, generator=generator_for(
        dev)).to(_dt(dtype, "int64"))


@op
def multinomial(x, num_samples=1, replacement=False, name=None):
    return torch.multinomial(x.float(), num_samples, replacement,
                             generator=generator_for(x.device))


@op
def bernoulli(x, name=None):
    return torch.bernoulli(x, generator=generator_for(x.device))


@op
def poisson(x, name=None):
    return torch.poisson(x, generator=generator_for(x.device))


@op
def standard_normal(shape, dtype="float32", name=None):
    dev = _dev()
    return torch.randn(_shape(shape), dtype=_dt(dtype), device=dev,
                       generator=generator_for(dev))


@op
def standard_gamma(x, name=None):
    return torch._standard_gamma(x)


@op
def exponential_(x, lam=1.0, name=None):
    u = torch.rand(x.shape, dtype=torch.float32, device=x.device,
                   generator=generator_for(x.device))
    return (-torch.log1p(-u) / lam).to(x.dtype)

