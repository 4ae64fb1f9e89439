"""Weight initializers (ports ``paddle_tpu/nn/initializer.py``).

Each initializer is a callable (shape, dtype) -> torch tensor on the
current device, drawing from the default generator's stream there, so
``paddle.seed`` reproduces init.  Draws are in float32, then cast.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..framework.dtype import to_torch_dtype
from ..framework.random import generator_for

__all__ = ["Initializer", "Constant", "Normal", "TruncatedNormal", "Uniform",
           "XavierNormal", "XavierUniform", "KaimingNormal", "KaimingUniform",
           "Assign", "Dirac", "Orthogonal", "Bilinear", "calculate_gain",
           "set_global_initializer"]


def _fans(shape):
    shape = tuple(shape)
    if len(shape) < 1:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    receptive = int(np.prod(shape[2:])) if len(shape) > 2 else 1
    # paddle Linear weights are [in, out]; conv weights [out, in, kh, kw]
    if len(shape) == 2:
        fan_in, fan_out = shape[0], shape[1]
    else:
        fan_out, fan_in = shape[0] * receptive, shape[1] * receptive
    return fan_in, fan_out


def calculate_gain(nonlinearity, param=None):
    gains = {"sigmoid": 1.0, "linear": 1.0, "conv1d": 1.0, "conv2d": 1.0,
             "conv3d": 1.0, "tanh": 5.0 / 3.0, "relu": math.sqrt(2.0),
             "leaky_relu": math.sqrt(2.0 / (1 + (param or 0.01) ** 2)),
             "selu": 3.0 / 4.0}
    return gains[nonlinearity]


def _device():
    from ..device import current_device
    return current_device()


class Initializer:
    def __call__(self, shape, dtype="float32"):
        raise NotImplementedError

    @staticmethod
    def _normal(shape):
        dev = _device()
        return torch.randn(tuple(shape), dtype=torch.float32, device=dev,
                           generator=generator_for(dev))

    @staticmethod
    def _uniform(shape, low, high):
        dev = _device()
        u = torch.empty(tuple(shape), dtype=torch.float32, device=dev)
        return u.uniform_(low, high, generator=generator_for(dev))


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, shape, dtype="float32"):
        return torch.full(tuple(shape), self.value,
                          dtype=to_torch_dtype(dtype), device=_device())


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0, name=None):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype="float32"):
        return (self._normal(shape) * self.std + self.mean).to(
            to_torch_dtype(dtype))


class TruncatedNormal(Initializer):
    def __init__(self, mean=0.0, std=1.0, a=-2.0, b=2.0, name=None):
        self.mean, self.std, self.a, self.b = mean, std, a, b

    def __call__(self, shape, dtype="float32"):
        dev = _device()
        z = torch.empty(tuple(shape), dtype=torch.float32, device=dev)
        # inverse-CDF sampling of the standard normal truncated to [a, b]
        lo = 0.5 * (1 + math.erf(self.a / math.sqrt(2)))
        hi = 0.5 * (1 + math.erf(self.b / math.sqrt(2)))
        z.uniform_(lo, hi, generator=generator_for(dev))
        z = torch.erfinv(2 * z - 1) * math.sqrt(2)
        z = z.clamp(self.a, self.b)
        return (z * self.std + self.mean).to(to_torch_dtype(dtype))


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0, name=None):
        self.low, self.high = low, high

    def __call__(self, shape, dtype="float32"):
        return self._uniform(shape, self.low, self.high).to(
            to_torch_dtype(dtype))


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0, name=None):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype="float32"):
        fi, fo = _fans(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        std = self.gain * math.sqrt(2.0 / (fi + fo))
        return (self._normal(shape) * std).to(to_torch_dtype(dtype))


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0, name=None):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype="float32"):
        fi, fo = _fans(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        limit = self.gain * math.sqrt(6.0 / (fi + fo))
        return self._uniform(shape, -limit, limit).to(to_torch_dtype(dtype))


class KaimingNormal(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu",
                 name=None):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def __call__(self, shape, dtype="float32"):
        fi, _ = _fans(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        gain = calculate_gain(self.nonlinearity, self.negative_slope)
        std = gain / math.sqrt(fi)
        return (self._normal(shape) * std).to(to_torch_dtype(dtype))


class KaimingUniform(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu",
                 name=None):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def __call__(self, shape, dtype="float32"):
        fi, _ = _fans(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        gain = calculate_gain(self.nonlinearity, self.negative_slope)
        limit = gain * math.sqrt(3.0 / fi)
        return self._uniform(shape, -limit, limit).to(to_torch_dtype(dtype))


class Assign(Initializer):
    def __init__(self, value, name=None):
        self.value = value

    def __call__(self, shape, dtype="float32"):
        from ..framework.tensor import _as_torch
        v = self.value._data if hasattr(self.value, "_data") else \
            _as_torch(np.asarray(self.value), device=_device())
        return v.detach().to(_device(), to_torch_dtype(dtype)).reshape(
            tuple(shape)).clone()


class Dirac(Initializer):
    def __init__(self, groups=1, name=None):
        self.groups = groups

    def __call__(self, shape, dtype="float32"):
        out = torch.zeros(tuple(shape), dtype=to_torch_dtype(dtype))
        oc, ic = shape[0], shape[1]
        mid = tuple(s // 2 for s in shape[2:])
        for i in range(min(oc, ic * self.groups)):
            out[(i, i % ic) + mid] = 1
        return out.to(_device())


class Orthogonal(Initializer):
    def __init__(self, gain=1.0, name=None):
        self.gain = gain

    def __call__(self, shape, dtype="float32"):
        rows = shape[0]
        cols = int(np.prod(shape[1:]))
        z = self._normal((max(rows, cols), min(rows, cols)))
        q, r = torch.linalg.qr(z)
        q = q * torch.sign(torch.diagonal(r))
        if rows < cols:
            q = q.T
        return (self.gain * q[:rows, :cols]).reshape(tuple(shape)).to(
            to_torch_dtype(dtype))


class Bilinear(Initializer):
    """Bilinear upsampling kernel init for transposed convs."""

    def __call__(self, shape, dtype=None):
        shape = tuple(int(s) for s in shape)
        if len(shape) != 4:
            raise ValueError("Bilinear initializer expects a 4-D shape")
        f = np.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        k = np.zeros(shape, np.float32)
        for i in range(int(np.prod(shape[2:]))):
            x = i % shape[3]
            y = (i // shape[3]) % shape[2]
            k[:, :, y, x] = (1 - abs(x / f - c)) * (1 - abs(y / f - c))
        return torch.from_numpy(k).to(_device(),
                                      to_torch_dtype(dtype or "float32"))


_global_initializer = None


def set_global_initializer(weight_init, bias_init=None):
    """Default initializer override: picked up by
    Layer.create_parameter."""
    global _global_initializer
    _global_initializer = (weight_init, bias_init)
