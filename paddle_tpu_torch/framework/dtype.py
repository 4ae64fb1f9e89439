"""Dtype system.

Ports ``paddle_tpu/framework/dtype.py``: each dtype is a named singleton
(``paddle.float32``) — here over a ``torch.dtype`` (the reference's is
over a numpy dtype), with the numpy dtype beside it where numpy has one
(bfloat16 and the float8s have none without ``ml_dtypes``, which the
port does not need).  ``DType`` compares equal to its name, its torch
dtype and its numpy dtype.
"""
from __future__ import annotations

import numpy as np
import torch

# NB: "dtype" (the coercion function) is deliberately NOT in __all__, as
# in the reference: framework.dtype must stay the module.
__all__ = [
    "DType", "convert_dtype", "to_np_dtype", "to_torch_dtype",
    "bool_", "uint8", "int8", "int16", "int32", "int64",
    "float16", "bfloat16", "float32", "float64",
    "complex64", "complex128",
]


class DType:
    """A framework dtype: a named singleton over a torch dtype."""

    _registry: dict[str, "DType"] = {}

    __slots__ = ("name", "torch_dtype", "np_dtype")

    def __init__(self, name: str, torch_dtype, np_dtype=None):
        self.name = name
        self.torch_dtype = torch_dtype
        self.np_dtype = None if np_dtype is None else np.dtype(np_dtype)
        DType._registry[name] = self

    def __repr__(self):
        return f"paddle.{self.name}"

    @property
    def itemsize(self):
        return self.torch_dtype.itemsize

    def __eq__(self, other):
        if isinstance(other, DType):
            return self.name == other.name
        try:
            return self.name == dtype(other).name
        except TypeError:
            return NotImplemented

    def __hash__(self):
        return hash(self.name)

    @property
    def is_floating_point(self):
        return self.torch_dtype.is_floating_point

    @property
    def is_integer(self):
        return not (self.torch_dtype.is_floating_point
                    or self.torch_dtype.is_complex
                    or self.torch_dtype is torch.bool)

    @property
    def is_complex(self):
        return self.torch_dtype.is_complex


bool_ = DType("bool", torch.bool, np.bool_)
uint8 = DType("uint8", torch.uint8, np.uint8)
int8 = DType("int8", torch.int8, np.int8)
int16 = DType("int16", torch.int16, np.int16)
int32 = DType("int32", torch.int32, np.int32)
int64 = DType("int64", torch.int64, np.int64)
float16 = DType("float16", torch.float16, np.float16)
bfloat16 = DType("bfloat16", torch.bfloat16)
float32 = DType("float32", torch.float32, np.float32)
float64 = DType("float64", torch.float64, np.float64)
complex64 = DType("complex64", torch.complex64, np.complex64)
complex128 = DType("complex128", torch.complex128, np.complex128)

float8_e4m3fn = DType("float8_e4m3fn", torch.float8_e4m3fn)
float8_e5m2 = DType("float8_e5m2", torch.float8_e5m2)

_TORCH_TO_DTYPE = {d.torch_dtype: d for d in DType._registry.values()}
_NP_TO_DTYPE = {d.np_dtype: d for d in DType._registry.values()
                if d.np_dtype is not None}


def dtype(x) -> DType:
    """Coerce anything dtype-like (DType, name, torch or numpy dtype) to a
    DType singleton."""
    if isinstance(x, DType):
        return x
    if isinstance(x, torch.dtype):
        d = _TORCH_TO_DTYPE.get(x)
    elif isinstance(x, str) and x in DType._registry:
        d = DType._registry[x]
    else:
        name = getattr(getattr(x, "dtype", x), "name", None)
        if name in DType._registry:       # e.g. an ml_dtypes bfloat16
            return DType._registry[name]
        try:
            d = _NP_TO_DTYPE.get(np.dtype(x))
        except TypeError:
            d = None
    if d is None:
        raise TypeError(f"unsupported dtype: {x!r}")
    return d


def to_torch_dtype(x) -> torch.dtype:
    """Convert dtype-like to the torch dtype."""
    return dtype(x).torch_dtype


def to_np_dtype(x):
    """Convert dtype-like to the numpy dtype (raises for dtypes numpy
    lacks, such as bfloat16)."""
    d = dtype(x)
    if d.np_dtype is None:
        raise TypeError(f"numpy has no {d.name}")
    return d.np_dtype


def convert_dtype(x) -> str:
    """Paddle-compat: return canonical dtype name string."""
    return dtype(x).name
