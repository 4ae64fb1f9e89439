"""paddle_tpu_torch — the PyTorch/CUDA port of ``paddle_tpu``.

``paddle_tpu`` (JAX, Pallas kernels for the TPU) stays the reference;
this package ports it slice by slice to PyTorch on an NVIDIA H100, with
every Pallas kernel replaced by a hand-written Hopper kernel under
``csrc/``.  Paths mirror the reference: ``paddle_tpu_torch/models/
llama.py`` ports ``paddle_tpu/models/llama.py``.

The package imports torch and numpy, never jax and never anything of
``paddle_tpu``.  Entry points run on CUDA unless the caller passes
``device="cpu"``; with no card, ``device=None`` raises instead of
quietly running on the CPU.  The eager Paddle API (``to_tensor``,
``nn``, ``optimizer``, autograd) puts new tensors on the current device:
CUDA unless ``set_device("cpu")`` asks for the CPU.

The top-level namespace holds the names of ``paddle_tpu/__init__.py``
that the ported modules provide.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` means ``"cuda"``.

    Raises when CUDA is asked for (explicitly or by default) and no card
    is present — the port never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "paddle_tpu_torch runs on CUDA by default and no CUDA device "
            "is available; pass device='cpu' to run the plain PyTorch "
            "versions on the CPU")
    return dev


# -- core types ------------------------------------------------------------
from .framework.dtype import (  # noqa: E402,F401
    bool_, uint8, int8, int16, int32, int64, float16, bfloat16, float32,
    float64, complex64, complex128, DType, dtype, float8_e4m3fn,
    float8_e5m2)
bool = bool_  # paddle.bool
from .framework.tensor import Tensor, to_tensor, is_tensor  # noqa: E402,F401
from .framework import tensor_methods as _tensor_methods  # noqa: E402,F401
from .framework.random import (  # noqa: E402,F401
    seed, get_rng_state, set_rng_state)
from .framework.random import (  # noqa: E402,F401
    get_rng_state as get_cuda_rng_state, set_rng_state as set_cuda_rng_state)

# -- autograd --------------------------------------------------------------
from .autograd import no_grad, enable_grad, is_grad_enabled, \
    set_grad_enabled, grad  # noqa: E402,F401
from . import autograd  # noqa: E402,F401

# -- ops into the flat namespace ------------------------------------------
from .ops.math import (  # noqa: E402,F401
    add, subtract, multiply, divide, floor_divide, remainder, mod, pow,
    matmul, scale, neg, abs, exp, expm1, log, log2, log10, log1p, sqrt,
    rsqrt, square, sin, cos, tan, asin, acos, atan, sinh, cosh, tanh, asinh,
    acosh, atanh, erf, erfinv, floor, ceil, round, trunc, sign, reciprocal,
    sigmoid, digamma, lgamma, i0, frac, deg2rad, rad2deg, angle, conj, real,
    imag, clip, maximum, minimum, fmax, fmin, atan2, hypot, lerp, stanh,
    logit, multiplex, isnan, isinf, isfinite, nan_to_num, cumsum, cumprod,
    cummax, cummin, logcumsumexp, addmm, inner, outer, heaviside, gcd, lcm,
    diff, trace, kron, cross, dot, polygamma)
from .ops.reduction import (  # noqa: E402,F401
    mean, amax, amin, prod, var, std, nansum, nanmean, count_nonzero,
    logsumexp, argmax, argmin, median, nanmedian, quantile, kthvalue, mode)
from .ops.reduction import sum_ as sum, max_ as max, min_ as min, \
    all_ as all, any_ as any  # noqa: E402,F401
from .ops.manipulation import (  # noqa: E402,F401
    reshape, transpose, concat, stack, unstack, split, chunk, squeeze,
    unsqueeze, flatten, tile, expand, expand_as, broadcast_to,
    broadcast_tensors, gather, gather_nd, scatter, scatter_nd_add,
    scatter_nd, index_select, index_sample, index_add, index_put,
    take_along_axis, put_along_axis, flip, roll, rot90, where, nonzero,
    masked_select, masked_fill, topk, sort, argsort, searchsorted, bucketize,
    unique, unique_consecutive, one_hot, tril, triu, tril_indices,
    triu_indices, diag, diagflat, diagonal, diag_embed, meshgrid, cast, pad,
    repeat_interleave, as_strided, moveaxis, swapaxes, atleast_1d,
    atleast_2d, atleast_3d, view, unfold, tensordot, crop, slice,
    strided_slice, numel, shape, increment, assign, bincount, histogram)
from .ops.manipulation import unstack as unbind  # noqa: E402,F401
from .ops.creation import (  # noqa: E402,F401
    zeros, ones, full, empty, zeros_like, ones_like, full_like, empty_like,
    arange, linspace, logspace, eye, clone, complex, polar, rand, randn,
    uniform, normal, gaussian, randint, randint_like, randperm, multinomial,
    bernoulli, poisson, standard_normal, standard_gamma)
from .ops.comparison import (  # noqa: E402,F401
    equal, not_equal, greater_than, greater_equal, less_than, less_equal,
    equal_all, allclose, isclose, logical_and, logical_or, logical_xor,
    logical_not, is_empty)

# -- subpackages -----------------------------------------------------------
from . import ops  # noqa: E402,F401
from . import nn  # noqa: E402,F401
from . import optimizer  # noqa: E402,F401
from . import amp  # noqa: E402,F401
from . import framework  # noqa: E402,F401
from . import device  # noqa: E402,F401
from .device import set_device, get_device, CPUPlace, \
    CUDAPlace  # noqa: E402,F401
from .flags import set_flags, get_flags  # noqa: E402,F401
from . import profiler  # noqa: E402,F401
from . import models  # noqa: E402,F401
from .nn.layer import ParamAttr  # noqa: E402,F401


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    from .nn.layer import Layer
    p = Layer().create_parameter(shape, attr=attr, dtype=dtype,
                                 is_bias=is_bias,
                                 default_initializer=default_initializer)
    if name:
        p.name = name
    return p


def in_dynamic_mode():
    return True


def get_default_dtype():
    return "float32"


def _export_inplace_functions():
    """Top-level in-place function forms (paddle.sin_(x) etc.): the
    reference's list, where the Tensor has the in-place method."""
    import sys
    mod = sys.modules[__name__]
    names = [
        "abs", "acos", "add", "addmm", "asin", "atan", "bernoulli", "cast",
        "cauchy", "ceil", "clip", "cos", "cumprod", "cumsum", "digamma",
        "divide", "equal", "erf", "erfinv", "exp", "expm1", "exponential",
        "fill", "flatten", "floor", "floor_divide", "frac", "gcd",
        "geometric", "greater_equal", "greater_than", "hypot", "i0",
        "index_add", "index_put", "lcm", "lerp", "less_equal", "less_than",
        "lgamma", "log", "log10", "log1p", "log2", "log_normal",
        "logical_and", "logical_not", "logical_or", "logical_xor", "logit",
        "masked_fill", "mod", "multiply", "nan_to_num", "neg", "normal",
        "not_equal", "polygamma", "pow", "put_along_axis", "reciprocal",
        "remainder", "reshape", "round", "rsqrt", "scale", "scatter",
        "sigmoid", "sign", "sin", "sinh", "sqrt", "square", "squeeze",
        "subtract", "tan", "tanh", "transpose", "tril", "triu", "trunc",
        "uniform", "unsqueeze", "where", "zero",
    ]

    def make(method):
        def fn(x, *args, **kwargs):
            return getattr(x, method)(*args, **kwargs)
        fn.__name__ = method
        fn.__doc__ = f"In-place form of paddle.{method[:-1]} (mutates x)."
        return fn

    for n in names:
        if hasattr(Tensor, n + "_") and not hasattr(mod, n + "_"):
            setattr(mod, n + "_", make(n + "_"))


_export_inplace_functions()
