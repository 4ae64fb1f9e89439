"""Automatic mixed precision: the op registry's AMP hook.

The port's copy of ``paddle_tpu/amp/auto_cast.py`` (the rest of
``amp/`` waits), casting Tensor arguments by torch dtype.  Reference:
python/paddle/amp/auto_cast.py + C++ AmpAutoCast inserted by eager
codegen (paddle/fluid/eager/auto_code_generator/generator/eager_gen.py:1607,
paddle/fluid/imperative/amp_auto_cast.cc).  O1 casts white-list ops (matmul,
conv) to low precision per-op; O2 casts almost everything except blacklist
(softmax/norm/exp...).  The low-precision dtype defaults to bfloat16.
"""
from __future__ import annotations

import threading

import torch

from ..framework import dtype as dtypes

__all__ = ["auto_cast", "amp_state", "maybe_amp_cast", "amp_guard",
           "WHITE_LIST", "BLACK_LIST"]

# Ops cast *to* low precision in O1 (reference amp_lists.py white_list).
WHITE_LIST = {
    "matmul", "conv2d", "conv1d", "conv3d", "conv2d_transpose", "bmm", "mm",
    "einsum", "linear", "flash_attention", "addmm", "mv",
}
# Ops forced to float32 (reference black_list): numerically sensitive.
BLACK_LIST = {
    "exp", "square", "log", "log2", "log10", "log1p", "mean", "sum", "cos_sim",
    "softmax", "log_softmax", "softmax_with_cross_entropy",
    "cross_entropy", "cross_entropy_with_softmax", "sigmoid_cross_entropy_with_logits",
    "c_softmax_with_cross_entropy", "layer_norm", "rms_norm", "reduce_sum",
    "linear_interp_v2", "nearest_interp_v2", "bilinear_interp_v2",
}


class _AmpState(threading.local):
    def __init__(self):
        self.enabled = False
        self.level = "O0"
        self.dtype = dtypes.bfloat16
        self.custom_white = set()
        self.custom_black = set()


_state = _AmpState()


def amp_state():
    return _state


class amp_guard:
    def __init__(self, enable=True, custom_white_list=None,
                 custom_black_list=None, level="O1", dtype="bfloat16"):
        if level not in ("O0", "O1", "O2"):
            raise ValueError(f"amp level must be O0/O1/O2, got {level}")
        self._cfg = (bool(enable) and level != "O0", level,
                     dtypes.dtype(dtype),
                     set(custom_white_list or ()), set(custom_black_list or ()))

    def __enter__(self):
        self._saved = (_state.enabled, _state.level, _state.dtype,
                       _state.custom_white, _state.custom_black)
        (_state.enabled, _state.level, _state.dtype,
         _state.custom_white, _state.custom_black) = self._cfg
        return self

    def __exit__(self, *exc):
        (_state.enabled, _state.level, _state.dtype,
         _state.custom_white, _state.custom_black) = self._saved
        return False


def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16", use_promote=True):
    """paddle.amp.auto_cast-shaped context manager."""
    return amp_guard(enable, custom_white_list, custom_black_list, level, dtype)


def _cast_tree(args, kwargs, target):
    from ..framework.tensor import Tensor

    def cast(x):
        if isinstance(x, Tensor) and x._data.dtype in _CASTABLE \
                and x._data.dtype != target:
            return x.astype(dtypes.dtype(target))
        if isinstance(x, (list, tuple)):
            return type(x)(cast(i) for i in x)
        if isinstance(x, dict):
            return {k: cast(v) for k, v in x.items()}
        return x

    return cast(args), cast(kwargs)


_CASTABLE = {torch.float16, torch.bfloat16, torch.float32}


def maybe_amp_cast(opname, args, kwargs):
    """Per-op AMP insertion point, called by the op dispatcher."""
    if not _state.enabled or opname == "cast":
        return args, kwargs
    white = (WHITE_LIST | _state.custom_white) - _state.custom_black
    black = (BLACK_LIST | _state.custom_black) - _state.custom_white
    low = _state.dtype.torch_dtype
    if _state.level == "O1":
        if opname in white:
            return _cast_tree(args, kwargs, low)
        if opname in black:
            return _cast_tree(args, kwargs, torch.float32)
        return args, kwargs
    # O2: everything low precision except blacklist.
    if opname in black:
        return _cast_tree(args, kwargs, torch.float32)
    return _cast_tree(args, kwargs, low)
