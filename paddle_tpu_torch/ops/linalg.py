"""The bitwise ops of ``paddle_tpu/ops/linalg.py`` (``:244-260``).

The Tensor's ``& | ^ ~`` call these on integer tensors and the logical
ops on bool ones, as the reference's dunders do.  A Python scalar takes
the tensor's dtype (``math._promote_binary``); a float operand, tensor
or scalar, raises, as ``jnp.bitwise_*`` does.  The rest of the module (the dense linalg,
shifts, histograms) waits with ROADMAP queue 1 item 5.1.
"""
from __future__ import annotations

import torch

from .registry import op
from .math import _promote_binary


def _integral(*xs):
    for x in xs:
        if isinstance(x, float):
            raise TypeError("bitwise ops take no python float operand")
        if isinstance(x, torch.Tensor) and (x.is_floating_point()
                                            or x.is_complex()):
            raise TypeError(
                f"bitwise ops take bool or integer tensors, not {x.dtype}")
    return xs


def _operands(x, y):
    return _integral(*_promote_binary(*_integral(x, y)))


@op
def bitwise_and(x, y, name=None):
    return torch.bitwise_and(*_operands(x, y))


@op
def bitwise_or(x, y, name=None):
    return torch.bitwise_or(*_operands(x, y))


@op
def bitwise_xor(x, y, name=None):
    return torch.bitwise_xor(*_operands(x, y))


@op
def bitwise_not(x, name=None):
    return torch.bitwise_not(*_integral(x))
