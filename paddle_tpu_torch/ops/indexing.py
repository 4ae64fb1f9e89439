"""__getitem__/__setitem__ ops (ports ``paddle_tpu/ops/indexing.py``).
``setitem`` computes the written tensor out of place (a clone written at
``idx``), so the handle rebinds to it and both stay differentiable.
Indices follow numpy's rules, as jnp's do: an integer beside an array
index is an advanced index too (torch would apply it first, which moves
the advanced dims)."""
from __future__ import annotations

import numpy as np
import torch

from .registry import op


def _is_int(i):
    return isinstance(i, (int, np.integer)) and not isinstance(i, bool)


def _index(x, idx):
    if isinstance(idx, list):
        idx = tuple(idx)
    if not isinstance(idx, tuple):
        return idx
    adv = [i for i in idx if isinstance(i, (torch.Tensor, np.ndarray))
           and i.dtype not in (torch.bool, np.bool_)]
    if adv and any(_is_int(i) for i in idx):
        shape = torch.broadcast_shapes(*[tuple(i.shape) for i in adv])
        idx = tuple(torch.full(shape, int(i), dtype=torch.long,
                               device=x.device) if _is_int(i) else i
                    for i in idx)
    return idx


@op
def getitem(x, idx):
    return x[_index(x, idx)]


@op
def setitem(x, idx, value):
    if isinstance(value, torch.Tensor):
        value = value.to(x.dtype)
    out = x.clone()
    out[_index(x, idx)] = value
    return out
