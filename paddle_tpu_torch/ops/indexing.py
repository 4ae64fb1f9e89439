"""__getitem__/__setitem__ ops (ports ``paddle_tpu/ops/indexing.py``).
``setitem`` computes the written tensor out of place (a clone written at
``idx``), so the handle rebinds to it and both stay differentiable.
Indices follow numpy's rules, as jnp's do: an integer beside an array
index is an advanced index too (torch would apply it first, which moves
the advanced dims), and a slice may step backwards (torch takes no
negative step: the dim is flipped and the slice rewritten to step
forwards, for a read and for a write, and the gradient follows the
flip)."""
from __future__ import annotations

import numpy as np
import torch

from .registry import op


def _is_int(i):
    return isinstance(i, (int, np.integer)) and not isinstance(i, bool)


def _dims_taken(i):
    """How many dims of ``x`` one index entry consumes."""
    if i is None:
        return 0
    if isinstance(i, (torch.Tensor, np.ndarray)) and \
            i.dtype in (torch.bool, np.bool_):
        return i.ndim
    return 1


def _forward_slices(x, idx):
    """``idx`` with each negative-step slice rewritten to step forwards
    over the flipped dim, and the dims to flip."""
    if not any(isinstance(i, slice) and i.step is not None and i.step < 0
               for i in idx):
        return (), idx
    flips, out, d = [], [], 0
    for i in idx:
        if i is Ellipsis:
            d = x.dim() - sum(_dims_taken(j) for j in idx
                              if j is not Ellipsis) + d
            out.append(i)
            continue
        if isinstance(i, slice) and i.step is not None and i.step < 0:
            n = x.shape[d]
            r = range(n)[i]
            flips.append(d)
            # position p of x is position n-1-p of the flipped dim
            i = slice(n - 1 - r[0], n - r[-1], -i.step) if len(r) \
                else slice(0, 0)
        out.append(i)
        d += _dims_taken(i)
    return tuple(flips), tuple(out)


def _index(x, idx):
    """(dims to flip, the index for the flipped tensor)."""
    if isinstance(idx, list):
        idx = tuple(idx)
    if not isinstance(idx, tuple):
        if not isinstance(idx, slice):
            return (), idx
        idx = (idx,)
    flips, idx = _forward_slices(x, idx)
    adv = [i for i in idx if isinstance(i, (torch.Tensor, np.ndarray))
           and i.dtype not in (torch.bool, np.bool_)]
    if adv and any(_is_int(i) for i in idx):
        shape = torch.broadcast_shapes(*[tuple(i.shape) for i in adv])
        idx = tuple(torch.full(shape, int(i), dtype=torch.long,
                               device=x.device) if _is_int(i) else i
                    for i in idx)
    return flips, idx


@op
def getitem(x, idx):
    flips, idx = _index(x, idx)
    return (x.flip(flips) if flips else x)[idx]


@op
def setitem(x, idx, value):
    if isinstance(value, torch.Tensor):
        value = value.to(x.dtype)
    flips, idx = _index(x, idx)
    out = x.flip(flips) if flips else x.clone()
    out[idx] = value
    return out.flip(flips) if flips else out
