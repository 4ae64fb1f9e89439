"""Shape/layout manipulation ops (ports ``paddle_tpu/ops/manipulation.py``).

Bodies are plain PyTorch.  Every result is a new value, never a torch
view that writes through to its base (the reference's snapshot rule;
``framework/tensor.py``): views are safe because in-place APIs rebind
handles instead of writing into storage.
"""
from __future__ import annotations

import builtins as _builtins

import numpy as np
import torch

from .registry import op
from ..framework.dtype import to_torch_dtype


def _static_ints(v):
    """A shape-like argument (list that may hold 0-d tensors, a tensor,
    an array) as a tuple of ints."""
    if isinstance(v, torch.Tensor):
        return tuple(int(x) for x in v.reshape(-1).tolist())
    if isinstance(v, np.ndarray):
        return tuple(int(x) for x in v.reshape(-1))
    return tuple(int(x) for x in v)


@op
def reshape(x, shape, name=None):
    shape = _static_ints(shape)
    # Paddle semantics: 0 means "copy this dim from input".
    shape = tuple(x.shape[i] if s == 0 else s for i, s in enumerate(shape))
    return torch.reshape(x, shape)


@op
def transpose(x, perm, name=None):
    return x.permute(_static_ints(perm))


@op
def concat(x, axis=0, name=None):
    return torch.cat(list(x), dim=int(axis))


@op
def stack(x, axis=0, name=None):
    return torch.stack(list(x), dim=axis)


@op
def unstack(x, axis=0, num=None, name=None):
    return list(torch.unbind(x, dim=axis))


@op
def split(x, num_or_sections, axis=0, name=None):
    axis = int(axis)
    if isinstance(num_or_sections, int):
        if x.shape[axis] % num_or_sections:
            raise ValueError(
                f"dim {axis} of size {x.shape[axis]} does not split into "
                f"{num_or_sections} equal sections")
        return list(torch.split(x, x.shape[axis] // num_or_sections, axis))
    secs = list(_static_ints(num_or_sections))
    # Paddle allows one -1 meaning "the rest".
    if -1 in secs:
        known = sum(s for s in secs if s != -1)
        secs[secs.index(-1)] = x.shape[axis] - known
    return list(torch.split(x, secs, dim=axis))


@op
def chunk(x, chunks, axis=0, name=None):
    # numpy's array_split: the first n % chunks pieces get one more
    n = x.shape[int(axis)]
    q, r = divmod(n, chunks)
    return list(torch.split(x, [q + 1] * r + [q] * (chunks - r),
                            dim=int(axis)))


@op
def squeeze(x, axis=None, name=None):
    if axis is None:
        return torch.squeeze(x)
    axes = _static_ints(axis) if isinstance(axis, (list, tuple)) else \
        (int(axis),)
    ax = tuple(a for a in axes if x.shape[a] == 1)
    return torch.squeeze(x, dim=ax) if ax else x


@op
def unsqueeze(x, axis, name=None):
    if isinstance(axis, (list, tuple, torch.Tensor)):
        for a in sorted(_static_ints(axis)):
            x = torch.unsqueeze(x, a)
        return x
    return torch.unsqueeze(x, int(axis))


@op
def flatten(x, start_axis=0, stop_axis=-1, name=None):
    nd = x.dim()
    start = start_axis % nd if nd else 0
    stop = stop_axis % nd if nd else 0
    mid = int(np.prod(x.shape[start:stop + 1], dtype=np.int64))
    shape = list(x.shape[:start]) + [mid] + list(x.shape[stop + 1:])
    return torch.reshape(x, shape)


@op
def tile(x, repeat_times, name=None):
    return torch.tile(x, _static_ints(repeat_times))


@op
def expand(x, shape, name=None):
    shape = _static_ints(shape)
    nd_off = len(shape) - x.dim()
    shape = tuple(x.shape[i - nd_off] if s == -1 else s
                  for i, s in enumerate(shape))
    return torch.broadcast_to(x, shape)


@op
def expand_as(x, y, name=None):
    return torch.broadcast_to(x, y.shape)


@op
def broadcast_to(x, shape, name=None):
    return torch.broadcast_to(x, _static_ints(shape))


@op
def broadcast_tensors(inputs, name=None):
    return list(torch.broadcast_tensors(*inputs))


@op
def gather(x, index, axis=0, name=None):
    idx = index.reshape(-1) if index.dim() > 1 else index
    return torch.index_select(x, int(axis), idx.reshape(-1)).reshape(
        x.shape[:int(axis) % x.dim()] + idx.shape
        + x.shape[int(axis) % x.dim() + 1:])


@op
def gather_nd(x, index, name=None):
    return x[tuple(torch.movedim(index, -1, 0))]


@op
def scatter(x, index, updates, overwrite=True, name=None):
    index = index.reshape(-1)
    if overwrite:
        return x.index_put((index,), updates)
    z = x.index_put((index,), torch.zeros_like(updates))
    return z.index_put((index,), updates, accumulate=True)


@op
def scatter_nd_add(x, index, updates, name=None):
    return x.index_put(tuple(torch.movedim(index, -1, 0)), updates,
                       accumulate=True)


@op
def scatter_nd(index, updates, shape, name=None):
    zeros = torch.zeros(_static_ints(shape), dtype=updates.dtype,
                        device=updates.device)
    return zeros.index_put(tuple(torch.movedim(index, -1, 0)), updates,
                           accumulate=True)


@op
def index_select(x, index, axis=0, name=None):
    return torch.index_select(x, int(axis), index)


@op
def index_sample(x, index):
    return torch.gather(x, 1, index)


@op
def index_add(x, index, axis, value, name=None):
    return torch.index_add(x, axis, index, value)


@op
def index_put(x, indices, value, accumulate=False, name=None):
    return x.index_put(tuple(indices), value, accumulate=accumulate)


@op
def take_along_axis(arr, indices, axis, broadcast=True, name=None):
    if broadcast:
        tgt = list(arr.shape)
        tgt[axis] = indices.shape[axis]
        shape = torch.broadcast_shapes(tuple(tgt), indices.shape)
        indices = indices.broadcast_to(shape)
        tgt = list(shape)
        tgt[axis] = arr.shape[axis]
        arr = arr.broadcast_to(tgt)
    return torch.gather(arr, axis, indices)


@op
def put_along_axis(arr, indices, values, axis, reduce="assign",
                   include_self=True, broadcast=True, name=None):
    axis = axis % arr.dim()
    if broadcast:
        # paddle semantics: indices broadcast against arr on every dim
        # except `axis`
        tgt = list(arr.shape)
        tgt[axis] = indices.shape[axis]
        indices = indices.broadcast_to(tgt)
    if not isinstance(values, torch.Tensor) or values.shape != indices.shape:
        values = torch.as_tensor(values, dtype=arr.dtype,
                                 device=arr.device).broadcast_to(
                                     indices.shape)
    sl = torch.gather(arr, axis, indices)
    if reduce == "assign":
        new = values
    elif reduce == "add":
        new = sl + values if include_self else values
    elif reduce in ("mul", "multiply"):
        new = sl * values if include_self else values
    else:
        raise ValueError(f"unsupported reduce {reduce}")
    return arr.scatter(axis, indices, new.to(arr.dtype))


def _flip_axes(axis):
    if isinstance(axis, int):
        return (axis,)
    return _static_ints(axis)


@op
def flip(x, axis, name=None):
    return torch.flip(x, _flip_axes(axis))


@op
def roll(x, shifts, axis=None, name=None):
    if axis is not None and not isinstance(axis, int):
        axis = _static_ints(axis)
    if not isinstance(shifts, int):
        shifts = _static_ints(shifts)
    if axis is None:
        return torch.roll(x, shifts)
    return torch.roll(x, shifts, axis)


@op
def rot90(x, k=1, axes=(0, 1), name=None):
    return torch.rot90(x, k, list(axes))


@op
def where(condition, x=None, y=None, name=None):
    if x is None and y is None:
        return [i.to(torch.int64) for i in torch.nonzero(condition,
                                                         as_tuple=True)]
    xt, yt = isinstance(x, torch.Tensor), isinstance(y, torch.Tensor)
    if xt and yt and x.dtype != y.dtype:
        ct = torch.promote_types(x.dtype, y.dtype)
        x, y = x.to(ct), y.to(ct)
    elif xt and not yt:
        y = torch.tensor(y, dtype=x.dtype)
    elif yt and not xt:
        x = torch.tensor(x, dtype=y.dtype)
    return torch.where(condition, x, y)


@op
def nonzero(x, as_tuple=False, name=None):
    nz = torch.nonzero(x, as_tuple=True)
    if as_tuple:
        return [i.to(torch.int64).reshape(-1, 1) for i in nz]
    return torch.stack(nz, dim=1).to(torch.int64)


@op
def masked_select(x, mask, name=None):
    return x[torch.broadcast_to(mask, x.shape)]


@op
def masked_fill(x, mask, value, name=None):
    v = value.to(x.dtype) if isinstance(value, torch.Tensor) else \
        torch.tensor(value, dtype=x.dtype)
    return torch.where(mask, v, x)


@op
def topk(x, k, axis=None, largest=True, sorted=True, name=None):
    axis = -1 if axis is None else int(axis)
    # torch's topk takes no bool: rank a bool as uint8
    xs = x.to(torch.uint8) if x.dtype == torch.bool else x
    vals, idxs = torch.topk(xs, int(k), dim=axis, largest=largest,
                            sorted=True)
    return vals.to(x.dtype), idxs.to(torch.int64)


@op
def sort(x, axis=-1, descending=False, stable=False, name=None):
    out = torch.sort(x, dim=axis, stable=True).values
    return torch.flip(out, (axis,)) if descending else out


@op
def argsort(x, axis=-1, descending=False, stable=False, name=None):
    return torch.argsort(x, dim=axis, descending=descending,
                         stable=True).to(torch.int64)


@op
def searchsorted(sorted_sequence, values, out_int32=False, right=False,
                 name=None):
    return torch.searchsorted(sorted_sequence, values, right=right,
                              out_int32=out_int32)


@op
def bucketize(x, sorted_sequence, out_int32=False, right=False, name=None):
    return torch.searchsorted(sorted_sequence, x, right=right,
                              out_int32=out_int32)


@op
def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None, dtype="int64", name=None):
    # dynamic-shape: on the host like the reference's CPU kernel
    xn = x.detach().cpu().numpy()
    res = np.unique(xn, return_index=return_index,
                    return_inverse=return_inverse,
                    return_counts=return_counts, axis=axis)
    dt = to_torch_dtype(dtype)
    if not isinstance(res, tuple):
        return torch.from_numpy(res).to(x.device)
    return tuple(torch.from_numpy(np.ascontiguousarray(r)).to(
        x.device, x.dtype if i == 0 else dt) for i, r in enumerate(res))


@op
def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None, dtype="int64", name=None):
    if axis is not None:
        raise NotImplementedError("unique_consecutive with axis")
    out = torch.unique_consecutive(x.reshape(-1), return_inverse=True,
                                   return_counts=True)
    dt = to_torch_dtype(dtype)
    res = [out[0]]
    if return_inverse:
        res.append(out[1].to(dt))
    if return_counts:
        res.append(out[2].to(dt))
    return res[0] if len(res) == 1 else tuple(res)


@op
def one_hot(x, num_classes, name=None):
    return torch.nn.functional.one_hot(x.long(), num_classes).float()


@op
def tril(x, diagonal=0, name=None):
    return torch.tril(x, diagonal)


@op
def triu(x, diagonal=0, name=None):
    return torch.triu(x, diagonal)


def _dev():
    from ..device import current_device
    return current_device()


@op
def tril_indices(row, col, offset=0, dtype="int64", name=None):
    return torch.tril_indices(row, col, offset, device=_dev()).to(
        to_torch_dtype(dtype))


@op
def triu_indices(row, col=None, offset=0, dtype="int64", name=None):
    if col is None:
        col = row
    return torch.triu_indices(row, col, offset, device=_dev()).to(
        to_torch_dtype(dtype))


@op
def diag(x, offset=0, padding_value=0, name=None):
    if x.dim() == 1:
        out = torch.diag(x, offset)
        if padding_value != 0:
            mask = torch.diag(torch.ones_like(x), offset).bool()
            out = torch.where(mask, out, torch.tensor(padding_value,
                                                      dtype=x.dtype))
        return out
    return torch.diagonal(x, offset)


@op
def diagflat(x, offset=0, name=None):
    return torch.diagflat(x, offset)


@op
def diagonal(x, offset=0, axis1=0, axis2=1, name=None):
    return torch.diagonal(x, offset, axis1, axis2)


@op
def diag_embed(x, offset=0, dim1=-2, dim2=-1, name=None):
    return torch.diag_embed(x, offset, dim1, dim2)


@op
def meshgrid(*args, name=None):
    if len(args) == 1 and isinstance(args[0], (list, tuple)):
        args = tuple(args[0])
    return list(torch.meshgrid(*args, indexing="ij"))


@op
def cast(x, dtype, name=None):
    return x.to(to_torch_dtype(dtype))


@op
def pad(x, pad, mode="constant", value=0.0, data_format="NCHW",
        pad_from_left_axis=True, name=None):
    nd = x.dim()
    if isinstance(pad, int):  # pad every spatial dim on both sides
        pad = [pad] * (2 * max(nd - 2, 1))
    pad = _static_ints(pad)
    if len(pad) == 2 * nd:
        # full-rank form: [x0_before, x0_after, x1_before, ...]
        pairs = [(pad[2 * i], pad[2 * i + 1]) for i in range(nd)]
    else:
        # pad applies to spatial dims per data_format (NCHW: last dims)
        k = len(pad) // 2
        pairs = [(0, 0)] * nd
        if data_format.endswith("C") and nd >= 3:  # NHWC-style
            spatial = list(range(1, 1 + k))
        else:
            spatial = list(range(nd - k, nd))
        for i, d in enumerate(spatial):
            pairs[d] = (pad[2 * i], pad[2 * i + 1])
    if mode == "constant":
        flat = [p for lo_hi in reversed(pairs) for p in lo_hi]
        return torch.nn.functional.pad(x, flat, value=value)
    # torch pads non-constant modes over trailing dims of a batched
    # input: move the padded dims last, pad, move them back
    dims = [d for d in range(nd) if pairs[d] != (0, 0)]
    rest = [d for d in range(nd) if d not in dims]
    moved = x.permute(rest + dims)
    lead = moved.shape[:len(rest)]
    moved = moved.reshape((1, -1) + tuple(moved.shape[len(rest):]))
    tmode = {"reflect": "reflect", "replicate": "replicate",
             "circular": "circular"}[mode]
    flat = [p for d in reversed(dims) for p in pairs[d]]
    out = torch.nn.functional.pad(moved, flat, mode=tmode)
    out = out.reshape(tuple(lead) + tuple(out.shape[2:]))
    inv = np.argsort(rest + dims).tolist()
    return out.permute(inv)


@op
def repeat_interleave(x, repeats, axis=None, name=None):
    if axis is None:
        x = x.reshape(-1)
        axis = 0
    if isinstance(repeats, torch.Tensor) and repeats.dim() > 0:
        return torch.repeat_interleave(x, repeats, dim=axis)
    return torch.repeat_interleave(x, int(repeats), dim=axis)


@op
def as_strided(x, shape, stride, offset=0, name=None):
    return torch.as_strided(x.contiguous().reshape(-1), _static_ints(shape),
                            _static_ints(stride), offset).clone()


@op
def moveaxis(x, source, destination, name=None):
    return torch.movedim(x, source, destination)


@op
def swapaxes(x, axis0, axis1, name=None):
    return torch.swapaxes(x, axis0, axis1)


def _atleast(fn, inputs):
    out = [fn(i) for i in inputs]
    return out[0] if len(out) == 1 else out


@op
def atleast_1d(*inputs, name=None):
    return _atleast(torch.atleast_1d, inputs)


@op
def atleast_2d(*inputs, name=None):
    return _atleast(torch.atleast_2d, inputs)


@op
def atleast_3d(*inputs, name=None):
    return _atleast(torch.atleast_3d, inputs)


@op
def view(x, shape_or_dtype, name=None):
    if isinstance(shape_or_dtype, (list, tuple)):
        return torch.reshape(x, _static_ints(shape_or_dtype))
    return x.view(to_torch_dtype(shape_or_dtype))


@op
def unfold(x, axis, size, step, name=None):
    # torch appends the window dim; the reference puts it right after
    # the window count, which stays at ``axis``
    return x.unfold(axis, size, step).movedim(-1, axis % x.dim() + 1)


@op
def tensordot(x, y, axes=2, name=None):
    if not isinstance(axes, int):
        axes = [list(_static_ints(a)) if isinstance(a, (list, tuple))
                else [int(a)] for a in axes]
    return torch.tensordot(x, y, dims=axes)


@op
def crop(x, shape=None, offsets=None, name=None):
    shape = _static_ints(shape)
    offsets = _static_ints(offsets) if offsets is not None else \
        (0,) * x.dim()
    shape = tuple(x.shape[i] - offsets[i] if s == -1 else s
                  for i, s in enumerate(shape))
    sl = tuple(_builtins.slice(o, o + s) for o, s in zip(offsets, shape))
    return x[sl]


@op
def slice(input, axes, starts, ends, name=None):
    sl = [_builtins.slice(None)] * input.dim()
    for ax, st, en in zip(_static_ints(axes), _static_ints(starts),
                          _static_ints(ends)):
        sl[ax] = _builtins.slice(st, en)
    return input[tuple(sl)]


@op
def strided_slice(x, axes, starts, ends, strides, name=None):
    out = x
    for ax, st, en, sd in zip(_static_ints(axes), _static_ints(starts),
                              _static_ints(ends), _static_ints(strides)):
        idx = range(*_builtins.slice(st, en, sd).indices(x.shape[ax]))
        out = torch.index_select(out, ax, torch.tensor(
            list(idx), dtype=torch.int64, device=x.device))
    return out


@op
def numel(x, name=None):
    return torch.tensor(x.numel(), dtype=torch.int64, device=x.device)


@op
def shape(input):
    return torch.tensor(list(input.shape), dtype=torch.int32,
                        device=input.device)


@op
def increment(x, value=1.0, name=None):
    return x + torch.tensor(value, dtype=x.dtype)


@op
def assign(x, output=None, name=None):
    if isinstance(x, torch.Tensor):
        return x.clone()
    from ..framework.tensor import _as_torch
    return _as_torch(x)


@op
def bincount(x, weights=None, minlength=0, name=None):
    return torch.bincount(x, weights=weights, minlength=minlength)


@op
def histogram(input, bins=100, min=0, max=0, weight=None, density=False,
              name=None):
    lo, hi = float(min), float(max)
    if lo == 0.0 and hi == 0.0:
        lo, hi = float(input.min()), float(input.max())
    hist, _ = torch.histogram(input.reshape(-1).float().cpu(), bins=bins,
                              range=(lo, hi),
                              weight=None if weight is None else
                              weight.reshape(-1).float().cpu(),
                              density=density)
    hist = hist.to(input.device)
    return hist if density else hist.to(torch.int64)
