"""nn.functional (ports ``paddle_tpu/nn/functional.py``, its 77 ops).

Each entry is a registered op over plain PyTorch: the reference leaves
all of these to XLA, so none of them is a kernel of its own.
``scaled_dot_product_attention`` goes through the port's ``sdpa``
dispatch (the K1/K2 and K8 kernels on the card).  Convolutions keep
Paddle's NCHW/OIHW layout contract; the resize follows
``jax.image.resize`` (half-pixel centres, the Keys cubic kernel, the
triangle filter widened when downsampling), which is what the
reference's ``interpolate`` runs.  The reference's star re-exports of
``functional_extra*`` wait for those modules; ``flashmask_attention``
comes from the port's ``functional_extra2``.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as TF

from ..ops.registry import op, apply_op
from ..framework.dtype import to_torch_dtype
from ..framework.random import generator_for

# --------------------------------------------------------------- activations


@op
def relu(x, name=None):
    return torch.relu(x)


@op
def relu6(x, name=None):
    return torch.clamp(x, 0, 6)


@op
def gelu(x, approximate=False, name=None):
    return TF.gelu(x, approximate="tanh" if approximate else "none")


@op
def silu(x, name=None):
    return TF.silu(x)


swish = silu


@op
def sigmoid(x, name=None):
    return torch.sigmoid(x)


@op
def tanh(x, name=None):
    return torch.tanh(x)


@op
def softmax(x, axis=-1, dtype=None, name=None):
    if dtype is not None:
        x = x.to(to_torch_dtype(dtype))
    return torch.softmax(x, dim=axis)


@op
def log_softmax(x, axis=-1, dtype=None, name=None):
    if dtype is not None:
        x = x.to(to_torch_dtype(dtype))
    return torch.log_softmax(x, dim=axis)


@op
def softmin(x, axis=-1, name=None):
    return torch.softmax(-x, dim=axis)


@op
def leaky_relu(x, negative_slope=0.01, name=None):
    return TF.leaky_relu(x, negative_slope)


@op
def elu(x, alpha=1.0, name=None):
    return TF.elu(x, alpha)


@op
def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772, name=None):
    return scale * torch.where(x > 0, x, alpha * torch.expm1(x))


@op
def celu(x, alpha=1.0, name=None):
    return TF.celu(x, alpha)


@op
def prelu(x, weight, data_format="NCHW", name=None):
    if weight.numel() == 1:
        w = weight.reshape(())
    else:
        c_axis = 1 if data_format == "NCHW" else x.dim() - 1
        shape = [1] * x.dim()
        shape[c_axis] = -1
        w = weight.reshape(shape)
    return torch.where(x > 0, x, w * x)


@op
def rrelu(x, lower=1.0 / 8.0, upper=1.0 / 3.0, training=False, name=None):
    if training:
        a = torch.empty(x.shape, dtype=torch.float32, device=x.device)
        a = a.uniform_(lower, upper, generator=generator_for(x.device)).to(
            x.dtype)
    else:
        a = torch.tensor((lower + upper) / 2, dtype=x.dtype)
    return torch.where(x >= 0, x, a * x)


@op
def hardswish(x, name=None):
    return x * torch.clamp(x + 3, 0, 6) / 6


@op
def hardsigmoid(x, slope=1.0 / 6.0, offset=0.5, name=None):
    return torch.clamp(x * slope + offset, 0, 1)


@op
def hardtanh(x, min=-1.0, max=1.0, name=None):
    return torch.clamp(x, min, max)


def _zero(x):
    return torch.zeros((), dtype=x.dtype)


@op
def hardshrink(x, threshold=0.5, name=None):
    return torch.where(torch.abs(x) > threshold, x, _zero(x))


@op
def softshrink(x, threshold=0.5, name=None):
    return torch.where(x > threshold, x - threshold,
                       torch.where(x < -threshold, x + threshold, _zero(x)))


@op
def tanhshrink(x, name=None):
    return x - torch.tanh(x)


@op
def softplus(x, beta=1.0, threshold=20.0, name=None):
    scaled = beta * x
    return torch.where(scaled > threshold, x,
                       torch.log1p(torch.exp(scaled)) / beta)


@op
def softsign(x, name=None):
    return x / (1 + torch.abs(x))


@op
def mish(x, name=None):
    return x * torch.tanh(torch.logaddexp(x, _zero(x)))


@op
def glu(x, axis=-1, name=None):
    a, b = torch.chunk(x, 2, dim=axis)
    return a * torch.sigmoid(b)


@op
def maxout(x, groups, axis=1, name=None):
    c = x.shape[axis]
    shape = list(x.shape)
    shape[axis] = c // groups
    shape.insert(axis + 1, groups)
    return torch.amax(x.reshape(shape), dim=axis + 1)


@op
def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, name=None):
    u = torch.rand(x.shape, dtype=torch.float32, device=x.device,
                   generator=generator_for(x.device))
    g = -torch.log(-torch.log(u + 1e-20) + 1e-20).to(x.dtype)
    y = torch.softmax((x + g) / temperature, dim=axis)
    if hard:
        idx = torch.argmax(y, dim=axis, keepdim=True)
        y_hard = torch.zeros_like(y).scatter(axis, idx, 1.0)
        y = y_hard + y - y.detach()
    return y


# ------------------------------------------------------------------- linear

@op
def linear(x, weight, bias=None, name=None):
    # paddle weight layout: [in_features, out_features]
    out = torch.matmul(x, weight)
    if bias is not None:
        out = out + bias
    return out


@op(name="embedding")
def _embedding_dense(x, weight, padding_idx=None, name=None):
    out = TF.embedding(x, weight)
    if padding_idx is not None:
        out = torch.where((x == padding_idx)[..., None], _zero(out), out)
    return out


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Embedding lookup.  ``sparse=True`` (row-sparse weight gradients,
    the reference's SelectedRows analog) waits with ``selected_rows``."""
    if sparse:
        raise NotImplementedError(
            "embedding(sparse=True): row-sparse gradients (selected_rows) "
            "are not ported yet; use sparse=False")
    return _embedding_dense(x, weight, padding_idx=padding_idx)


@op
def one_hot(x, num_classes, name=None):
    return TF.one_hot(x.long(), num_classes).float()


@op
def bilinear(x1, x2, weight, bias=None, name=None):
    out = torch.einsum("bi,oij,bj->bo", x1, weight, x2)
    if bias is not None:
        out = out + bias
    return out


# ------------------------------------------------------------------ dropout

def _keep(x, p, shape):
    u = torch.rand(tuple(shape), device=x.device,
                   generator=generator_for(x.device))
    return u < (1.0 - p)


@op
def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None):
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            return x * (1.0 - p)
        return x
    if p == 1.0:
        return torch.zeros_like(x)
    shape = list(x.shape)
    if axis is not None:
        axes = [axis] if isinstance(axis, int) else list(axis)
        shape = [s if i in axes else 1 for i, s in enumerate(shape)]
    keep = _keep(x, p, shape)
    if mode == "upscale_in_train":
        return torch.where(keep, x / (1.0 - p), _zero(x))
    return torch.where(keep, x, _zero(x))


@op
def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None):
    if not training or p == 0.0:
        return x
    c_axis = 1 if data_format == "NCHW" else 3
    shape = [x.shape[0], 1, 1, 1]
    shape[c_axis] = x.shape[c_axis]
    return torch.where(_keep(x, p, shape), x / (1.0 - p), _zero(x))


@op
def alpha_dropout(x, p=0.5, training=True, name=None):
    if not training or p == 0.0:
        return x
    alpha_p = -1.7580993408473766
    keep = _keep(x, p, x.shape)
    a = (1.0 / math.sqrt((alpha_p ** 2 * p + 1) * (1 - p)))
    b = -a * alpha_p * p
    return a * torch.where(keep, x, torch.tensor(alpha_p, dtype=x.dtype)) + b


# -------------------------------------------------------------------- conv

def _pair(v, n=2):
    if isinstance(v, (list, tuple)):
        return tuple(int(i) for i in v)
    return (int(v),) * n


def _conv_padding(padding, nd):
    """Paddle padding as ``'SAME'``/``'VALID'`` or per-dim (lo, hi)."""
    if isinstance(padding, str):
        return padding.upper()
    if isinstance(padding, int):
        return [(padding, padding)] * nd
    padding = list(padding)
    if len(padding) == nd and all(isinstance(p, int) for p in padding):
        return [(p, p) for p in padding]
    if len(padding) == 2 * nd:
        return [(padding[2 * i], padding[2 * i + 1]) for i in range(nd)]
    return [tuple(p) for p in padding]


def _explicit_pads(pads, spatial, k, s, d):
    """XLA's string paddings as per-dim (lo, hi) pairs."""
    if pads == "VALID":
        return [(0, 0)] * len(spatial)
    if pads == "SAME":
        out = []
        for n, kk, ss, dd in zip(spatial, k, s, d):
            o = -(-n // ss)
            total = max((o - 1) * ss + (kk - 1) * dd + 1 - n, 0)
            out.append((total // 2, total - total // 2))
        return out
    return pads


def _pad_spatial(x, pairs, value=0.0):
    """Pad the trailing len(pairs) dims of x by (lo, hi) pairs."""
    flat = [p for lo_hi in reversed(pairs) for p in lo_hi]
    if not any(flat):
        return x
    return TF.pad(x, flat, value=value)


def _conv(x, weight, bias, stride, padding, dilation, groups, nd,
          channels_last):
    if channels_last:
        x = torch.movedim(x, -1, 1)
    s, d = _pair(stride, nd), _pair(dilation, nd)
    pads = _explicit_pads(_conv_padding(padding, nd), x.shape[2:],
                          weight.shape[2:], s, d)
    fn = (TF.conv1d, TF.conv2d, TF.conv3d)[nd - 1]
    out = fn(_pad_spatial(x, pads), weight, None, s, 0, d, groups)
    if bias is not None:
        out = out + bias.reshape((1, -1) + (1,) * nd)
    return torch.movedim(out, 1, -1) if channels_last else out


@op
def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups, 2,
                 data_format != "NCHW")


@op
def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups, 1,
                 data_format != "NCL")


@op
def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups, 3,
                 data_format != "NCDHW")


@op
def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCHW", name=None):
    """Paddle weight layout [in, out/groups, kh, kw] (torch's too).  The
    full transposed convolution, then the (lo, hi) padding cropped and
    ``output_padding`` (or ``output_size``) rows kept at the high end."""
    nd = 2
    s, d = _pair(stride, nd), _pair(dilation, nd)
    pads = _conv_padding(padding, nd)
    if isinstance(pads, str):
        raise NotImplementedError("conv2d_transpose with a string padding")
    opad = list(_pair(output_padding, nd))
    k = weight.shape[2:]
    full = TF.conv_transpose2d(x, weight, None, s, 0, 0, groups, d)
    if output_size is not None:
        want = _pair(output_size, nd)[-nd:]
        for i in range(nd):
            default = ((x.shape[2 + i] - 1) * s[i] - pads[i][0]
                       - pads[i][1] + d[i] * (k[i] - 1) + 1)
            extra = int(want[i]) - default
            if extra < 0 or extra >= s[i]:
                raise ValueError(
                    f"invalid output_size {want[i]} for dim {i}: reachable "
                    f"range is [{default}, {default + s[i] - 1}]")
            opad[i] += extra
    out = full
    for i in range(nd):
        n = full.shape[2 + i]
        stop = n - pads[i][1] + opad[i]
        if stop > n:
            grow = [0, 0] * nd
            grow[2 * (nd - 1 - i) + 1] = stop - n
            out = TF.pad(out, grow)
        out = out.narrow(2 + i, pads[i][0], stop - pads[i][0])
    if bias is not None:
        out = out + bias.reshape((1, -1) + (1,) * nd)
    return out


# ------------------------------------------------------------------- pooling

def _ceil_pads(pads, spatial, k, s):
    """ceil_mode: extend the high-side padding so the last partial window
    is emitted (a window starting past the real input is not)."""
    out = []
    for i, (lo, hi) in enumerate(pads):
        n_out = -(-(spatial[i] + lo + hi - k[i]) // s[i]) + 1  # ceil
        while n_out > 1 and (n_out - 1) * s[i] >= spatial[i] + lo:
            n_out -= 1
        extra = max(0, (n_out - 1) * s[i] + k[i] - (spatial[i] + lo + hi))
        out.append((lo, hi + extra))
    return out


def _pool_pads(x, nd, kernel_size, stride, padding, ceil_mode):
    k = _pair(kernel_size, nd)
    s = _pair(stride if stride is not None else kernel_size, nd)
    pads = _explicit_pads(_conv_padding(padding, nd), x.shape[-nd:], k, s,
                          (1,) * nd)
    if ceil_mode:
        pads = _ceil_pads(pads, x.shape[-nd:], k, s)
    return k, s, pads


def _neg_inf(x):
    return -math.inf if x.is_floating_point() else \
        torch.iinfo(x.dtype).min


def _max_pool(x, nd, kernel_size, stride, padding, ceil_mode, return_mask):
    k, s, pads = _pool_pads(x, nd, kernel_size, stride, padding, ceil_mode)
    xp = _pad_spatial(x, pads, _neg_inf(x))
    fn = (TF.max_pool1d, TF.max_pool2d)[nd - 1]
    if not return_mask:
        return fn(xp, k, s)
    out, idx = fn(xp, k, s, return_indices=True)
    # flat index into the padded map -> into the original one
    spatial, padded = x.shape[-nd:], xp.shape[-nd:]
    flat = torch.zeros_like(idx)
    rem = idx
    coords = []
    for i in reversed(range(nd)):
        coords.insert(0, rem % padded[i] - pads[i][0])
        rem = rem // padded[i]
    for i in range(nd):
        flat = flat * spatial[i] + coords[i].clamp(0, spatial[i] - 1)
    return out, flat.to(torch.int32)


def _avg_pool(x, nd, kernel_size, stride, padding, ceil_mode, exclusive,
              divisor_override=None):
    k, s, pads = _pool_pads(x, nd, kernel_size, stride, padding, ceil_mode)
    fn = (TF.avg_pool1d, TF.avg_pool2d)[nd - 1]
    size = int(np.prod(k))
    summed = fn(_pad_spatial(x, pads), k, s) * size
    if divisor_override:
        return summed / divisor_override
    if exclusive:
        counts = fn(_pad_spatial(torch.ones_like(x), pads), k, s) * size
        return summed / counts
    return summed / size


@op
def max_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               return_mask=False, data_format="NCHW", name=None):
    if data_format != "NCHW":
        out = _max_pool(torch.movedim(x, -1, 1), 2, kernel_size, stride,
                        padding, ceil_mode, return_mask)
        if return_mask:
            return tuple(torch.movedim(o, 1, -1) for o in out)
        return torch.movedim(out, 1, -1)
    return _max_pool(x, 2, kernel_size, stride, padding, ceil_mode,
                     return_mask)


@op
def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW",
               name=None):
    if data_format != "NCHW":
        return torch.movedim(_avg_pool(
            torch.movedim(x, -1, 1), 2, kernel_size, stride, padding,
            ceil_mode, exclusive, divisor_override), 1, -1)
    return _avg_pool(x, 2, kernel_size, stride, padding, ceil_mode,
                     exclusive, divisor_override)


@op
def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, name=None):
    return _max_pool(x, 1, kernel_size, stride, padding, ceil_mode,
                     return_mask)


@op
def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, name=None):
    return _avg_pool(x, 1, kernel_size, stride, padding, ceil_mode,
                     exclusive)


@op
def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    if data_format != "NCHW":
        return torch.movedim(TF.adaptive_avg_pool2d(
            torch.movedim(x, -1, 1), _pair(output_size)), 1, -1)
    return TF.adaptive_avg_pool2d(x, _pair(output_size))


@op
def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    return TF.adaptive_max_pool2d(x, _pair(output_size))


@op
def adaptive_avg_pool1d(x, output_size, name=None):
    return TF.adaptive_avg_pool1d(x, int(output_size))


# ---------------------------------------------------------------- normalize

def _var(x, dims):
    return torch.var(x, dim=dims, correction=0, keepdim=True)


@op
def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-05,
               name=None):
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    dims = tuple(range(x.dim() - len(tuple(normalized_shape)), x.dim()))
    mean = torch.mean(x, dim=dims, keepdim=True)
    out = (x - mean) * torch.rsqrt(_var(x, dims) + epsilon)
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    return out


@op
def rms_norm(x, weight=None, epsilon=1e-6, name=None):
    """RMSNorm in f32, cast back, then the weight (the reference's order;
    plain PyTorch, as the reference leaves it to XLA — the K6 kernel
    serves ``incubate.nn.functional.fused_rms_norm``)."""
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    out = (xf * torch.rsqrt(var + epsilon)).to(x.dtype)
    if weight is not None:
        out = out * weight
    return out


@op
def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-05,
               data_format="NCHW", use_global_stats=None, name=None):
    c_axis = 1 if data_format.startswith("NC") else x.dim() - 1
    dims = tuple(i for i in range(x.dim()) if i != c_axis)
    bshape = [1] * x.dim()
    bshape[c_axis] = -1
    xf = x.float()
    if training and not use_global_stats:
        # one-pass sum + sum-of-squares stats in f32, as the reference
        mean = torch.mean(xf, dim=dims)
        sq = torch.mean(torch.square(xf), dim=dims)
        var = torch.clamp(sq - torch.square(mean), min=0.0)
        new_rm = (momentum * running_mean
                  + (1 - momentum) * mean).to(running_mean.dtype)
        new_rv = (momentum * running_var
                  + (1 - momentum) * var).to(running_var.dtype)
    else:
        mean, var = running_mean.float(), running_var.float()
        new_rm, new_rv = running_mean, running_var
    out = (xf - mean.reshape(bshape)) * torch.rsqrt(
        var.reshape(bshape) + epsilon)
    if weight is not None:
        out = out * weight.float().reshape(bshape)
    if bias is not None:
        out = out + bias.float().reshape(bshape)
    return out.to(x.dtype), new_rm, new_rv


@op
def group_norm(x, num_groups, weight=None, bias=None, epsilon=1e-05,
               data_format="NCHW", name=None):
    if data_format != "NCHW":
        x = torch.movedim(x, -1, 1)
    n, c = x.shape[0], x.shape[1]
    grouped = x.reshape((n, num_groups, c // num_groups) + x.shape[2:])
    dims = tuple(range(2, grouped.dim()))
    mean = torch.mean(grouped, dim=dims, keepdim=True)
    out = ((grouped - mean) * torch.rsqrt(_var(grouped, dims) + epsilon)
           ).reshape(x.shape)
    bshape = [1, -1] + [1] * (x.dim() - 2)
    if weight is not None:
        out = out * weight.reshape(bshape)
    if bias is not None:
        out = out + bias.reshape(bshape)
    if data_format != "NCHW":
        out = torch.movedim(out, 1, -1)
    return out


@op
def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, use_input_stats=True, momentum=0.9, eps=1e-05,
                  data_format="NCHW", name=None):
    dims = tuple(range(2, x.dim()))
    mean = torch.mean(x, dim=dims, keepdim=True)
    out = (x - mean) * torch.rsqrt(_var(x, dims) + eps)
    bshape = [1, -1] + [1] * (x.dim() - 2)
    if weight is not None:
        out = out * weight.reshape(bshape)
    if bias is not None:
        out = out + bias.reshape(bshape)
    return out


@op
def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0,
                        data_format="NCHW", name=None):
    sq = torch.square(x)
    half = size // 2
    c = x.shape[1]
    padded = TF.pad(sq.movedim(1, -1), (half, size - 1 - half)).movedim(-1, 1)
    acc = sum(padded[:, i:i + c] for i in range(size))
    return x / torch.pow(k + alpha * acc, beta)


@op
def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    n = torch.pow(torch.sum(torch.pow(torch.abs(x), p), dim=axis,
                            keepdim=True), 1.0 / p)
    return x / torch.clamp(n, min=epsilon)


# ------------------------------------------------------------------- losses

def _reduce(loss, reduction):
    if reduction == "mean":
        return torch.mean(loss)
    if reduction == "sum":
        return torch.sum(loss)
    return loss


@op
def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    n_classes = input.shape[axis]
    logp = torch.log_softmax(input, dim=axis) if use_softmax \
        else torch.log(torch.clamp(input, 1e-15, 1.0))
    if soft_label:
        loss = -torch.sum(label * logp, dim=axis)
        mask = None
    else:
        lab = label
        if lab.dim() == input.dim() and lab.shape[axis] == 1:
            lab = torch.squeeze(lab, dim=axis)
        if label_smoothing > 0.0:
            onehot = torch.movedim(TF.one_hot(lab.long(), n_classes), -1,
                                   axis % input.dim()).to(logp.dtype)
            smoothed = onehot * (1 - label_smoothing) \
                + label_smoothing / n_classes
            loss = -torch.sum(smoothed * logp, dim=axis)
        else:
            safe = torch.where(lab == ignore_index, 0, lab).long()
            picked = torch.gather(logp, axis, safe.unsqueeze(axis))
            loss = -torch.squeeze(picked, dim=axis)
        mask = lab != ignore_index
        loss = torch.where(mask, loss, _zero(loss))
        if weight is not None:
            w = weight[torch.where(lab == ignore_index, 0, lab).long()]
            w = torch.where(mask, w, _zero(w))
            loss = loss * w
            if reduction == "mean":
                return torch.sum(loss) / torch.clamp(torch.sum(w),
                                                     min=1e-12)
    if reduction == "mean" and not soft_label and mask is not None:
        denom = torch.clamp(torch.sum(mask.to(loss.dtype)), min=1.0)
        return torch.sum(loss) / denom
    return _reduce(loss, reduction)


softmax_with_cross_entropy = cross_entropy


@op
def nll_loss(input, label, weight=None, ignore_index=-100, reduction="mean",
             name=None):
    axis = -1 if input.dim() == 2 else 1
    safe = torch.where(label == ignore_index, 0, label).long()
    picked = torch.gather(input, axis, safe.unsqueeze(axis))
    loss = -torch.squeeze(picked, dim=axis)
    mask = label != ignore_index
    loss = torch.where(mask, loss, _zero(loss))
    if weight is not None:
        w = weight[torch.where(mask, label, 0).long()]
        loss = loss * torch.where(mask, w, _zero(w))
        if reduction == "mean":
            return torch.sum(loss) / torch.sum(torch.where(mask, w, 0))
    if reduction == "mean":
        return torch.sum(loss) / torch.clamp(torch.sum(mask), min=1)
    return _reduce(loss, reduction)


@op
def mse_loss(input, label, reduction="mean", name=None):
    return _reduce(torch.square(input - label), reduction)


@op
def l1_loss(input, label, reduction="mean", name=None):
    return _reduce(torch.abs(input - label), reduction)


@op
def smooth_l1_loss(input, label, reduction="mean", delta=1.0, name=None):
    d = torch.abs(input - label)
    loss = torch.where(d < delta, 0.5 * d * d, delta * (d - 0.5 * delta))
    return _reduce(loss, reduction)


@op
def binary_cross_entropy(input, label, weight=None, reduction="mean",
                         name=None):
    eps = 1e-12
    loss = -(label * torch.log(torch.clamp(input, eps, 1.0))
             + (1 - label) * torch.log(torch.clamp(1 - input, eps, 1.0)))
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


@op
def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None,
                                     name=None):
    max_val = torch.clamp(-logit, min=0)
    soft = torch.log1p(torch.exp(-torch.abs(logit))) + max_val
    if pos_weight is not None:
        loss = (1 - label) * logit + ((pos_weight - 1) * label + 1) * soft
    else:
        loss = (1 - label) * logit + soft
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


sigmoid_cross_entropy_with_logits = binary_cross_entropy_with_logits


@op
def kl_div(input, label, reduction="mean", log_target=False, name=None):
    if log_target:
        loss = torch.exp(label) * (label - input)
    else:
        loss = torch.where(label > 0, label * (
            torch.log(torch.clamp(label, min=1e-12)) - input), _zero(input))
    if reduction == "batchmean":
        return torch.sum(loss) / input.shape[0]
    return _reduce(loss, reduction)


@op
def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean",
                        name=None):
    return _reduce(torch.clamp(-label * (input - other) + margin, min=0),
                   reduction)


@op
def hinge_embedding_loss(input, label, margin=1.0, reduction="mean",
                         name=None):
    loss = torch.where(label == 1, input,
                       torch.clamp(margin - input, min=0))
    return _reduce(loss, reduction)


@op
def cosine_similarity(x1, x2, axis=1, eps=1e-8):
    dot = torch.sum(x1 * x2, dim=axis)
    n1 = torch.linalg.vector_norm(x1, dim=axis)
    n2 = torch.linalg.vector_norm(x2, dim=axis)
    return dot / torch.clamp(n1 * n2, min=eps)


@op
def cosine_embedding_loss(input1, input2, label, margin=0.0,
                          reduction="mean", name=None):
    cos = torch.sum(input1 * input2, dim=-1) / torch.clamp(
        torch.linalg.vector_norm(input1, dim=-1)
        * torch.linalg.vector_norm(input2, dim=-1), min=1e-12)
    loss = torch.where(label == 1, 1 - cos, torch.clamp(cos - margin, min=0))
    return _reduce(loss, reduction)


@op
def triplet_margin_loss(input, positive, negative, margin=1.0, p=2.0,
                        epsilon=1e-6, swap=False, reduction="mean",
                        name=None):
    def dist(a, b):
        return torch.pow(torch.sum(torch.pow(torch.abs(a - b) + epsilon, p),
                                   dim=-1), 1.0 / p)
    d_pos = dist(input, positive)
    d_neg = dist(input, negative)
    if swap:
        d_neg = torch.minimum(d_neg, dist(positive, negative))
    return _reduce(torch.clamp(d_pos - d_neg + margin, min=0), reduction)


@op
def square_error_cost(input, label):
    return torch.square(input - label)


@op
def log_loss(input, label, epsilon=1e-4, name=None):
    return -label * torch.log(input + epsilon) \
        - (1 - label) * torch.log(1 - input + epsilon)


# ------------------------------------------------------------- interpolate

def _triangle(x):
    return torch.clamp(1 - torch.abs(x), min=0)


def _keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _weight_mat(n_in, n_out, kernel, device):
    """``jax.image.resize``'s [n_in, n_out] resampling weights (its
    ``compute_weight_mat``, antialiased: the kernel widens by the
    downsampling factor)."""
    inv = n_in / n_out
    kscale = max(inv, 1.0)
    f = (torch.arange(n_out, dtype=torch.float64, device=device) + 0.5) \
        * inv - 0.5
    x = torch.abs(f[None, :] - torch.arange(n_in, dtype=torch.float64,
                                            device=device)[:, None]) / kscale
    w = kernel(x)
    tot = w.sum(0, keepdim=True)
    w = torch.where(tot.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(tot != 0, tot, torch.ones_like(tot)),
                    torch.zeros_like(w))
    inside = (f >= -0.5) & (f <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def _resize(x, out_shape, mode):
    out = x if x.is_floating_point() else x.float()
    for d in range(x.dim()):
        n_in, n_out = x.shape[d], out_shape[d]
        if n_in == n_out:
            continue
        if mode == "nearest":
            idx = torch.floor((torch.arange(n_out, dtype=torch.float32)
                               + 0.5) * n_in / n_out).long()
            out = torch.index_select(out, d, idx.to(x.device))
            continue
        kernel = _keys_cubic if mode == "cubic" else _triangle
        w = _weight_mat(n_in, n_out, kernel, x.device).to(out.dtype)
        out = torch.movedim(torch.tensordot(torch.movedim(out, d, -1), w,
                                            dims=1), -1, d)
    return out


def _resize_align_corners(x, out_shape, chan_first):
    sp = list(range(2, x.dim())) if chan_first else list(range(1, x.dim() - 1))
    out = x
    for ax in sp:
        in_s, out_s = x.shape[ax], out_shape[ax]
        if in_s == out_s:
            continue
        idx = torch.linspace(0.0, in_s - 1, out_s, dtype=torch.float64,
                             device=x.device)
        lo = torch.floor(idx).long()
        hi = torch.clamp(lo + 1, 0, in_s - 1)
        shape = [1] * out.dim()
        shape[ax] = -1
        w = (idx - lo).to(x.dtype).reshape(shape)
        out = torch.index_select(out, ax, lo) * (1 - w) + \
            torch.index_select(out, ax, hi) * w
    return out


@op
def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, align_mode=0, data_format="NCHW",
                name=None):
    chan_first = data_format in ("NCHW", "NCW", "NCDHW")
    spatial = x.shape[2:] if chan_first else x.shape[1:-1]
    if size is None:
        if not isinstance(scale_factor, (list, tuple)):
            scale_factor = [scale_factor] * len(spatial)
        size = [int(s * f) for s, f in zip(spatial, scale_factor)]
    else:
        if isinstance(size, torch.Tensor):
            size = size.tolist()
        size = [int(s) for s in (size if isinstance(size, (list, tuple))
                                 else [size])]
    rmode = {"nearest": "nearest", "bilinear": "linear", "linear": "linear",
             "trilinear": "linear", "bicubic": "cubic",
             "area": "linear"}[mode]
    if chan_first:
        out_shape = tuple(x.shape[:2]) + tuple(size)
    else:
        out_shape = (x.shape[0],) + tuple(size) + (x.shape[-1],)
    if mode != "nearest" and align_corners:
        out = _resize_align_corners(x, out_shape, chan_first)
    else:
        out = _resize(x, out_shape, rmode)
    return out.to(x.dtype)


upsample = interpolate


@op
def pixel_shuffle(x, upscale_factor, data_format="NCHW", name=None):
    return TF.pixel_shuffle(x, upscale_factor)


@op
def pixel_unshuffle(x, downscale_factor, data_format="NCHW", name=None):
    return TF.pixel_unshuffle(x, downscale_factor)


@op
def unfold_(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    k, s, d = _pair(kernel_sizes), _pair(strides), _pair(dilations)
    pads = _explicit_pads(_conv_padding(paddings, 2), x.shape[2:], k, s, d)
    return TF.unfold(_pad_spatial(x, pads), k, d, 0, s)


# ------------------------------------------------------------- attention

@op
def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, name=None):
    """Fused SDPA, layout [batch, seqlen, heads, head_dim], through the
    port's ``sdpa`` (the K1/K2 and K8 kernels on the card)."""
    from ..ops.pallas.flash_attention import sdpa
    return sdpa(query, key, value, attn_mask=attn_mask,
                dropout_p=dropout_p, is_causal=is_causal, training=training,
                generator=generator_for(query.device) if dropout_p else None)


@op
def softmax_mask_fuse_upper_triangle(x):
    n = x.shape[-1]
    mask = torch.ones((n, n), dtype=torch.bool, device=x.device).tril()
    return torch.softmax(torch.where(mask, x, torch.tensor(
        -1e9, dtype=x.dtype)), dim=-1)


# --------------------------------------------------------------------- misc

@op
def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    k = label.shape[-1]
    if prior_dist is not None:
        return (1 - epsilon) * label + epsilon * prior_dist
    return (1 - epsilon) * label + epsilon / k


@op
def npair_loss(anchor, positive, labels, l2_reg=0.002):
    sim = torch.matmul(anchor, positive.T)
    lab = labels.reshape(-1, 1)
    target = (lab == lab.T).to(sim.dtype)
    target = target / torch.sum(target, dim=1, keepdim=True)
    ce = torch.mean(torch.sum(-target * torch.log_softmax(sim, dim=1),
                              dim=1))
    reg = l2_reg * (torch.mean(torch.sum(torch.square(anchor), 1))
                    + torch.mean(torch.sum(torch.square(positive), 1))) / 2
    return ce + reg


@op
def pad_sequence(sequences, padding_value=0.0, batch_first=False):
    out = torch.nn.utils.rnn.pad_sequence(list(sequences), batch_first=True,
                                          padding_value=padding_value)
    return out if batch_first else torch.swapaxes(out, 0, 1)


@op
def temporal_shift(x, seg_num, shift_ratio=0.25, data_format="NCHW",
                   name=None):
    nt, c, h, w = x.shape
    n = nt // seg_num
    x5 = x.reshape(n, seg_num, c, h, w)
    fold = int(c * shift_ratio)
    left = torch.cat([x5[:, 1:, :fold],
                      torch.zeros_like(x5[:, :1, :fold])], 1)
    right = torch.cat([torch.zeros_like(x5[:, :1, fold:2 * fold]),
                       x5[:, :-1, fold:2 * fold]], 1)
    rest = x5[:, :, 2 * fold:]
    return torch.cat([left, right, rest], dim=2).reshape(nt, c, h, w)


def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1,
         name=None):
    """Inverse of unfold_: sum [B, C*kh*kw, L] patches back to
    [B, C, H, W]."""
    def body(xarr):
        return TF.fold(xarr, _pair(output_sizes), _pair(kernel_sizes),
                       _pair(dilations), _pair(paddings), _pair(strides))

    return apply_op("fold", body, (x,), {})


# paddle-shaped aliases / in-place functional forms
from . import functional_extra2 as _fe2  # noqa: E402


def flashmask_attention(query, key, value, startend_row_indices=None,
                        **kwargs):
    """``functional_extra2.flashmask_attention`` on Tensor handles."""
    kwargs.setdefault("generator", generator_for(query._data.device))
    return apply_op("flashmask_attention", _fe2.flashmask_attention,
                    (query, key, value, startend_row_indices), kwargs)


from ..ops.manipulation import pad  # noqa: E402,F401
unfold = unfold_  # noqa: E402  (im2col; `unfold_` kept for back-compat)


def _make_functional_inplace(fn):
    def inplace(x, *args, **kwargs):
        return x._rebind_(fn(x, *args, **kwargs))
    inplace.__name__ = fn.__name__ + "_"
    return inplace


relu_ = _make_functional_inplace(relu)
elu_ = _make_functional_inplace(elu)
tanh_ = _make_functional_inplace(tanh)
softmax_ = _make_functional_inplace(softmax)
leaky_relu_ = _make_functional_inplace(leaky_relu)
hardtanh_ = _make_functional_inplace(hardtanh)
