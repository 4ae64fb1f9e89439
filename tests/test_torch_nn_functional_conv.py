"""``paddle_tpu_torch.nn.functional``'s convolutions, pools, resampling,
im2col (``unfold_``/``fold``) and attention against the reference's
``nn/functional.py`` (the rest: ``test_torch_nn_functional.py``):
forward values and dtypes and gradients on seeded numpy inputs, f32,
rtol 1e-5 / atol 1e-5 unless a spec states its own."""
import numpy as np
import pytest

import paddle_tpu.nn.functional as JF
import paddle_tpu_torch.nn.functional as TF
from paddle_tpu.ops.registry import OPS as JOPS
from paddle_tpu_torch.ops.registry import OPS as TOPS
from torch_op_parity import Spec, check, cpu_place, reference, rng

_cpu = pytest.fixture(autouse=True)(cpu_place)

R = rng(4)
TOL = (1e-5, 1e-5)


def f(*shape):
    return R.standard_normal(shape).astype(np.float32)


def S(*args, **kw):
    kw.setdefault("tol", TOL)
    return Spec(*args, **kw)


IMG = f(2, 4, 7, 7)
D = (0,)

SPECS = {
    # conv
    "conv2d": S(IMG, f(6, 4, 3, 3), f(6), stride=2, padding=1,
                diff=(0, 1, 2)),
    "conv2d#same_groups": S(IMG, f(4, 2, 3, 3), padding="SAME", groups=2,
                            dilation=2, diff=(0, 1)),
    "conv2d#nhwc": S(f(2, 7, 7, 4), f(6, 4, 3, 3), padding=[1, 0, 2, 1],
                     data_format="NHWC", diff=(0, 1)),
    "conv1d": S(f(2, 3, 9), f(5, 3, 3), f(5), stride=2, padding="VALID",
                diff=(0, 1, 2)),
    "conv3d": S(f(1, 2, 5, 5, 5), f(3, 2, 2, 2, 2), padding=1,
                diff=(0, 1)),
    "conv2d_transpose": S(f(2, 4, 5, 5), f(4, 3, 3, 3), f(3), stride=2,
                          padding=1, output_padding=1, diff=(0, 1, 2)),
    "conv2d_transpose#output_size": S(f(1, 4, 4, 4), f(4, 2, 2, 2),
                                      stride=2, output_size=[9, 9],
                                      diff=(0, 1)),
    # pooling
    "max_pool2d": S(IMG, 3, stride=2, padding=1, diff=D),
    "max_pool2d#ceil_mask": S(IMG, 2, ceil_mode=True, return_mask=True,
                              diff=D),
    "avg_pool2d": S(IMG, 3, stride=2, padding=1, diff=D),
    "avg_pool2d#inclusive_ceil": S(IMG, 2, ceil_mode=True, exclusive=False,
                                   diff=D),
    "max_pool1d": S(f(2, 3, 9), 3, stride=2, padding=1, diff=D),
    "avg_pool1d": S(f(2, 3, 9), 2, ceil_mode=True, diff=D),
    "adaptive_avg_pool2d": S(IMG, [3, 4], diff=D),
    "adaptive_max_pool2d": S(IMG, 3, diff=D),
    "adaptive_avg_pool1d": S(f(2, 3, 10), 4, diff=D),
    # resampling and layout
    "interpolate": S(IMG, size=[10, 12], mode="bilinear", diff=D),
    "interpolate#down_bicubic": S(IMG, scale_factor=0.5, mode="bicubic",
                                  diff=D),
    "interpolate#nearest": S(IMG, size=[5, 11], diff=D),
    "interpolate#align_corners": S(IMG, size=[9, 9], mode="bilinear",
                                   align_corners=True, diff=D),
    "pixel_shuffle": S(f(1, 8, 3, 3), 2, diff=D),
    "pixel_unshuffle": S(f(1, 2, 4, 6), 2, diff=D),
    "unfold_": S(IMG, 3, strides=2, paddings=1, diff=D),
    "fold": S(f(2, 4 * 9, 16), [7, 7], 3, strides=2, paddings=1, diff=D),
    # attention
    "scaled_dot_product_attention": S(f(2, 8, 4, 16), f(2, 8, 2, 16),
                                      f(2, 8, 2, 16), is_causal=True,
                                      diff=(0, 1, 2), tol=(1e-4, 1e-5)),
    "softmax_mask_fuse_upper_triangle": S(f(2, 5, 5), diff=D),
}


def _bodies():
    out = {}
    for key in SPECS:
        name = key.split("#")[0]
        # fold is not a registered op: its reference dispatches itself
        out[key] = (lambda *a, **k: JF.fold(*a, **k)._data) \
            if name == "fold" else JOPS[name].__op_body__
    return out


def _port(key):
    name = key.split("#")[0]
    return TF.fold if name == "fold" else TOPS[name]


@pytest.fixture(scope="module")
def ref():
    return reference(_bodies(), SPECS)


@pytest.mark.parametrize("key", sorted(SPECS))
def test_op_matches_reference(key, ref):
    check(ref[key], _port(key), SPECS[key], key)
