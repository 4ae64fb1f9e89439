"""Convolution layers (ports ``paddle_tpu/nn/layer_conv.py``;
reference: python/paddle/nn/layer/conv.py).  The reference's init and
parameter names: weight and bias U(-1/sqrt(fan_in), 1/sqrt(fan_in)),
over the port's ``F.conv*`` (cuDNN on the card)."""
from __future__ import annotations

import numpy as np

from .layer import Layer
from . import functional as F
from .initializer import Uniform

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv2DTranspose"]


def _tuple(v, n):
    return tuple(v) if isinstance(v, (list, tuple)) else (int(v),) * n


class _ConvNd(Layer):
    def __init__(self, nd, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format=None,
                 transpose=False, output_padding=0):
        super().__init__()
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.kernel_size = _tuple(kernel_size, nd)
        self.stride = _tuple(stride, nd)
        self.padding = padding
        self.dilation = _tuple(dilation, nd)
        self.groups = groups
        self.padding_mode = padding_mode
        self.data_format = data_format
        self.output_padding = output_padding
        self._transpose = transpose
        if transpose:
            w_shape = [in_channels, out_channels // groups, *self.kernel_size]
        else:
            w_shape = [out_channels, in_channels // groups, *self.kernel_size]
        fan_in = (in_channels // groups) * int(np.prod(self.kernel_size))
        bound = 1.0 / np.sqrt(fan_in)
        self.weight = self.create_parameter(
            w_shape, attr=weight_attr, default_initializer=Uniform(-bound, bound))
        self.bias = self.create_parameter(
            [out_channels], attr=bias_attr, is_bias=True,
            default_initializer=Uniform(-bound, bound))

    def extra_repr(self):
        return (f"{self.in_channels}, {self.out_channels}, "
                f"kernel_size={list(self.kernel_size)}, stride={list(self.stride)}")


class Conv1D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCL"):
        super().__init__(1, in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, padding_mode, weight_attr,
                         bias_attr, data_format)

    def forward(self, x):
        return F.conv1d(x, self.weight, self.bias, stride=self.stride,
                        padding=self.padding, dilation=self.dilation,
                        groups=self.groups, data_format=self.data_format)


class Conv2D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW"):
        super().__init__(2, in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, padding_mode, weight_attr,
                         bias_attr, data_format)

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, stride=self.stride,
                        padding=self.padding, dilation=self.dilation,
                        groups=self.groups, data_format=self.data_format)


class Conv3D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCDHW"):
        super().__init__(3, in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, padding_mode, weight_attr,
                         bias_attr, data_format)

    def forward(self, x):
        return F.conv3d(x, self.weight, self.bias, stride=self.stride,
                        padding=self.padding, dilation=self.dilation,
                        groups=self.groups, data_format=self.data_format)


class Conv2DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format="NCHW"):
        super().__init__(2, in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, transpose=True,
                         output_padding=output_padding)

    def forward(self, x, output_size=None):
        return F.conv2d_transpose(
            x, self.weight, self.bias, stride=self.stride,
            padding=self.padding, output_padding=self.output_padding,
            groups=self.groups, dilation=self.dilation,
            output_size=output_size, data_format=self.data_format)
