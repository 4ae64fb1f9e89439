"""Pooling layers (ports ``paddle_tpu/nn/layer_pool.py``; reference:
python/paddle/nn/layer/pooling.py), over the port's ``F`` pools."""
from __future__ import annotations

from .layer import Layer
from . import functional as F

__all__ = ["MaxPool1D", "MaxPool2D", "AvgPool1D", "AvgPool2D",
           "AdaptiveAvgPool1D", "AdaptiveAvgPool2D", "AdaptiveMaxPool2D"]


class MaxPool2D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 return_mask=False, data_format="NCHW", name=None):
        super().__init__()
        self.args = (kernel_size, stride, padding, ceil_mode, return_mask,
                     data_format)

    def forward(self, x):
        k, s, p, cm, rm, df = self.args
        return F.max_pool2d(x, k, stride=s, padding=p, ceil_mode=cm,
                            return_mask=rm, data_format=df)


class AvgPool2D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self.args = (kernel_size, stride, padding, ceil_mode, exclusive,
                     divisor_override, data_format)

    def forward(self, x):
        k, s, p, cm, ex, dv, df = self.args
        return F.avg_pool2d(x, k, stride=s, padding=p, ceil_mode=cm,
                            exclusive=ex, divisor_override=dv, data_format=df)


class MaxPool1D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, return_mask=False,
                 ceil_mode=False, name=None):
        super().__init__()
        self.args = (kernel_size, stride, padding, return_mask, ceil_mode)

    def forward(self, x):
        k, s, p, rm, cm = self.args
        return F.max_pool1d(x, k, stride=s, padding=p, return_mask=rm,
                            ceil_mode=cm)


class AvgPool1D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, exclusive=True,
                 ceil_mode=False, name=None):
        super().__init__()
        self.args = (kernel_size, stride, padding, exclusive, ceil_mode)

    def forward(self, x):
        k, s, p, ex, cm = self.args
        return F.avg_pool1d(x, k, stride=s, padding=p, exclusive=ex,
                            ceil_mode=cm)


class AdaptiveAvgPool1D(Layer):
    def __init__(self, output_size, name=None):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        return F.adaptive_avg_pool1d(x, self.output_size)


class AdaptiveAvgPool2D(Layer):
    def __init__(self, output_size, data_format="NCHW", name=None):
        super().__init__()
        self.output_size = output_size
        self.data_format = data_format

    def forward(self, x):
        return F.adaptive_avg_pool2d(x, self.output_size,
                                     data_format=self.data_format)


class AdaptiveMaxPool2D(Layer):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__()
        self.output_size = output_size
        self.return_mask = return_mask

    def forward(self, x):
        return F.adaptive_max_pool2d(x, self.output_size,
                                     return_mask=self.return_mask)
