"""Common layers (ports ``paddle_tpu/nn/layer_common.py``; reference:
python/paddle/nn/layer/common.py, container.py, activation.py)."""
from __future__ import annotations

import collections

import torch

from .layer import Layer
from . import functional as F
from ..ops.registry import apply_op

__all__ = [
    "Linear", "Embedding", "Dropout", "Dropout2D", "AlphaDropout", "Flatten",
    "Identity", "Upsample", "UpsamplingBilinear2D", "UpsamplingNearest2D",
    "Pad1D", "Pad2D", "Pad3D", "ZeroPad2D", "CosineSimilarity", "Bilinear",
    "Sequential", "LayerList", "ParameterList", "LayerDict",
    "Softmax2D", "ChannelShuffle", "PairwiseDistance", "Fold",
    "ReLU", "ReLU6", "GELU", "Sigmoid", "Tanh", "Softmax", "LogSoftmax",
    "LeakyReLU", "ELU", "SELU", "CELU", "PReLU", "RReLU", "Hardswish",
    "Hardsigmoid", "Hardtanh", "Hardshrink", "Softshrink", "Tanhshrink",
    "Softplus", "Softsign", "Mish", "Silu", "Swish", "GLU", "Maxout",
    "PixelShuffle", "PixelUnshuffle", "Unfold",
]


class Linear(Layer):
    """y = x @ W + b, W: [in_features, out_features] (reference:
    python/paddle/nn/layer/common.py Linear)."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.weight = self.create_parameter(
            [in_features, out_features], attr=weight_attr)
        self.bias = self.create_parameter(
            [out_features], attr=bias_attr, is_bias=True)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return f"in_features={self.in_features}, out_features={self.out_features}"


class Embedding(Layer):
    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None):
        super().__init__()
        from .initializer import Normal
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.padding_idx = padding_idx
        if sparse:
            raise NotImplementedError(
                "Embedding(sparse=True): row-sparse gradients "
                "(selected_rows) are not ported yet; use sparse=False")
        self.sparse = sparse
        self.weight = self.create_parameter(
            [num_embeddings, embedding_dim], attr=weight_attr,
            default_initializer=Normal(0.0, 1.0))
        if padding_idx is not None:
            w = self.weight._data.detach().clone()
            w[padding_idx] = 0.0
            self.weight._set_data(w)

    def forward(self, x):
        return F.embedding(x, self.weight, padding_idx=self.padding_idx,
                           sparse=self.sparse)

    def extra_repr(self):
        return f"{self.num_embeddings}, {self.embedding_dim}"


class Dropout(Layer):
    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None):
        super().__init__()
        self.p = p
        self.axis = axis
        self.mode = mode

    def forward(self, x):
        return F.dropout(x, p=self.p, axis=self.axis, training=self.training,
                         mode=self.mode)

    def extra_repr(self):
        return f"p={self.p}"


class Dropout2D(Layer):
    def __init__(self, p=0.5, data_format="NCHW", name=None):
        super().__init__()
        self.p = p
        self.data_format = data_format

    def forward(self, x):
        return F.dropout2d(x, p=self.p, training=self.training,
                           data_format=self.data_format)


class AlphaDropout(Layer):
    def __init__(self, p=0.5, name=None):
        super().__init__()
        self.p = p

    def forward(self, x):
        return F.alpha_dropout(x, p=self.p, training=self.training)


class Flatten(Layer):
    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis = start_axis
        self.stop_axis = stop_axis

    def forward(self, x):
        return x.flatten(self.start_axis, self.stop_axis)


class Identity(Layer):
    def __init__(self, *args, **kwargs):
        super().__init__()

    def forward(self, x):
        return x


class Upsample(Layer):
    def __init__(self, size=None, scale_factor=None, mode="nearest",
                 align_corners=False, align_mode=0, data_format="NCHW",
                 name=None):
        super().__init__()
        self.size = size
        self.scale_factor = scale_factor
        self.mode = mode
        self.align_corners = align_corners
        self.align_mode = align_mode
        self.data_format = data_format

    def forward(self, x):
        return F.interpolate(x, size=self.size, scale_factor=self.scale_factor,
                             mode=self.mode, align_corners=self.align_corners,
                             align_mode=self.align_mode,
                             data_format=self.data_format)


class UpsamplingBilinear2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "bilinear", True, 0, data_format)


class UpsamplingNearest2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "nearest", False, 0, data_format)


class _PadN(Layer):
    def __init__(self, padding, mode="constant", value=0.0, data_format="NCL",
                 name=None):
        super().__init__()
        self.padding = padding
        self.mode = mode
        self.value = value
        self.data_format = data_format

    def forward(self, x):
        from ..ops.manipulation import pad
        return pad(x, self.padding, mode=self.mode, value=self.value,
                   data_format=self.data_format)


class Pad1D(_PadN):
    def __init__(self, padding, mode="constant", value=0.0, data_format="NCL",
                 name=None):
        super().__init__(padding, mode, value, data_format, name)


class Pad2D(_PadN):
    def __init__(self, padding, mode="constant", value=0.0, data_format="NCHW",
                 name=None):
        super().__init__(padding, mode, value, data_format, name)


class Pad3D(_PadN):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCDHW", name=None):
        super().__init__(padding, mode, value, data_format, name)


class ZeroPad2D(Pad2D):
    def __init__(self, padding, data_format="NCHW", name=None):
        super().__init__(padding, "constant", 0.0, data_format, name)


class CosineSimilarity(Layer):
    def __init__(self, axis=1, eps=1e-8):
        super().__init__()
        self.axis = axis
        self.eps = eps

    def forward(self, x1, x2):
        return F.cosine_similarity(x1, x2, axis=self.axis, eps=self.eps)


class Bilinear(Layer):
    def __init__(self, in1_features, in2_features, out_features,
                 weight_attr=None, bias_attr=None, name=None):
        super().__init__()
        self.weight = self.create_parameter(
            [out_features, in1_features, in2_features], attr=weight_attr)
        self.bias = self.create_parameter([out_features], attr=bias_attr,
                                          is_bias=True)

    def forward(self, x1, x2):
        return F.bilinear(x1, x2, self.weight, self.bias)


# ------------------------------------------------------------- containers

class Sequential(Layer):
    def __init__(self, *layers):
        super().__init__()
        if len(layers) == 1 and isinstance(layers[0], collections.OrderedDict):
            for name, layer in layers[0].items():
                self.add_sublayer(name, layer)
        else:
            for i, layer in enumerate(layers):
                if isinstance(layer, tuple):
                    self.add_sublayer(layer[0], layer[1])
                else:
                    self.add_sublayer(str(i), layer)

    def forward(self, x):
        for layer in self._sub_layers.values():
            x = layer(x)
        return x

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return Sequential(*list(self._sub_layers.values())[idx])
        return list(self._sub_layers.values())[idx]

    def __len__(self):
        return len(self._sub_layers)

    def __iter__(self):
        return iter(self._sub_layers.values())


class LayerList(Layer):
    def __init__(self, sublayers=None):
        super().__init__()
        if sublayers is not None:
            for i, l in enumerate(sublayers):
                self.add_sublayer(str(i), l)

    def append(self, sublayer):
        self.add_sublayer(str(len(self._sub_layers)), sublayer)
        return self

    def extend(self, sublayers):
        for l in sublayers:
            self.append(l)
        return self

    def insert(self, index, sublayer):
        layers = list(self._sub_layers.values())
        layers.insert(index, sublayer)
        self._sub_layers.clear()
        for i, l in enumerate(layers):
            self._sub_layers[str(i)] = l

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return LayerList(list(self._sub_layers.values())[idx])
        return list(self._sub_layers.values())[idx]

    def __setitem__(self, idx, layer):
        self._sub_layers[str(idx)] = layer

    def __len__(self):
        return len(self._sub_layers)

    def __iter__(self):
        return iter(self._sub_layers.values())


class ParameterList(Layer):
    def __init__(self, parameters=None):
        super().__init__()
        if parameters is not None:
            for i, p in enumerate(parameters):
                self.add_parameter(str(i), p)

    def append(self, parameter):
        self.add_parameter(str(len(self._parameters)), parameter)
        return self

    def __getitem__(self, idx):
        return list(self._parameters.values())[idx]

    def __len__(self):
        return len(self._parameters)

    def __iter__(self):
        return iter(self._parameters.values())


class LayerDict(Layer):
    def __init__(self, sublayers=None):
        super().__init__()
        if sublayers:
            self.update(sublayers)

    def update(self, sublayers):
        items = sublayers.items() if isinstance(sublayers, dict) else sublayers
        for k, v in items:
            self.add_sublayer(k, v)

    def __getitem__(self, key):
        return self._sub_layers[key]

    def __setitem__(self, key, layer):
        self.add_sublayer(key, layer)

    def __len__(self):
        return len(self._sub_layers)

    def keys(self):
        return self._sub_layers.keys()

    def values(self):
        return self._sub_layers.values()

    def items(self):
        return self._sub_layers.items()


# ------------------------------------------------- activation layer shims

def _act_layer(name, fn, **defaults):
    class _Act(Layer):
        def __init__(self, *args, **kwargs):
            super().__init__()
            merged = dict(defaults)
            merged.pop("name", None)
            names = list(defaults.keys())
            for i, a in enumerate(args):
                merged[names[i]] = a
            for k, v in kwargs.items():
                if k != "name":
                    merged[k] = v
            self._kwargs = merged

        def forward(self, x):
            return fn(x, **self._kwargs)

    _Act.__name__ = name
    _Act.__qualname__ = name
    return _Act


ReLU = _act_layer("ReLU", F.relu)
ReLU6 = _act_layer("ReLU6", F.relu6)
GELU = _act_layer("GELU", F.gelu, approximate=False)
Sigmoid = _act_layer("Sigmoid", F.sigmoid)
Tanh = _act_layer("Tanh", F.tanh)
Softmax = _act_layer("Softmax", F.softmax, axis=-1)
LogSoftmax = _act_layer("LogSoftmax", F.log_softmax, axis=-1)
LeakyReLU = _act_layer("LeakyReLU", F.leaky_relu, negative_slope=0.01)
ELU = _act_layer("ELU", F.elu, alpha=1.0)
SELU = _act_layer("SELU", F.selu)
CELU = _act_layer("CELU", F.celu, alpha=1.0)
RReLU = _act_layer("RReLU", F.rrelu, lower=1.0 / 8.0, upper=1.0 / 3.0)
Hardswish = _act_layer("Hardswish", F.hardswish)
Hardsigmoid = _act_layer("Hardsigmoid", F.hardsigmoid)
Hardtanh = _act_layer("Hardtanh", F.hardtanh, min=-1.0, max=1.0)
Hardshrink = _act_layer("Hardshrink", F.hardshrink, threshold=0.5)
Softshrink = _act_layer("Softshrink", F.softshrink, threshold=0.5)
Tanhshrink = _act_layer("Tanhshrink", F.tanhshrink)
Softplus = _act_layer("Softplus", F.softplus, beta=1.0, threshold=20.0)
Softsign = _act_layer("Softsign", F.softsign)
Mish = _act_layer("Mish", F.mish)
Silu = _act_layer("Silu", F.silu)
Swish = _act_layer("Swish", F.silu)
GLU = _act_layer("GLU", F.glu, axis=-1)
Maxout = _act_layer("Maxout", F.maxout, groups=2, axis=1)


class PReLU(Layer):
    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format="NCHW", name=None):
        super().__init__()
        from .initializer import Constant
        self.data_format = data_format
        self.weight = self.create_parameter(
            [num_parameters], attr=weight_attr,
            default_initializer=Constant(init))

    def forward(self, x):
        return F.prelu(x, self.weight, data_format=self.data_format)


class PixelShuffle(Layer):
    def __init__(self, upscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.upscale_factor = upscale_factor

    def forward(self, x):
        return F.pixel_shuffle(x, self.upscale_factor)


class PixelUnshuffle(Layer):
    def __init__(self, downscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.downscale_factor = downscale_factor

    def forward(self, x):
        return F.pixel_unshuffle(x, self.downscale_factor)


class Unfold(Layer):
    def __init__(self, kernel_sizes, strides=1, paddings=0, dilations=1,
                 name=None):
        super().__init__()
        self.args = (kernel_sizes, strides, paddings, dilations)

    def forward(self, x):
        return F.unfold_(x, *self.args)


class Softmax2D(Layer):
    """Softmax over the channel dim of NCHW input (reference:
    python/paddle/nn/layer/activation.py Softmax2D)."""

    def forward(self, x):
        if x.ndim not in (3, 4):
            raise ValueError(f"Softmax2D expects 3D/4D input, got {x.ndim}D")
        return F.softmax(x, axis=-3)


class ChannelShuffle(Layer):
    """Reference: python/paddle/nn/layer/vision.py ChannelShuffle."""

    def __init__(self, groups, data_format="NCHW", name=None):
        super().__init__()
        self.groups = groups
        self.data_format = data_format

    def forward(self, x):
        from ..ops.manipulation import reshape, transpose
        g = self.groups
        if self.data_format == "NCHW":
            b, c, h, w = x.shape
            x = reshape(x, [b, g, c // g, h, w])
            x = transpose(x, [0, 2, 1, 3, 4])
            return reshape(x, [b, c, h, w])
        b, h, w, c = x.shape
        x = reshape(x, [b, h, w, g, c // g])
        x = transpose(x, [0, 1, 2, 4, 3])
        return reshape(x, [b, h, w, c])


class PairwiseDistance(Layer):
    """Reference: python/paddle/nn/layer/distance.py."""

    def __init__(self, p=2.0, epsilon=1e-6, keepdim=False, name=None):
        super().__init__()
        self.p = p
        self.epsilon = epsilon
        self.keepdim = keepdim

    def forward(self, x, y):
        d = x - y + self.epsilon
        # the vector p-norm of ops/linalg.norm, which waits with linalg
        return apply_op("norm", lambda t: torch.linalg.vector_norm(
            t, ord=self.p, dim=-1, keepdim=self.keepdim), (d,), {})


class Fold(Layer):
    """Inverse of Unfold: [B, C*kh*kw, L] -> [B, C, H, W] by summing
    overlapping patches (reference: python/paddle/nn/layer/common.py
    Fold; kernel fold_kernel)."""

    def __init__(self, output_sizes, kernel_sizes, strides=1, paddings=0,
                 dilations=1, name=None):
        super().__init__()
        from .functional import _pair
        self.output_sizes = _pair(output_sizes)
        self.kernel_sizes = _pair(kernel_sizes)
        self.strides = _pair(strides)
        self.paddings = _pair(paddings)
        self.dilations = _pair(dilations)

    def forward(self, x):
        return F.fold(x, self.output_sizes, self.kernel_sizes,
                      self.strides, self.paddings, self.dilations)
