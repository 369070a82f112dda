"""Common layers (``paddle_tpu/nn/common_layers.py``): Linear, Embedding,
the dropouts, the containers, Flatten / Identity, the Upsample layers,
the pads (``Pad1D/2D/3D``, ``ZeroPad2D``), Bilinear, CosineSimilarity,
``PixelShuffle`` / ``PixelUnshuffle``, ``ChannelShuffle``, ``Unfold`` /
``Fold``, the activation layers and PReLU.

Constructors take the JAX package's arguments (``weight_attr`` /
``bias_attr`` read duck-typed by ``Layer.create_parameter``; a
``bias_attr`` of False drops the bias) plus ``dtype`` and ``device``
where the layer has parameters.  State-dict names are the JAX
package's."""

from __future__ import annotations

import collections

import torch

from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn import initializer as I
from paddle_tpu_torch.nn.layer import Layer

__all__ = [
    "Linear", "Embedding", "Dropout", "Dropout2D", "Dropout3D",
    "AlphaDropout", "Sequential", "LayerList", "LayerDict", "ParameterList",
    "Flatten", "Identity", "Upsample", "UpsamplingBilinear2D",
    "UpsamplingNearest2D", "Pad1D", "Pad2D", "Pad3D", "ZeroPad2D",
    "CosineSimilarity", "Bilinear", "PixelShuffle", "PixelUnshuffle",
    "ChannelShuffle", "Unfold", "Fold",
    "ReLU", "ReLU6", "GELU", "SiLU", "Swish", "Mish", "Sigmoid", "Tanh",
    "LeakyReLU", "ELU", "CELU", "SELU", "Hardswish", "Hardsigmoid",
    "Hardtanh", "Hardshrink", "Softshrink", "Tanhshrink", "ThresholdedReLU",
    "Softplus", "Softsign", "LogSigmoid", "Softmax", "LogSoftmax", "PReLU",
    "RReLU", "Maxout", "GLU",
]


class Linear(Layer):
    """y = x @ W + b with W of shape ``[in, out]`` (the JAX package's
    layout, so weights copy across without a transpose)."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None, dtype="float32", device=None):
        super().__init__(dtype=dtype, device=device)
        self.weight = self.create_parameter([in_features, out_features],
                                            attr=weight_attr)
        if bias_attr is False:
            self.bias = None
        else:
            self.bias = self.create_parameter([out_features], attr=bias_attr,
                                              is_bias=True)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class Embedding(Layer):
    """Row lookup into a ``[num_embeddings, embedding_dim]`` table,
    initialised N(0, 1) (Xavier-normal when a ``weight_attr`` is given
    without an initializer, as in the JAX package); the ``padding_idx``
    row starts at zero and looks up as zero.  ``sparse=True`` gives the
    weight a row-sparse gradient where ``F.embedding`` allows one."""

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None, dtype="float32",
                 device=None):
        super().__init__(dtype=dtype, device=device)
        self._padding_idx = padding_idx
        self._sparse = sparse
        self.weight = self.create_parameter(
            [num_embeddings, embedding_dim], attr=weight_attr,
            default_initializer=I.Normal(0.0, 1.0) if weight_attr is None
            else None)
        if padding_idx is not None:
            with torch.no_grad():
                self.weight[padding_idx] = 0.0

    def forward(self, ids):
        return F.embedding(ids, self.weight, padding_idx=self._padding_idx,
                           sparse=self._sparse)


class Dropout(Layer):
    """``F.dropout`` with the layer's ``training`` flag (``:71``)."""

    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None):
        super().__init__()
        self.p, self.axis, self.mode = p, axis, mode

    def forward(self, x):
        return F.dropout(x, p=self.p, axis=self.axis, training=self.training,
                         mode=self.mode)


class Dropout2D(Layer):
    def __init__(self, p=0.5, data_format="NCHW", name=None):
        super().__init__()
        self.p, self.data_format = p, data_format

    def forward(self, x):
        return F.dropout2d(x, p=self.p, training=self.training,
                           data_format=self.data_format)


class Dropout3D(Layer):
    def __init__(self, p=0.5, data_format="NCDHW", name=None):
        super().__init__()
        self.p, self.data_format = p, data_format

    def forward(self, x):
        return F.dropout3d(x, p=self.p, training=self.training,
                           data_format=self.data_format)


class AlphaDropout(Layer):
    def __init__(self, p=0.5, name=None):
        super().__init__()
        self.p = p

    def forward(self, x):
        return F.alpha_dropout(x, p=self.p, training=self.training)


class Sequential(Layer):
    """Sublayers run in order, named ``"0"``, ``"1"``, ... or by the
    names of an ``OrderedDict`` / ``(name, layer)`` pairs."""

    def __init__(self, *layers):
        super().__init__()
        if len(layers) == 1 and isinstance(layers[0],
                                           collections.OrderedDict):
            for name, layer in layers[0].items():
                self.add_sublayer(name, layer)
        else:
            for i, layer in enumerate(layers):
                if isinstance(layer, tuple):
                    self.add_sublayer(layer[0], layer[1])
                else:
                    self.add_sublayer(str(i), layer)

    def forward(self, x):
        for layer in self._modules.values():
            x = layer(x)
        return x

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return Sequential(*list(self._modules.values())[idx])
        keys = list(self._modules.keys())
        return self._modules[keys[idx]]

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules.values())


class LayerList(Layer):
    """A list of sublayers named ``"0"``, ``"1"``, ... in the state dict,
    as in the JAX package (``:141``)."""

    def __init__(self, sublayers=None):
        super().__init__()
        if sublayers is not None:
            for i, layer in enumerate(sublayers):
                self.add_sublayer(str(i), layer)

    def append(self, sublayer):
        self.add_sublayer(str(len(self._modules)), sublayer)
        return self

    def insert(self, index, sublayer):
        layers = list(self._modules.values())
        layers.insert(index, sublayer)
        self._modules.clear()
        for i, layer in enumerate(layers):
            self.add_sublayer(str(i), layer)

    def extend(self, sublayers):
        for layer in sublayers:
            self.append(layer)
        return self

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return LayerList(list(self._modules.values())[idx])
        return list(self._modules.values())[idx]

    def __setitem__(self, idx, layer):
        self.add_sublayer(str(idx), layer)

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules.values())


class LayerDict(Layer):
    """Sublayers by name (``:184-219``)."""

    def __init__(self, sublayers=None):
        super().__init__()
        if sublayers:
            self.update(sublayers)

    def update(self, sublayers):
        items = sublayers.items() if isinstance(sublayers, dict) \
            else sublayers
        for name, layer in items:
            self.add_sublayer(name, layer)

    def __getitem__(self, key):
        return self._modules[key]

    def __setitem__(self, key, layer):
        self.add_sublayer(key, layer)

    def __delitem__(self, key):
        del self._modules[key]

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules)

    def keys(self):
        return self._modules.keys()

    def values(self):
        return self._modules.values()

    def items(self):
        return self._modules.items()


class ParameterList(Layer):
    """Parameters named ``"0"``, ``"1"``, ... (``:222-238``)."""

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


class Flatten(Layer):
    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis, self.stop_axis = start_axis, stop_axis

    def forward(self, x):
        return torch.flatten(x, self.start_axis, self.stop_axis)


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
        self.size, self.scale_factor = size, scale_factor
        self.mode, self.align_corners = mode, align_corners
        self.data_format = data_format

    def forward(self, x):
        return F.interpolate(x, size=self.size, scale_factor=self.scale_factor,
                             mode=self.mode, align_corners=self.align_corners,
                             data_format=self.data_format)


class UpsamplingBilinear2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "bilinear", True,
                         data_format=data_format)


class UpsamplingNearest2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "nearest", False,
                         data_format=data_format)


class _PadN(Layer):
    def __init__(self, padding, mode="constant", value=0.0, data_format=None):
        super().__init__()
        self.padding, self.mode, self.value = padding, mode, value
        self.data_format = data_format

    def forward(self, x):
        return F.pad(x, self.padding, mode=self.mode, value=self.value)


class Pad1D(_PadN):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCL", name=None):
        super().__init__(padding, mode, value, data_format)


class Pad2D(_PadN):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCHW", name=None):
        super().__init__(padding, mode, value, data_format)


class Pad3D(_PadN):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCDHW", name=None):
        super().__init__(padding, mode, value, data_format)


class ZeroPad2D(Pad2D):
    def __init__(self, padding, data_format="NCHW", name=None):
        super().__init__(padding, "constant", 0.0, data_format)


class PixelShuffle(Layer):
    def __init__(self, upscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.factor, self.data_format = upscale_factor, data_format

    def forward(self, x):
        return F.pixel_shuffle(x, self.factor, self.data_format)


class PixelUnshuffle(Layer):
    def __init__(self, downscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.factor, self.data_format = downscale_factor, data_format

    def forward(self, x):
        return F.pixel_unshuffle(x, self.factor, self.data_format)


class ChannelShuffle(Layer):
    def __init__(self, groups, data_format="NCHW", name=None):
        super().__init__()
        self.groups, self.data_format = groups, data_format

    def forward(self, x):
        return F.channel_shuffle(x, self.groups, self.data_format)


class Unfold(Layer):
    def __init__(self, kernel_sizes, strides=1, paddings=0, dilations=1,
                 name=None):
        super().__init__()
        self.args = (kernel_sizes, strides, paddings, dilations)

    def forward(self, x):
        return F.unfold(x, *self.args)


class Fold(Layer):
    def __init__(self, output_sizes, kernel_sizes, strides=1, paddings=0,
                 dilations=1, name=None):
        super().__init__()
        self.output_sizes = output_sizes
        self.args = (kernel_sizes, strides, paddings, dilations)

    def forward(self, x):
        return F.fold(x, self.output_sizes, *self.args)


class CosineSimilarity(Layer):
    def __init__(self, axis=1, eps=1e-8):
        super().__init__()
        self.axis, self.eps = axis, eps

    def forward(self, x1, x2):
        return F.cosine_similarity(x1, x2, axis=self.axis, eps=self.eps)


class Bilinear(Layer):
    """``x1 W x2 + b`` with weight ``[out, in1, in2]``."""

    def __init__(self, in1_features, in2_features, out_features,
                 weight_attr=None, bias_attr=None, name=None,
                 dtype="float32", device=None):
        super().__init__(dtype=dtype, device=device)
        self.weight = self.create_parameter(
            [out_features, in1_features, in2_features], attr=weight_attr)
        self.bias = None if bias_attr is False else self.create_parameter(
            [out_features], attr=bias_attr, is_bias=True)

    def forward(self, x1, x2):
        return F.bilinear(x1, x2, self.weight, self.bias)


# ---- activation layers -----------------------------------------------------

def _act_layer(name, fn):
    """A layer calling `fn` with the constructor's arguments (``name``
    dropped), as the JAX package's ``_act_layer`` (``:388-399``)."""
    def __init__(self, *args, **kwargs):
        Layer.__init__(self)
        self._args = args
        self._kwargs = {k: v for k, v in kwargs.items() if k != "name"}

    def forward(self, x):
        return fn(x, *self._args, **self._kwargs)

    return type(name, (Layer,), {"__init__": __init__, "forward": forward,
                                 "__module__": __name__})


ReLU = _act_layer("ReLU", F.relu)
ReLU6 = _act_layer("ReLU6", F.relu6)
GELU = _act_layer("GELU", F.gelu)
SiLU = _act_layer("SiLU", F.silu)
Swish = _act_layer("Swish", F.swish)
Mish = _act_layer("Mish", F.mish)
Sigmoid = _act_layer("Sigmoid", F.sigmoid)
Tanh = _act_layer("Tanh", F.tanh)
LeakyReLU = _act_layer("LeakyReLU", F.leaky_relu)
ELU = _act_layer("ELU", F.elu)
CELU = _act_layer("CELU", F.celu)
SELU = _act_layer("SELU", F.selu)
Hardswish = _act_layer("Hardswish", F.hardswish)
Hardsigmoid = _act_layer("Hardsigmoid", F.hardsigmoid)
Hardtanh = _act_layer("Hardtanh", F.hardtanh)
Hardshrink = _act_layer("Hardshrink", F.hardshrink)
Softshrink = _act_layer("Softshrink", F.softshrink)
Tanhshrink = _act_layer("Tanhshrink", F.tanhshrink)
ThresholdedReLU = _act_layer("ThresholdedReLU", F.thresholded_relu)
Softplus = _act_layer("Softplus", F.softplus)
Softsign = _act_layer("Softsign", F.softsign)
LogSigmoid = _act_layer("LogSigmoid", F.log_sigmoid)
Softmax = _act_layer("Softmax", F.softmax)
LogSoftmax = _act_layer("LogSoftmax", F.log_softmax)
Maxout = _act_layer("Maxout", F.maxout)
GLU = _act_layer("GLU", F.glu)
RReLU = _act_layer("RReLU", F.rrelu)


class PReLU(Layer):
    """``F.prelu`` with a learned slope (``num_parameters`` of them,
    initialised to ``init``)."""

    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format="NCHW", name=None, dtype="float32", device=None):
        super().__init__(dtype=dtype, device=device)
        self.data_format = data_format
        self.weight = self.create_parameter(
            [num_parameters], attr=weight_attr,
            default_initializer=I.Constant(init))

    def forward(self, x):
        return F.prelu(x, self.weight, data_format=self.data_format)
