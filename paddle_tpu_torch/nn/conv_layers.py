"""Conv layers (``paddle_tpu/nn/conv_layers.py``): ``Conv1D/2D/3D`` and
``Conv1D/2D/3DTranspose`` with the JAX package's weight layout
(``[out_c, in_c / groups, *k]``; ``[in_c, out_c / groups, *k]`` for the
transposes) and names (``weight``, ``bias``), so a state dict crosses
as numpy.  The default initializers are the JAX package's: Kaiming-
uniform with ``negative_slope = sqrt(5)`` over ``fan_in = in_c * prod(k)
/ groups`` for the weight, ``U(-1/sqrt(fan_in), 1/sqrt(fan_in))`` for
the bias.  ``padding_mode`` is taken and, as there, only zeros pad."""

from __future__ import annotations

import math

from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn import initializer as I
from paddle_tpu_torch.nn.layer import Layer

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose", "Conv2DTranspose",
           "Conv3DTranspose"]


def _ntuple(v, n):
    return (v,) * n if isinstance(v, int) else tuple(v)


class _ConvNd(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, n, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 transpose=False, output_padding=0, dtype="float32",
                 device=None):
        super().__init__(dtype=dtype, device=device)
        self._n = n
        self._stride = stride
        self._padding = padding
        self._dilation = dilation
        self._groups = groups
        self._data_format = data_format
        self._transpose = transpose
        self._output_padding = output_padding
        k = _ntuple(kernel_size, n)
        if transpose:
            wshape = [in_channels, out_channels // groups, *k]
        else:
            wshape = [out_channels, in_channels // groups, *k]
        fan_in = in_channels * math.prod(k) // groups
        self.weight = self.create_parameter(
            wshape, attr=weight_attr,
            default_initializer=I.KaimingUniform(
                fan_in=fan_in, negative_slope=math.sqrt(5.0),
                nonlinearity="leaky_relu") if weight_attr is None else None)
        if bias_attr is False:
            self.bias = None
        else:
            bound = 1.0 / math.sqrt(fan_in)
            self.bias = self.create_parameter(
                [out_channels], attr=bias_attr, is_bias=True,
                default_initializer=I.Uniform(-bound, bound)
                if bias_attr is None else None)

    def forward(self, x, output_size=None):
        if self._transpose:
            fn = (F.conv1d_transpose, F.conv2d_transpose,
                  F.conv3d_transpose)[self._n - 1]
            return fn(x, self.weight, self.bias, stride=self._stride,
                      padding=self._padding,
                      output_padding=self._output_padding,
                      groups=self._groups, dilation=self._dilation,
                      output_size=output_size, data_format=self._data_format)
        fn = (F.conv1d, F.conv2d, F.conv3d)[self._n - 1]
        return fn(x, self.weight, self.bias, stride=self._stride,
                  padding=self._padding, dilation=self._dilation,
                  groups=self._groups, data_format=self._data_format)


class Conv1D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCL",
                 dtype="float32", device=None):
        super().__init__(in_channels, out_channels, kernel_size, 1, stride,
                         padding, dilation, groups, padding_mode, weight_attr,
                         bias_attr, data_format, dtype=dtype, device=device)


class Conv2D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 dtype="float32", device=None):
        super().__init__(in_channels, out_channels, kernel_size, 2, stride,
                         padding, dilation, groups, padding_mode, weight_attr,
                         bias_attr, data_format, dtype=dtype, device=device)


class Conv3D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 dtype="float32", device=None):
        super().__init__(in_channels, out_channels, kernel_size, 3, stride,
                         padding, dilation, groups, padding_mode, weight_attr,
                         bias_attr, data_format, dtype=dtype, device=device)


class Conv1DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCL",
                 dtype="float32", device=None):
        super().__init__(in_channels, out_channels, kernel_size, 1, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, transpose=True,
                         output_padding=output_padding, dtype=dtype,
                         device=device)


class Conv2DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 dtype="float32", device=None):
        super().__init__(in_channels, out_channels, kernel_size, 2, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, transpose=True,
                         output_padding=output_padding, dtype=dtype,
                         device=device)


class Conv3DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 dtype="float32", device=None):
        super().__init__(in_channels, out_channels, kernel_size, 3, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, transpose=True,
                         output_padding=output_padding, dtype=dtype,
                         device=device)
