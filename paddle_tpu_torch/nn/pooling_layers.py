"""Pooling layers (``paddle_tpu/nn/pooling_layers.py``) over the
functionals of ``functional/pooling.py``.  Unlike the JAX package's,
they pass ``return_mask``, ``exclusive`` and ``divisor_override`` on
(the JAX layers drop them)."""

from __future__ import annotations

from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.layer import Layer

__all__ = ["MaxPool1D", "MaxPool2D", "MaxPool3D", "AvgPool1D", "AvgPool2D",
           "AvgPool3D", "AdaptiveAvgPool1D", "AdaptiveAvgPool2D",
           "AdaptiveAvgPool3D", "AdaptiveMaxPool1D", "AdaptiveMaxPool2D",
           "AdaptiveMaxPool3D"]


class _Pool(Layer):
    _fn = None
    _max = True

    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 return_mask=False, data_format=None, name=None,
                 exclusive=True, divisor_override=None):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.ceil_mode = ceil_mode
        self.return_mask = return_mask
        self.exclusive = exclusive
        self.divisor_override = divisor_override
        self.data_format = data_format

    def forward(self, x):
        kw = {}
        if self.data_format is not None:
            kw["data_format"] = self.data_format
        if self._max:
            kw["return_mask"] = self.return_mask
        else:
            kw["exclusive"] = self.exclusive
            if self.divisor_override is not None:
                kw["divisor_override"] = self.divisor_override
        return type(self)._fn(x, self.kernel_size, stride=self.stride,
                              padding=self.padding, ceil_mode=self.ceil_mode,
                              **kw)


class MaxPool1D(_Pool):
    _fn = staticmethod(F.max_pool1d)


class MaxPool2D(_Pool):
    _fn = staticmethod(F.max_pool2d)


class MaxPool3D(_Pool):
    _fn = staticmethod(F.max_pool3d)


class AvgPool1D(_Pool):
    _fn = staticmethod(F.avg_pool1d)
    _max = False


class AvgPool2D(_Pool):
    _fn = staticmethod(F.avg_pool2d)
    _max = False


class AvgPool3D(_Pool):
    _fn = staticmethod(F.avg_pool3d)
    _max = False


class _AdaptivePool(Layer):
    _fn = None
    _max = False

    def __init__(self, output_size, data_format=None, return_mask=False,
                 name=None):
        super().__init__()
        self.output_size = output_size
        self.data_format = data_format
        self.return_mask = return_mask

    def forward(self, x):
        if self._max:
            return type(self)._fn(x, self.output_size,
                                  return_mask=self.return_mask)
        if self.data_format is not None and \
                type(self) is not AdaptiveAvgPool1D:
            return type(self)._fn(x, self.output_size,
                                  data_format=self.data_format)
        return type(self)._fn(x, self.output_size)


class AdaptiveAvgPool1D(_AdaptivePool):
    _fn = staticmethod(F.adaptive_avg_pool1d)


class AdaptiveAvgPool2D(_AdaptivePool):
    _fn = staticmethod(F.adaptive_avg_pool2d)


class AdaptiveAvgPool3D(_AdaptivePool):
    _fn = staticmethod(F.adaptive_avg_pool3d)


class AdaptiveMaxPool1D(_AdaptivePool):
    _fn = staticmethod(F.adaptive_max_pool1d)
    _max = True


class AdaptiveMaxPool2D(_AdaptivePool):
    _fn = staticmethod(F.adaptive_max_pool2d)
    _max = True


class AdaptiveMaxPool3D(_AdaptivePool):
    _fn = staticmethod(F.adaptive_max_pool3d)
    _max = True
