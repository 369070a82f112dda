"""LayerNorm and RMSNorm (``paddle_tpu/nn/norm_layers.py``)."""

from __future__ import annotations

from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn import initializer as I
from paddle_tpu_torch.nn.layer import Layer

__all__ = ["LayerNorm", "RMSNorm"]


class LayerNorm(Layer):
    """``F.layer_norm`` over the trailing ``normalized_shape`` axes with
    a weight of ones and a bias of zeros (``:24-46``); ``weight_attr`` /
    ``bias_attr`` False drop them, any other attr is read by
    ``create_parameter``."""

    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None, dtype="float32", device=None):
        super().__init__(dtype=dtype, device=device)
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        self.weight = None if weight_attr is False else \
            self.create_parameter(self._normalized_shape, attr=weight_attr,
                                  default_initializer=I.Constant(1.0))
        self.bias = None if bias_attr is False else \
            self.create_parameter(self._normalized_shape, attr=bias_attr,
                                  is_bias=True)

    def forward(self, x):
        return F.layer_norm(x, self._normalized_shape, self.weight,
                            self.bias, self._epsilon)


class RMSNorm(Layer):
    def __init__(self, hidden_size, epsilon=1e-6, weight_attr=None,
                 name=None, dtype="float32", device=None):
        super().__init__(dtype=dtype, device=device)
        self._epsilon = epsilon
        self.weight = self.create_parameter(
            [hidden_size], attr=weight_attr,
            default_initializer=I.Constant(1.0))

    def forward(self, x):
        return F.rms_norm(x, self.weight, self._epsilon)
