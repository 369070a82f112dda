"""RMSNorm (``paddle_tpu/nn/norm_layers.py``)."""

from __future__ import annotations

from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn import initializer as I
from paddle_tpu_torch.nn.layer import Layer

__all__ = ["RMSNorm"]


class RMSNorm(Layer):
    def __init__(self, hidden_size, epsilon=1e-6, dtype="float32",
                 device=None):
        super().__init__(dtype=dtype, device=device)
        self._epsilon = epsilon
        self.weight = self.create_parameter(
            [hidden_size], default_initializer=I.Constant(1.0))

    def forward(self, x):
        return F.rms_norm(x, self.weight, self._epsilon)
