"""Layers of the port (``paddle_tpu.nn``)."""

from paddle_tpu_torch.nn import functional
from paddle_tpu_torch.nn.common_layers import Embedding, Linear
from paddle_tpu_torch.nn.layer import Layer
from paddle_tpu_torch.nn.norm_layers import RMSNorm

__all__ = ["Layer", "Linear", "Embedding", "RMSNorm", "functional"]
