"""Layers of the port (``paddle_tpu.nn``) and gradient clipping."""

from paddle_tpu_torch.nn import functional
from paddle_tpu_torch.nn.clip import (ClipGradByGlobalNorm, ClipGradByNorm,
                                      ClipGradByValue)
from paddle_tpu_torch.nn import common_layers as _common
from paddle_tpu_torch.nn.common_layers import *  # noqa: F401,F403
from paddle_tpu_torch.nn.layer import Layer
from paddle_tpu_torch.nn.loss_layers import CrossEntropyLoss
from paddle_tpu_torch.nn.norm_layers import LayerNorm, RMSNorm
from paddle_tpu_torch.nn.transformer import (MultiHeadAttention, Transformer,
                                             TransformerDecoder,
                                             TransformerDecoderLayer,
                                             TransformerEncoder,
                                             TransformerEncoderLayer)

__all__ = list(_common.__all__) + [
    "Layer", "LayerNorm", "RMSNorm", "CrossEntropyLoss",
    "MultiHeadAttention", "TransformerEncoderLayer", "TransformerEncoder",
    "TransformerDecoderLayer", "TransformerDecoder", "Transformer",
    "ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue",
    "functional"]
