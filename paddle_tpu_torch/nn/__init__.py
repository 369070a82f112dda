"""Layers of the port (``paddle_tpu.nn``) and gradient clipping."""

from paddle_tpu_torch.nn import functional
from paddle_tpu_torch.nn.clip import (ClipGradByGlobalNorm, ClipGradByNorm,
                                      ClipGradByValue)
from paddle_tpu_torch.nn.common_layers import (Dropout, Embedding, LayerList,
                                               Linear)
from paddle_tpu_torch.nn.layer import Layer
from paddle_tpu_torch.nn.loss_layers import CrossEntropyLoss
from paddle_tpu_torch.nn.norm_layers import LayerNorm, RMSNorm
from paddle_tpu_torch.nn.transformer import (MultiHeadAttention, Transformer,
                                             TransformerDecoder,
                                             TransformerDecoderLayer,
                                             TransformerEncoder,
                                             TransformerEncoderLayer)

__all__ = ["Layer", "Linear", "Embedding", "Dropout", "LayerList",
           "LayerNorm", "RMSNorm", "CrossEntropyLoss", "MultiHeadAttention",
           "TransformerEncoderLayer", "TransformerEncoder",
           "TransformerDecoderLayer", "TransformerDecoder", "Transformer",
           "ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue",
           "functional"]
