"""Layers of the port (``paddle_tpu.nn``) and gradient clipping."""

from paddle_tpu_torch.nn import functional
from paddle_tpu_torch.nn.clip import (ClipGradByGlobalNorm, ClipGradByNorm,
                                      ClipGradByValue)
from paddle_tpu_torch.nn import common_layers as _common
from paddle_tpu_torch.nn import conv_layers as _conv
from paddle_tpu_torch.nn import norm_layers as _norm
from paddle_tpu_torch.nn import pooling_layers as _pool
from paddle_tpu_torch.nn import rnn as _rnn
from paddle_tpu_torch.nn.common_layers import *  # noqa: F401,F403
from paddle_tpu_torch.nn.conv_layers import *  # noqa: F401,F403
from paddle_tpu_torch.nn.layer import Layer
from paddle_tpu_torch.nn import loss_layers as _loss
from paddle_tpu_torch.nn.loss_layers import *  # noqa: F401,F403
from paddle_tpu_torch.nn.norm_layers import *  # noqa: F401,F403
from paddle_tpu_torch.nn.pooling_layers import *  # noqa: F401,F403
from paddle_tpu_torch.nn.rnn import *  # noqa: F401,F403
from paddle_tpu_torch.nn.transformer import (MultiHeadAttention, Transformer,
                                             TransformerDecoder,
                                             TransformerDecoderLayer,
                                             TransformerEncoder,
                                             TransformerEncoderLayer)

__all__ = list(_common.__all__) + list(_conv.__all__) + \
    list(_norm.__all__) + list(_pool.__all__) + list(_rnn.__all__) + \
    list(_loss.__all__) + [
        "Layer", "MultiHeadAttention",
        "TransformerEncoderLayer", "TransformerEncoder",
        "TransformerDecoderLayer", "TransformerDecoder", "Transformer",
        "ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue",
        "functional"]
