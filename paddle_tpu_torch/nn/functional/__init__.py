"""Functional API of the port (``paddle_tpu.nn.functional``)."""

from paddle_tpu_torch.nn.functional.activation import gelu, relu, silu
from paddle_tpu_torch.nn.functional.attention import (
    apply_rotary_emb, rotary_freqs, scaled_dot_product_attention)
from paddle_tpu_torch.nn.functional.common import dropout
from paddle_tpu_torch.nn.functional.fused import (fused_decoder_block,
                                                  fused_ffn, fused_mlp,
                                                  fused_rmsnorm_qkv)
from paddle_tpu_torch.nn.functional.loss import (cross_entropy,
                                                 fused_linear_cross_entropy)
from paddle_tpu_torch.nn.functional.norm import (layer_norm, rms_norm,
                                                 rms_norm_residual)

__all__ = ["relu", "silu", "gelu", "dropout", "layer_norm", "rms_norm",
           "rms_norm_residual", "rotary_freqs", "apply_rotary_emb",
           "scaled_dot_product_attention", "fused_rmsnorm_qkv", "fused_mlp",
           "fused_ffn", "fused_decoder_block", "cross_entropy",
           "fused_linear_cross_entropy"]
