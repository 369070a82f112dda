"""Functional API of the port (``paddle_tpu.nn.functional``)."""

from paddle_tpu_torch.nn.functional import activation as _activation
from paddle_tpu_torch.nn.functional.activation import *  # noqa: F401,F403
from paddle_tpu_torch.nn.functional.attention import (
    apply_rotary_emb, rotary_freqs, scaled_dot_product_attention)
from paddle_tpu_torch.nn.functional.common import (
    alpha_dropout, bilinear, cosine_similarity, dropout, dropout2d,
    dropout3d, embedding, linear)
from paddle_tpu_torch.nn.functional.fused import (fused_decoder_block,
                                                  fused_ffn, fused_mlp,
                                                  fused_rmsnorm_qkv)
from paddle_tpu_torch.nn.functional.loss import (cross_entropy,
                                                 fused_linear_cross_entropy)
from paddle_tpu_torch.nn.functional.norm import (layer_norm, rms_norm,
                                                 rms_norm_residual)

__all__ = list(_activation.__all__) + [
    "linear", "embedding", "dropout", "dropout2d", "dropout3d",
    "alpha_dropout", "cosine_similarity", "bilinear", "layer_norm",
    "rms_norm", "rms_norm_residual", "rotary_freqs", "apply_rotary_emb",
    "scaled_dot_product_attention", "fused_rmsnorm_qkv", "fused_mlp",
    "fused_ffn", "fused_decoder_block", "cross_entropy",
    "fused_linear_cross_entropy"]
