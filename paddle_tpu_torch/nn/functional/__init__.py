"""Functional API of the port (``paddle_tpu.nn.functional``)."""

from paddle_tpu_torch.nn.functional import activation as _activation
from paddle_tpu_torch.nn.functional import conv as _conv
from paddle_tpu_torch.nn.functional import pooling as _pooling
from paddle_tpu_torch.nn.functional.activation import *  # noqa: F401,F403
from paddle_tpu_torch.nn.functional.attention import (
    apply_rotary_emb, flash_attention, flash_attn_unpadded, rotary_freqs,
    scaled_dot_product_attention)
from paddle_tpu_torch.nn.functional import common as _common
from paddle_tpu_torch.nn.functional.common import *  # noqa: F401,F403
from paddle_tpu_torch.nn.functional.conv import *  # noqa: F401,F403
from paddle_tpu_torch.nn.functional.fused import (fused_decoder_block,
                                                  fused_ffn, fused_mlp,
                                                  fused_rmsnorm_qkv)
from paddle_tpu_torch.nn.functional import loss as _loss
from paddle_tpu_torch.nn.functional.loss import *  # noqa: F401,F403
from paddle_tpu_torch.nn.functional.norm import (
    batch_norm, batch_norm_stats, group_norm, instance_norm, layer_norm,
    local_response_norm, rms_norm, rms_norm_residual)
from paddle_tpu_torch.nn.functional.pooling import *  # noqa: F401,F403

__all__ = list(_activation.__all__) + list(_common.__all__) + [
    "layer_norm",
    "rms_norm", "rms_norm_residual", "batch_norm", "batch_norm_stats",
    "instance_norm", "group_norm", "local_response_norm", "rotary_freqs",
    "apply_rotary_emb", "scaled_dot_product_attention", "flash_attention",
    "flash_attn_unpadded", "fused_rmsnorm_qkv", "fused_mlp", "fused_ffn",
    "fused_decoder_block"] + list(_conv.__all__) + \
    list(_pooling.__all__) + list(_loss.__all__)
