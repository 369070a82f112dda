"""Hand-written CUDA kernels for Hopper (``sm_90a``) — the port's
counterpart of ``paddle_tpu/ops/pallas``.  Sources are in ``csrc/``;
``_build.py`` compiles them at first use.

``quant_matmul`` here names the module; its wrapper is
``quant_matmul.quant_matmul``."""

from paddle_tpu_torch.ops.kernels.cross_entropy import (cross_entropy_bwd,
                                                        cross_entropy_fwd)
from paddle_tpu_torch.ops.kernels.flash_attention import (
    flash_attention_bwd_dkv, flash_attention_bwd_dq, flash_attention_fwd)
from paddle_tpu_torch.ops.kernels.fused_block import (fused_ffn, fused_mlp,
                                                      fused_rmsnorm_qkv)
from paddle_tpu_torch.ops.kernels.grouped_matmul import grouped_expert_ffn
from paddle_tpu_torch.ops.kernels.paged_attention import (
    paged_decode_attention, paged_decode_attention_int8)
from paddle_tpu_torch.ops.kernels import quant_matmul as _qm

# the kernel wrappers, each with a `launches` count, and the ones each
# path runs: serving (paged decode), quantized serving (quant matmul in
# every projection, int8 paged decode over int8 pools) and a training
# step (flash fwd/bwd), an MoE training step (the grouped expert FFN;
# its attention is unfused, so no QKV kernel), a GPT training step (the
# fused cross-entropy pair; flash through the head_dim-64 pad) and
# nn.Transformer inference (the act + bias feed-forward)
KERNELS = (fused_rmsnorm_qkv, fused_mlp, paged_decode_attention,
           paged_decode_attention_int8, _qm.quant_matmul,
           flash_attention_fwd, flash_attention_bwd_dq,
           flash_attention_bwd_dkv, grouped_expert_ffn, cross_entropy_fwd,
           cross_entropy_bwd, fused_ffn)
SERVING = (fused_rmsnorm_qkv, fused_mlp, paged_decode_attention)
SERVING_QUANT = (_qm.quant_matmul, paged_decode_attention_int8)
TRAINING = (fused_rmsnorm_qkv, fused_mlp, flash_attention_fwd,
            flash_attention_bwd_dq, flash_attention_bwd_dkv)
TRAINING_MOE = (fused_mlp, flash_attention_fwd, flash_attention_bwd_dq,
                flash_attention_bwd_dkv, grouped_expert_ffn)
TRAINING_GPT = (cross_entropy_fwd, cross_entropy_bwd, flash_attention_fwd,
                flash_attention_bwd_dq, flash_attention_bwd_dkv)
TRANSFORMER = (fused_ffn,)


def reset_launch_counts():
    """Set every wrapper's launch count (and per-mode count) to 0."""
    for fn in KERNELS:
        fn.launches = 0
    _qm.quant_matmul.launches_by_mode = dict.fromkeys(
        _qm.QUANT_WEIGHT_DTYPES, 0)


__all__ = ["fused_rmsnorm_qkv", "fused_mlp", "paged_decode_attention",
           "paged_decode_attention_int8", "flash_attention_fwd",
           "flash_attention_bwd_dq", "flash_attention_bwd_dkv",
           "grouped_expert_ffn", "cross_entropy_fwd", "cross_entropy_bwd",
           "fused_ffn", "KERNELS", "SERVING", "SERVING_QUANT", "TRAINING",
           "TRAINING_MOE", "TRAINING_GPT", "TRANSFORMER",
           "reset_launch_counts"]
