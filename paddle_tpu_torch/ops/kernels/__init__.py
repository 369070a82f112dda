"""Hand-written CUDA kernels for Hopper (``sm_90a``) — the port's
counterpart of ``paddle_tpu/ops/pallas``.  Sources are in ``csrc/``;
``_build.py`` compiles them at first use.

``quant_matmul`` here names the module; its wrapper is
``quant_matmul.quant_matmul``."""

from paddle_tpu_torch.ops.kernels.cross_entropy import (cross_entropy_bwd,
                                                        cross_entropy_fwd)
from paddle_tpu_torch.ops.kernels.flash_attention import (
    flash_attention_bwd_dkv, flash_attention_bwd_dq, flash_attention_fwd)
from paddle_tpu_torch.ops.kernels.fused_block import (GEMM_PATHS,
                                                      fused_decoder_block,
                                                      fused_ffn, fused_mlp,
                                                      fused_rmsnorm_qkv)
from paddle_tpu_torch.ops.kernels.grouped_matmul import grouped_expert_ffn
from paddle_tpu_torch.ops.kernels.multi_tensor import (multi_tensor_adam,
                                                       multi_tensor_digest,
                                                       multi_tensor_norm)
from paddle_tpu_torch.ops.kernels.paged_attention import (
    PAGED_PATHS, paged_decode_attention, paged_decode_attention_int8)
from paddle_tpu_torch.ops.kernels import quant_matmul as _qm
from paddle_tpu_torch.ops.kernels.rmsnorm import fused_rmsnorm

# the kernel wrappers, each with a `launches` count, and the ones each
# path runs: serving (paged decode), quantized serving (quant matmul in
# every projection, int8 paged decode over int8 pools) and a training
# step (flash fwd/bwd), an MoE training step (the grouped expert FFN;
# its attention is unfused, so no QKV kernel), a GPT training step (the
# fused cross-entropy pair; flash through the head_dim-64 pad),
# nn.Transformer inference (the act + bias feed-forward), the Llama
# decoder tier (PADDLE_TPU_FUSED_BLOCK=decoder): a training step runs the
# block kernel in its forward and, in the backward's recompute, the QKV
# training variant, flash, the rmsnorm kernel (norm2) and the MLP; a
# cache-free scoring forward runs the block kernel alone; and
# F.rms_norm_residual (the residual rmsnorm); and every training step's
# optimizer with Adam or AdamW: the two multi-tensor kernels (the gradient
# norm and the update), once a step each; the SDC sentinel's parameter
# digest (robustness/recovery.py), once a check
KERNELS = (fused_rmsnorm_qkv, fused_mlp, paged_decode_attention,
           paged_decode_attention_int8, _qm.quant_matmul,
           flash_attention_fwd, flash_attention_bwd_dq,
           flash_attention_bwd_dkv, grouped_expert_ffn, cross_entropy_fwd,
           cross_entropy_bwd, fused_ffn, fused_rmsnorm, fused_decoder_block,
           multi_tensor_norm, multi_tensor_adam, multi_tensor_digest)
SERVING = (fused_rmsnorm_qkv, fused_mlp, paged_decode_attention)
SERVING_QUANT = (_qm.quant_matmul, paged_decode_attention_int8)
MULTI_TENSOR = (multi_tensor_norm, multi_tensor_adam)
TRAINING = (fused_rmsnorm_qkv, fused_mlp, flash_attention_fwd,
            flash_attention_bwd_dq, flash_attention_bwd_dkv)
TRAINING_MOE = (fused_mlp, flash_attention_fwd, flash_attention_bwd_dq,
                flash_attention_bwd_dkv, grouped_expert_ffn)
TRAINING_GPT = (cross_entropy_fwd, cross_entropy_bwd, flash_attention_fwd,
                flash_attention_bwd_dq, flash_attention_bwd_dkv)
TRANSFORMER = (fused_ffn,)
DECODER_TRAINING = (fused_decoder_block, fused_rmsnorm, fused_rmsnorm_qkv,
                    fused_mlp, flash_attention_fwd, flash_attention_bwd_dq,
                    flash_attention_bwd_dkv)
DECODER_SCORING = (fused_decoder_block,)
NORM = (fused_rmsnorm,)
# the wrappers that also count their launches by io dtype
# (`launches_by_dtype`): AMP's O1 sends QKV and the MLP fp32, O2 bf16
BY_DTYPE = (fused_rmsnorm_qkv, fused_mlp, fused_ffn, flash_attention_fwd,
            flash_attention_bwd_dq, flash_attention_bwd_dkv)


def reset_launch_counts():
    """Set every wrapper's launch count (and its per-mode and per-path
    counts) and the decoder tier's route counts to 0."""
    for fn in KERNELS:
        fn.launches = 0
    _qm.quant_matmul.launches_by_mode = dict.fromkeys(
        _qm.QUANT_WEIGHT_DTYPES, 0)
    _qm.quant_matmul.launches_by_path = dict.fromkeys(_qm.QUANT_PATHS, 0)
    for fn in (fused_rmsnorm_qkv, fused_mlp, fused_ffn, fused_decoder_block,
               grouped_expert_ffn):
        fn.launches_by_path = dict.fromkeys(GEMM_PATHS, 0)
    for fn in (paged_decode_attention, paged_decode_attention_int8):
        fn.launches_by_path = dict.fromkeys(PAGED_PATHS, 0)
    fused_decoder_block.routes = dict.fromkeys(("decoder", "segments"), 0)
    for fn in BY_DTYPE:
        fn.launches_by_dtype = {}


__all__ = ["fused_rmsnorm_qkv", "fused_mlp", "paged_decode_attention",
           "paged_decode_attention_int8", "flash_attention_fwd",
           "flash_attention_bwd_dq", "flash_attention_bwd_dkv",
           "grouped_expert_ffn", "cross_entropy_fwd", "cross_entropy_bwd",
           "fused_ffn", "fused_rmsnorm", "fused_decoder_block",
           "multi_tensor_norm", "multi_tensor_adam", "multi_tensor_digest",
           "KERNELS", "SERVING", "SERVING_QUANT", "MULTI_TENSOR",
           "TRAINING", "TRAINING_MOE",
           "TRAINING_GPT", "TRANSFORMER", "DECODER_TRAINING",
           "DECODER_SCORING", "NORM", "BY_DTYPE", "reset_launch_counts"]
