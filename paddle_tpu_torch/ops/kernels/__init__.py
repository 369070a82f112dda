"""Hand-written CUDA kernels for Hopper (``sm_90a``) — the port's
counterpart of ``paddle_tpu/ops/pallas``.  Sources are in ``csrc/``;
``_build.py`` compiles them at first use."""

from paddle_tpu_torch.ops.kernels.flash_attention import (
    flash_attention_bwd_dkv, flash_attention_bwd_dq, flash_attention_fwd)
from paddle_tpu_torch.ops.kernels.fused_block import (fused_mlp,
                                                      fused_rmsnorm_qkv)
from paddle_tpu_torch.ops.kernels.paged_attention import \
    paged_decode_attention

# the kernel wrappers, each with a `launches` count, and the ones each
# path runs: serving (paged decode) and a training step (flash fwd/bwd)
KERNELS = (fused_rmsnorm_qkv, fused_mlp, paged_decode_attention,
           flash_attention_fwd, flash_attention_bwd_dq,
           flash_attention_bwd_dkv)
SERVING = (fused_rmsnorm_qkv, fused_mlp, paged_decode_attention)
TRAINING = (fused_rmsnorm_qkv, fused_mlp, flash_attention_fwd,
            flash_attention_bwd_dq, flash_attention_bwd_dkv)


def reset_launch_counts():
    """Set every wrapper's launch count to 0."""
    for fn in KERNELS:
        fn.launches = 0


__all__ = ["fused_rmsnorm_qkv", "fused_mlp", "paged_decode_attention",
           "flash_attention_fwd", "flash_attention_bwd_dq",
           "flash_attention_bwd_dkv", "KERNELS", "SERVING", "TRAINING",
           "reset_launch_counts"]
