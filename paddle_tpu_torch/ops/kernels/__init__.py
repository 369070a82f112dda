"""Hand-written CUDA kernels for Hopper (``sm_90a``) — the port's
counterpart of ``paddle_tpu/ops/pallas``.  Sources are in ``csrc/``;
``_build.py`` compiles them at first use."""

from paddle_tpu_torch.ops.kernels.fused_block import (fused_mlp,
                                                      fused_rmsnorm_qkv)
from paddle_tpu_torch.ops.kernels.paged_attention import \
    paged_decode_attention

# the kernel wrappers of the serving path, each with a `launches` count
KERNELS = (fused_rmsnorm_qkv, fused_mlp, paged_decode_attention)


def reset_launch_counts():
    """Set every wrapper's launch count to 0."""
    for fn in KERNELS:
        fn.launches = 0


__all__ = ["fused_rmsnorm_qkv", "fused_mlp", "paged_decode_attention",
           "KERNELS", "reset_launch_counts"]
