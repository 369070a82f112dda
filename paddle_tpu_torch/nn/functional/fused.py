"""Fused-block functionals (``paddle_tpu/nn/functional/fused.py``): the
public names of the fused RMSNorm+QKV and SwiGLU MLP kernels, whose
wrappers live in ``ops/kernels/fused_block.py``."""

from paddle_tpu_torch.ops.kernels.fused_block import (fused_mlp,
                                                      fused_rmsnorm_qkv)

__all__ = ["fused_rmsnorm_qkv", "fused_mlp"]
