"""Fused-block functionals (``paddle_tpu/nn/functional/fused.py``): the
fused RMSNorm+QKV, the SwiGLU MLP, the act + bias feed-forward and the
whole Llama decoder block, differentiable.

Where autograd needs a gradient (grad mode on and an input that requires
one) the call goes through the custom VJP, whose forward launches the
QKV kernel's training variant (``_qkv_fwd``); under ``inference_mode`` /
``no_grad`` it is the forward-only launch (``_qkv_core``'s primal), as
the JAX package chooses between them (``fused_block.py:359-383``).  The
kernel wrappers live in ``ops/kernels/fused_block.py``."""

from __future__ import annotations

import torch

from paddle_tpu_torch.core.dispatch import eager_op
from paddle_tpu_torch.ops.kernels import fused_block as _FB

__all__ = ["fused_rmsnorm_qkv", "fused_mlp", "fused_ffn",
           "fused_decoder_block"]


def _needs_grad(*tensors):
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


@eager_op
def fused_rmsnorm_qkv(x, norm_weight, wq, wk, wv, epsilon=1e-5):
    """``q, k, v = (rmsnorm(x) * norm_weight) @ (wq | wk | wv)``; x
    ``[..., d]``, weights ``[in, out]``.  Differentiable in every
    tensor."""
    if not _needs_grad(x, norm_weight, wq, wk, wv):
        return _FB.fused_rmsnorm_qkv(x, norm_weight, wq, wk, wv, epsilon)
    lead, d = x.shape[:-1], x.shape[-1]
    q, k, v = _FB.FusedRMSNormQKV.apply(x.reshape(-1, d), norm_weight, wq,
                                        wk, wv, float(epsilon))
    return (q.reshape(*lead, -1), k.reshape(*lead, -1),
            v.reshape(*lead, -1))


@eager_op
def fused_mlp(x, w_gate, w_up, w_down):
    """``(silu(x @ w_gate) * (x @ w_up)) @ w_down`` (SwiGLU); x
    ``[..., d]``.  Differentiable in every tensor."""
    if not _needs_grad(x, w_gate, w_up, w_down):
        return _FB.fused_mlp(x, w_gate, w_up, w_down)
    d = x.shape[-1]
    y = _FB.FusedMLP.apply(x.reshape(-1, d), w_gate, w_up, w_down)
    return y.reshape(x.shape)


@eager_op
def fused_ffn(x, w1, w2, b1=None, b2=None, activation="relu"):
    """``act(x @ w1 + b1) @ w2 + b2`` with relu, exact-erf gelu or silu;
    x ``[..., d]``, b1/b2 may be None (zeros).  Differentiable in x, the
    weights and the biases given."""
    if not _needs_grad(*(t for t in (x, w1, w2, b1, b2) if t is not None)):
        return _FB.fused_ffn(x, w1, w2, b1, b2, activation)
    d = x.shape[-1]
    y = _FB.FusedFFN.apply(x.reshape(-1, d), w1, b1, w2, b2, activation)
    return y.reshape(x.shape)


@eager_op
def fused_decoder_block(x, norm1_weight, wq, wk, wv, rope_cos, rope_sin, wo,
                        norm2_weight, wg, wu, wd, num_heads, num_kv_heads,
                        epsilon=1e-5):
    """One whole Llama decoder block (rmsnorm -> QKV -> RoPE -> causal
    attention -> o-proj + residual -> rmsnorm -> SwiGLU MLP + residual)
    of x ``[b, s, d]``; weights ``[in, out]``, rope tables
    ``[max_pos, head_dim // 2]`` (rows ``[0, s)``).  One launch of the
    block kernel on the card where its gate takes the shape (the
    per-segment kernels elsewhere), the plain version on the CPU.
    Differentiable in x and every weight through the block-boundary
    remat (``FusedDecoderBlock``); ``PADDLE_TPU_FUSED_BLOCK=decoder``
    routes eligible Llama layers here."""
    args = (x, norm1_weight, wq, wk, wv, rope_cos, rope_sin, wo,
            norm2_weight, wg, wu, wd)
    if not _needs_grad(x, norm1_weight, wq, wk, wv, wo, norm2_weight, wg,
                       wu, wd):
        return _FB.fused_decoder_block(*args, num_heads, num_kv_heads,
                                       epsilon)
    return _FB.FusedDecoderBlock.apply(*args, int(num_heads),
                                       int(num_kv_heads), float(epsilon))
