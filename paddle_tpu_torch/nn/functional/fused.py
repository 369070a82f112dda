"""Fused-block functionals (``paddle_tpu/nn/functional/fused.py``): the
fused RMSNorm+QKV, the SwiGLU MLP and the act + bias feed-forward,
differentiable.

Where autograd needs a gradient (grad mode on and an input that requires
one) the call goes through the custom VJP, whose forward launches the
QKV kernel's training variant (``_qkv_fwd``); under ``inference_mode`` /
``no_grad`` it is the forward-only launch (``_qkv_core``'s primal), as
the JAX package chooses between them (``fused_block.py:359-383``).  The
kernel wrappers live in ``ops/kernels/fused_block.py``."""

from __future__ import annotations

import torch

from paddle_tpu_torch.ops.kernels import fused_block as _FB

__all__ = ["fused_rmsnorm_qkv", "fused_mlp", "fused_ffn"]


def _needs_grad(*tensors):
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


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


def fused_mlp(x, w_gate, w_up, w_down):
    """``(silu(x @ w_gate) * (x @ w_up)) @ w_down`` (SwiGLU); x
    ``[..., d]``.  Differentiable in every tensor."""
    if not _needs_grad(x, w_gate, w_up, w_down):
        return _FB.fused_mlp(x, w_gate, w_up, w_down)
    d = x.shape[-1]
    y = _FB.FusedMLP.apply(x.reshape(-1, d), w_gate, w_up, w_down)
    return y.reshape(x.shape)


def fused_ffn(x, w1, w2, b1=None, b2=None, activation="relu"):
    """``act(x @ w1 + b1) @ w2 + b2`` with relu, exact-erf gelu or silu;
    x ``[..., d]``, b1/b2 may be None (zeros).  Differentiable in x, the
    weights and the biases given."""
    if not _needs_grad(*(t for t in (x, w1, w2, b1, b2) if t is not None)):
        return _FB.fused_ffn(x, w1, w2, b1, b2, activation)
    d = x.shape[-1]
    y = _FB.FusedFFN.apply(x.reshape(-1, d), w1, b1, w2, b2, activation)
    return y.reshape(x.shape)
