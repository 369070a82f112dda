"""Normalization functionals (``paddle_tpu/nn/functional/norm.py``)."""

from __future__ import annotations

import torch

from paddle_tpu_torch.nn.functional.fused import _needs_grad
from paddle_tpu_torch.ops.kernels import rmsnorm as _RN

__all__ = ["layer_norm", "rms_norm", "rms_norm_residual"]


def layer_norm(x: torch.Tensor, normalized_shape, weight=None, bias=None,
               epsilon: float = 1e-5) -> torch.Tensor:
    """Layer norm over the trailing ``normalized_shape`` axes, statistics
    in fp32 (``norm.py:16-32``): the normalised activations are cast back
    to x's dtype, and only then multiplied by the weight and shifted by
    the bias."""
    ndim = 1 if isinstance(normalized_shape, int) else \
        len(tuple(normalized_shape))
    axes = tuple(range(x.ndim - ndim, x.ndim))
    xf = x.float()
    mean = xf.mean(dim=axes, keepdim=True)
    var = torch.square(xf - mean).mean(dim=axes, keepdim=True)
    out = ((xf - mean) / torch.sqrt(var + epsilon)).to(x.dtype)
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    return out


def rms_norm(x: torch.Tensor, weight=None, epsilon: float = 1e-6,
             axis: int = -1) -> torch.Tensor:
    """RMS norm over ``axis``, statistics in fp32.  The cast points are
    the JAX package's (``norm.py:34-42``): the normalised activations
    are cast back to x's dtype before the weight multiplies them, and the
    weight broadcasts against x's trailing axes."""
    xf = x.float()
    ms = torch.mean(xf * xf, dim=axis, keepdim=True)
    out = (xf * torch.reciprocal(torch.sqrt(ms + epsilon))).to(x.dtype)
    if weight is not None:
        out = out * weight
    return out


def rms_norm_residual(x: torch.Tensor, weight: torch.Tensor, residual=None,
                      epsilon: float = 1e-5):
    """``(y, h)``: h = x (+ residual), y = RMSNorm(h) * weight in the fused
    form (fp32 statistics and weight multiply, one cast), as
    ``norm.py:45-63``.  The returned ``h`` is the pre-norm sum the next
    residual branch consumes.  On the card the fused kernel
    (``ops/kernels/rmsnorm.py``), on the CPU its plain version; where
    autograd needs a gradient, through the custom VJP of both."""
    d = x.shape[-1]
    if not _needs_grad(*(t for t in (x, weight, residual) if t is not None)):
        y, h, _ = _RN.fused_rmsnorm(x, weight, residual, epsilon)
        return y, h
    x2d = x.reshape(-1, d)
    has_res = residual is not None
    # no residual: x is the unread placeholder, as in the JAX package
    res2d = residual.reshape(-1, d) if has_res else x2d
    y, h = _RN.FusedRMSNorm.apply(x2d, res2d, weight, float(epsilon),
                                  has_res)
    return y.reshape(x.shape), h.reshape(x.shape)
