"""Normalization functionals (``paddle_tpu/nn/functional/norm.py``)."""

from __future__ import annotations

import torch

__all__ = ["layer_norm", "rms_norm"]


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


def rms_norm(x: torch.Tensor, weight=None, epsilon: float = 1e-6
             ) -> torch.Tensor:
    """RMS norm over the last axis, statistics in fp32.  The cast points
    are the JAX package's (``norm.py:35``): the normalised activations
    are cast back to x's dtype before the weight multiplies them."""
    xf = x.float()
    ms = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = (xf * torch.reciprocal(torch.sqrt(ms + epsilon))).to(x.dtype)
    if weight is not None:
        out = out * weight
    return out
