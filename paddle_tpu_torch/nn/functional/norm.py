"""Normalization functionals (``paddle_tpu/nn/functional/norm.py``)."""

from __future__ import annotations

import torch

__all__ = ["rms_norm"]


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
