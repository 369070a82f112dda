"""Common functionals (``paddle_tpu/nn/functional/common.py``): dropout."""

from __future__ import annotations

import torch

from paddle_tpu_torch.core import state as _state

__all__ = ["dropout"]


def dropout(x: torch.Tensor, p: float = 0.5, axis=None, training: bool = True,
            mode: str = "upscale_in_train") -> torch.Tensor:
    """Zero each element with probability `p` (``common.py:24-55``).

    ``upscale_in_train`` scales the kept elements by ``1 / (1 - p)`` in
    training and is the identity in eval; ``downscale_in_infer`` keeps
    them unscaled in training and multiplies by ``1 - p`` in eval.  With
    `axis` (an int or a list) one mask is drawn over those axes and
    broadcast along the others.  The mask comes from the device's global
    generator (``core.state.generator``)."""
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training and p > 0.0:
            return (x * (1.0 - p)).to(x.dtype)
        return x
    if p == 1.0:
        return torch.zeros_like(x)
    shape = list(x.shape)
    if axis is not None:
        axes = [axis] if isinstance(axis, int) else list(axis)
        axes = [a % x.ndim for a in axes]
        shape = [s if i in axes else 1 for i, s in enumerate(shape)]
    keep = torch.rand(shape, device=x.device,
                      generator=_state.generator(x.device)) < (1.0 - p)
    kept = x / (1.0 - p) if mode == "upscale_in_train" else x
    return torch.where(keep, kept, torch.zeros((), dtype=x.dtype,
                                               device=x.device)).to(x.dtype)
