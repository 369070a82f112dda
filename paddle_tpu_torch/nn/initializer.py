"""The initializers that ``Linear``, ``Embedding`` and ``RMSNorm`` use by
default (``paddle_tpu/nn/initializer.py``).

Each is a callable ``(shape, dtype, device) -> tensor`` drawing from the
device's global generator (``core.state.generator``).  Normal draws are
made in float32 and cast once, so a bf16 parameter rounds once."""

from __future__ import annotations

import math

import torch

from paddle_tpu_torch.core import dtypes as _dtypes
from paddle_tpu_torch.core import state as _state

__all__ = ["Constant", "Normal", "XavierNormal"]


def _fans(shape):
    """(fan_in, fan_out), the JAX package's rule (``initializer.py:23-33``):
    a 2-D weight is ``[in, out]``; above two dimensions the conv layout
    ``[out, in, *rest]``, each fan times the product of the rest (so a
    stacked expert weight ``[E, d, h]`` has fans d*h and E*h)."""
    shape = tuple(shape)
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = math.prod(shape[2:])
    return shape[1] * receptive, shape[0] * receptive


class Constant:
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, shape, dtype="float32", device="cpu"):
        return torch.full(tuple(shape), self.value,
                          dtype=_dtypes.to_torch(dtype), device=device)


class Normal:
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype="float32", device="cpu"):
        x = torch.randn(tuple(shape), dtype=torch.float32, device=device,
                        generator=_state.generator(device))
        return (x * self.std + self.mean).to(_dtypes.to_torch(dtype))


class XavierNormal:
    """std = gain * sqrt(2 / (fan_in + fan_out)); a 2-D weight is
    ``[in, out]``."""

    def __init__(self, gain=1.0):
        self.gain = gain

    def __call__(self, shape, dtype="float32", device="cpu"):
        fi, fo = _fans(shape)
        std = self.gain * math.sqrt(2.0 / (fi + fo))
        return Normal(0.0, std)(shape, dtype, device)
