"""Activation functionals (``paddle_tpu/nn/functional/activation.py``)."""

from __future__ import annotations

import torch

__all__ = ["silu"]


def silu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x)."""
    return x * torch.sigmoid(x)
