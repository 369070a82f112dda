"""Activation functionals (``paddle_tpu/nn/functional/activation.py``)."""

from __future__ import annotations

import math

import torch

__all__ = ["relu", "silu", "gelu"]


def relu(x: torch.Tensor) -> torch.Tensor:
    """max(x, 0)."""
    return torch.relu(x)


def silu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x)."""
    return x * torch.sigmoid(x)


def gelu(x: torch.Tensor, approximate: bool = False) -> torch.Tensor:
    """``jax.nn.gelu`` in its own operations: exact ``0.5 x erfc(-x /
    sqrt 2)``, or with ``approximate`` the tanh form
    ``x * 0.5 (1 + tanh(sqrt(2 / pi) (x + 0.044715 x^3)))``."""
    if approximate:
        c = math.sqrt(2.0 / math.pi)
        return x * (0.5 * (1.0 + torch.tanh(c * (x + 0.044715 * x ** 3))))
    return 0.5 * x * torch.erfc(-x * math.sqrt(0.5))
