"""Activation functionals (``paddle_tpu/nn/functional/activation.py``):
the JAX package's 29, each in the operations of its ``jax.nn``
counterpart (``softplus`` as ``logaddexp(x, 0)``, ``elu`` / ``selu``
through ``expm1``), so fp32 results agree to rounding."""

from __future__ import annotations

import math

import torch

from paddle_tpu_torch.core.dispatch import eager_op

__all__ = ["relu", "relu6", "sigmoid", "tanh", "silu", "swish", "mish",
           "hardswish", "hardsigmoid", "hardtanh", "elu", "celu", "selu",
           "leaky_relu", "softplus", "softsign", "tanhshrink", "log_sigmoid",
           "gelu", "softmax", "log_softmax", "softshrink", "hardshrink",
           "thresholded_relu", "prelu", "rrelu", "maxout", "glu",
           "gumbel_softmax"]


def _zero(x):
    return torch.zeros((), dtype=x.dtype, device=x.device)


def _softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, _zero(x))


@eager_op
def relu(x: torch.Tensor) -> torch.Tensor:
    """max(x, 0)."""
    return torch.relu(x)


@eager_op
def relu6(x):
    return torch.clamp(x, 0.0, 6.0)


@eager_op
def sigmoid(x):
    return torch.sigmoid(x)


@eager_op
def tanh(x):
    return torch.tanh(x)


@eager_op
def silu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x)."""
    return x * torch.sigmoid(x)


swish = silu


@eager_op
def mish(x):
    return x * torch.tanh(_softplus(x))


@eager_op
def hardswish(x):
    """``jax.nn.hard_swish``: x * relu6(x + 3) / 6."""
    return x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


@eager_op
def hardsigmoid(x, slope=1.0 / 6, offset=0.5):
    return torch.clamp(x * slope + offset, 0.0, 1.0)


@eager_op
def hardtanh(x, min=-1.0, max=1.0):
    return torch.clamp(x, min, max)


@eager_op
def elu(x, alpha=1.0):
    """``jax.nn.elu``: x above 0, else alpha * expm1(x)."""
    safe = torch.where(x > 0, _zero(x), x)
    return torch.where(x > 0, x, alpha * torch.expm1(safe))


@eager_op
def celu(x, alpha=1.0):
    """``jax.nn.celu``: max(x, 0) + alpha * expm1(min(x, 0) / alpha)."""
    return torch.clamp_min(x, 0.0) + \
        alpha * torch.expm1(torch.clamp_max(x, 0.0) / alpha)


@eager_op
def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772):
    return scale * torch.where(x > 0, x, alpha * torch.expm1(x))


@eager_op
def leaky_relu(x, negative_slope=0.01):
    return torch.where(x >= 0, x, negative_slope * x)


@eager_op
def softplus(x, beta=1.0, threshold=20.0):
    return torch.where(x * beta > threshold, x, _softplus(x * beta) / beta)


@eager_op
def softsign(x):
    return x / (torch.abs(x) + 1)


@eager_op
def tanhshrink(x):
    return x - torch.tanh(x)


@eager_op
def log_sigmoid(x):
    """``jax.nn.log_sigmoid``: -softplus(-x)."""
    return -_softplus(-x)


@eager_op
def gelu(x: torch.Tensor, approximate: bool = False) -> torch.Tensor:
    """``jax.nn.gelu`` in its own operations: exact ``0.5 x erfc(-x /
    sqrt 2)``, or with ``approximate`` the tanh form
    ``x * 0.5 (1 + tanh(sqrt(2 / pi) (x + 0.044715 x^3)))``."""
    if approximate:
        c = math.sqrt(2.0 / math.pi)
        return x * (0.5 * (1.0 + torch.tanh(c * (x + 0.044715 * x ** 3))))
    return 0.5 * x * torch.erfc(-x * math.sqrt(0.5))


def _cast(x, dtype):
    if dtype is None:
        return x
    from paddle_tpu_torch.core import dtypes as _dtypes
    return x.to(_dtypes.to_torch(dtype))


@eager_op
def softmax(x, axis=-1, dtype=None):
    return torch.softmax(_cast(x, dtype), dim=axis)


@eager_op
def log_softmax(x, axis=-1, dtype=None):
    return torch.log_softmax(_cast(x, dtype), dim=axis)


@eager_op
def softshrink(x, threshold=0.5):
    return torch.where(x > threshold, x - threshold,
                       torch.where(x < -threshold, x + threshold,
                                   _zero(x)))


@eager_op
def hardshrink(x, threshold=0.5):
    return torch.where(torch.abs(x) > threshold, x, _zero(x))


@eager_op
def thresholded_relu(x, threshold=1.0, value=0.0):
    return torch.where(x > threshold, x,
                       torch.tensor(value, dtype=x.dtype, device=x.device))


@eager_op
def prelu(x, weight, data_format="NCHW"):
    """A 1-D weight of more than one slope goes on the channel axis (1
    for NCHW, the last otherwise)."""
    w = weight
    if w.ndim == 1 and w.shape[0] > 1 and x.ndim > 1:
        ch_axis = 1 if data_format == "NCHW" else x.ndim - 1
        shape = [1] * x.ndim
        shape[ch_axis] = w.shape[0]
        w = w.reshape(shape)
    return torch.where(x >= 0, x, w * x)


@eager_op
def rrelu(x, lower=0.125, upper=0.3333333333333333, training=False):
    """The mean slope ``(lower + upper) / 2`` in training too, as in the
    JAX package."""
    slope = (lower + upper) / 2.0
    return torch.where(x >= 0, x, slope * x)


@eager_op
def maxout(x, groups, axis=1):
    axis = axis % x.ndim
    c = x.shape[axis]
    shape = tuple(x.shape[:axis]) + (c // groups, groups) + \
        tuple(x.shape[axis + 1:])
    return torch.amax(x.reshape(shape), dim=axis + 1)


@eager_op
def glu(x, axis=-1):
    a, b = torch.chunk(x, 2, dim=axis)
    return a * torch.sigmoid(b)


@eager_op
def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1):
    """The JAX package's deterministic form: no Gumbel noise, softmax of
    ``x / temperature``; with `hard` the one-hot of its argmax carrying
    the soft gradient."""
    y = torch.softmax(x / temperature, dim=axis)
    if hard:
        idx = torch.argmax(y, dim=axis, keepdim=True)
        onehot = torch.zeros_like(y).scatter(axis, idx, 1.0)
        y = onehot + (-y).detach() + y
    return y
