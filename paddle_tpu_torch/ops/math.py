"""Elementwise & reduction math ops (``paddle_tpu/ops/math.py``; parity:
python/paddle/tensor/math.py).

The bulk of this surface is GENERATED from the port's op schema
(``ops/gen/ops.yaml`` -> ``ops/generated_math.py``); only ops with
bespoke control flow stay hand-written here."""

from __future__ import annotations

import torch

from paddle_tpu_torch.core.dispatch import eager_op
from paddle_tpu_torch.ops.generated_math import *  # noqa: F401,F403
from paddle_tpu_torch.ops.generated_math import remainder, __all__ as _gen_all

# paddle-parity aliases
mod = remainder
floor_mod = remainder


@eager_op
def rsqrt_(x):  # convenience pure form
    return torch.rsqrt(x)


@eager_op(name="multiplex")
def multiplex(inputs, index):
    stacked = torch.stack(list(inputs), dim=0)  # [n, batch, ...]
    idx = torch.reshape(index, (-1,))
    return stacked[idx, torch.arange(idx.shape[0], device=idx.device)]


@eager_op(name="renorm")
def renorm(x, p, axis, max_norm):
    moved = torch.movedim(x, axis, 0)
    flat = moved.reshape(moved.shape[0], -1)
    norms = torch.sum(torch.abs(flat) ** p, dim=1) ** (1.0 / p)
    factor = torch.where(norms > max_norm, max_norm / (norms + 1e-7),
                         torch.ones_like(norms))
    out = flat * factor[:, None]
    return torch.movedim(out.reshape(moved.shape), 0, axis)


__all__ = [n for n in _gen_all if n not in ("OP_INFO", "OP_TESTS")] + [
    "mod", "floor_mod", "rsqrt_", "multiplex", "renorm",
    "cumulative_trapezoid", "histogram_bin_edges"]


@eager_op
def cumulative_trapezoid(y, x=None, dx=None, axis=-1):
    """Cumulative trapezoidal integral: one fewer element along `axis`
    than y."""
    n = y.shape[axis]
    y0 = torch.narrow(y, axis, 0, n - 1)
    y1 = torch.narrow(y, axis, 1, n - 1)
    if x is not None:
        x0 = torch.narrow(x, axis, 0, x.shape[axis] - 1)
        x1 = torch.narrow(x, axis, 1, x.shape[axis] - 1)
        seg = (x1 - x0) * (y0 + y1) / 2.0
    else:
        seg = (dx if dx is not None else 1.0) * (y0 + y1) / 2.0
    return torch.cumsum(seg, dim=axis)


@eager_op
def histogram_bin_edges(input, bins=100, min=0, max=0):
    """Bin edges matching histogram's binning."""
    lo, hi = min, max
    if lo == 0 and hi == 0:
        lo, hi = input.min().item(), input.max().item()
    return torch.linspace(lo, hi, bins + 1, dtype=input.dtype,
                          device=input.device)
