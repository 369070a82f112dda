"""Statistics ops (``paddle_tpu/ops/stat.py``; parity:
python/paddle/tensor/stat.py).

``median`` averages the two middle values (``mode="avg"``, JAX's
``jnp.median``; ``torch.median`` returns the lower one); ``mode="min"``
returns the lower middle value and its index.  ``var`` / ``std`` take
``unbiased`` (ddof 1 or 0)."""

from __future__ import annotations

import torch

from paddle_tpu_torch.core.dispatch import eager_op
from paddle_tpu_torch.ops.generated_math import _quantile


def _axis(axis):
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return axis


@eager_op
def var(x, axis=None, unbiased=True, keepdim=False):
    return torch.var(x, dim=_axis(axis), correction=1 if unbiased else 0,
                     keepdim=keepdim)


@eager_op
def std(x, axis=None, unbiased=True, keepdim=False):
    return torch.std(x, dim=_axis(axis), correction=1 if unbiased else 0,
                     keepdim=keepdim)


@eager_op
def median(x, axis=None, keepdim=False, mode="avg"):
    if mode == "avg":
        return _quantile(x, 0.5, axis, keepdim, "midpoint", torch.quantile)
    # mode == 'min': lower of the two middle elements, plus its index
    ax = -1 if axis is None else int(axis)
    flat = x.reshape(-1) if axis is None else x
    n = flat.shape[ax]
    k = (n - 1) // 2
    sorted_v, sorted_i = torch.sort(flat, dim=ax, stable=True)
    vals = torch.select(sorted_v, ax, k)
    idx = torch.select(sorted_i, ax, k)
    if keepdim and axis is not None:
        vals = torch.unsqueeze(vals, ax)
        idx = torch.unsqueeze(idx, ax)
    return vals, idx


@eager_op
def nanmedian(x, axis=None, keepdim=False):
    return _quantile(x, 0.5, axis, keepdim, "midpoint", torch.nanquantile)


@eager_op
def quantile(x, q, axis=None, keepdim=False, interpolation="linear"):
    return _quantile(x, q, axis, keepdim, interpolation, torch.quantile)


@eager_op
def nanquantile(x, q, axis=None, keepdim=False, interpolation="linear"):
    return _quantile(x, q, axis, keepdim, interpolation, torch.nanquantile)


@eager_op
def histogramdd(x, bins=10, ranges=None, density=False, weights=None):
    """``jnp.histogramdd`` of the rows of x (``[N, D]``): per dim
    ``bins`` equal bins over its range (the data's by default), the last
    closed; returns (hist, edges)."""
    n, d = x.shape
    nb = [bins] * d if isinstance(bins, int) else list(bins)
    edges, idxs = [], []
    for i in range(d):
        col = x[:, i].contiguous()
        if ranges is None:
            lo, hi = col.min().item(), col.max().item()
        else:
            lo, hi = (float(v) for v in ranges[i])
        e = torch.linspace(lo, hi, nb[i] + 1, dtype=x.dtype, device=x.device)
        b = torch.searchsorted(e, col, right=True)
        b = torch.where(col == e[-1], b - 1, b)
        edges.append(e)
        idxs.append(torch.clamp(b, 0, nb[i] + 1))
    flat = torch.zeros_like(idxs[0])
    for i in range(d):
        flat = flat * (nb[i] + 2) + idxs[i]
    w = None if weights is None else weights.reshape(-1)
    size = 1
    for b in nb:
        size *= b + 2
    hist = torch.bincount(flat, weights=w, minlength=size)
    hist = hist.reshape([b + 2 for b in nb])
    hist = hist[tuple(slice(1, -1) for _ in nb)]
    if density:
        hist = hist / hist.sum()
        for i in range(d):
            shape = [1] * d
            shape[i] = nb[i]
            hist = hist / torch.diff(edges[i]).reshape(shape)
    return hist, edges


# Public surface: only ops defined in this module.
__all__ = [_n for _n, _v in list(globals().items())
           if not _n.startswith("_") and callable(_v)
           and (hasattr(_v, "__wrapped_pure__")
                or getattr(_v, "__module__", None) == __name__)]
