"""Search / sort / selection ops (``paddle_tpu/ops/search.py``; parity:
python/paddle/tensor/search.py).

Sorts keep JAX's tie order: stable, equal keys in input order (a
descending stable sort too), ``topk`` and ``kthvalue`` the lower index
first among equal values (a stable sort: ``torch.topk``'s tie order on
the card is unspecified).  Index outputs are int64, the dtype JAX's code
names."""

from __future__ import annotations

import torch

from paddle_tpu_torch.core import dtypes as _dtypes
from paddle_tpu_torch.core.dispatch import eager_op
from paddle_tpu_torch.ops.generated_math import _argsort, _topk


@eager_op
def argmax(x, axis=None, keepdim=False, dtype="int64"):
    if axis is None:
        x = x.reshape(-1)
        axis = 0
    out = torch.argmax(x, dim=int(axis), keepdim=keepdim)
    return out.to(_dtypes.to_torch(dtype))


@eager_op
def argmin(x, axis=None, keepdim=False, dtype="int64"):
    if axis is None:
        x = x.reshape(-1)
        axis = 0
    out = torch.argmin(x, dim=int(axis), keepdim=keepdim)
    return out.to(_dtypes.to_torch(dtype))


@eager_op
def argsort(x, axis=-1, descending=False, stable=True):
    return _argsort(x, axis, descending, stable)


@eager_op
def sort(x, axis=-1, descending=False, stable=True):
    return torch.sort(x, dim=axis, descending=descending, stable=True).values


@eager_op
def topk(x, k, axis=None, largest=True, sorted=True):
    if axis is None:
        axis = -1
    axis = axis % x.ndim
    vals, idx = _topk(torch.movedim(x, axis, -1), int(k), largest)
    return torch.movedim(vals, -1, axis), torch.movedim(idx, -1, axis)


@eager_op
def kthvalue(x, k, axis=-1, keepdim=False):
    axis = axis % x.ndim
    sorted_v, sorted_i = torch.sort(x, dim=axis, stable=True)
    vals = torch.select(sorted_v, axis, k - 1)
    idx = torch.select(sorted_i, axis, k - 1)
    if keepdim:
        vals = torch.unsqueeze(vals, axis)
        idx = torch.unsqueeze(idx, axis)
    return vals, idx


@eager_op
def mode(x, axis=-1, keepdim=False):
    """The most frequent value along `axis` (the smallest among equally
    frequent ones) and the LAST index holding it, as paddle returns."""
    axis = axis % x.ndim
    moved = torch.movedim(x, axis, -1)
    counts = torch.sum(moved[..., :, None] == moved[..., None, :], dim=-1)
    maxc = torch.amax(counts, dim=-1, keepdim=True)
    top = torch.finfo(moved.dtype).max if moved.is_floating_point() \
        else torch.iinfo(moved.dtype).max
    big = torch.where(counts == maxc, moved,
                      torch.as_tensor(top, dtype=moved.dtype,
                                      device=moved.device))
    vals = torch.amin(big, dim=-1)
    hits = moved == vals[..., None]
    rev_idx = torch.argmax(torch.flip(hits, (-1,)).to(torch.uint8), dim=-1)
    idx = moved.shape[-1] - 1 - rev_idx
    if keepdim:
        vals = torch.unsqueeze(vals, axis)
        idx = torch.unsqueeze(idx, axis)
    return vals, idx


@eager_op
def nonzero(x, as_tuple=False):
    if as_tuple:
        return torch.nonzero(x, as_tuple=True)
    return torch.nonzero(x)


@eager_op
def masked_argmax(x, mask, axis=None, keepdim=False):
    neg = torch.finfo(x.dtype).min if x.is_floating_point() \
        else torch.iinfo(x.dtype).min
    masked = torch.where(mask, x, torch.as_tensor(neg, dtype=x.dtype,
                                                  device=x.device))
    if axis is None:
        return torch.argmax(masked)
    return torch.argmax(masked, dim=axis, keepdim=keepdim)


@eager_op
def searchsorted(sorted_sequence, values, out_int32=False, right=False):
    return torch.searchsorted(sorted_sequence, values, out_int32=out_int32,
                              right=right)


@eager_op
def bucketize(x, sorted_sequence, out_int32=False, right=False):
    return torch.bucketize(x, sorted_sequence, out_int32=out_int32,
                           right=right)


@eager_op
def index_fill(x, index, axis, value):
    return torch.index_fill(x, axis, torch.reshape(index, (-1,)), value)


__all__ = [_n for _n, _v in list(globals().items())
           if not _n.startswith("_") and callable(_v)
           and (hasattr(_v, "__wrapped_pure__")
                or getattr(_v, "__module__", None) == __name__)]
