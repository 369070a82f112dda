"""Shape / layout manipulation ops (``paddle_tpu/ops/manipulation.py``;
parity: python/paddle/tensor/manipulation.py).

Shapes, axes and sections may be Python ints, lists of ints or tensors,
as in the JAX package.  ``split`` takes Paddle's ``num_or_sections`` (a
count of equal parts or the sizes, one of them -1), not torch's
``split_size``; ``reshape`` keeps -1 (0 is a zero-sized dim in both
packages).  ``where(cond)`` and the index outputs are int64 (JAX's
int32 with x64 off)."""

from __future__ import annotations

import builtins

import numpy as np
import torch

from paddle_tpu_torch.core import dtypes as _dtypes
from paddle_tpu_torch.core.dispatch import eager_op
from paddle_tpu_torch.ops.generated_math import _strided, _take


def _static_ints(v):
    if isinstance(v, torch.Tensor):
        return [int(s) for s in v.reshape(-1).tolist()]
    if isinstance(v, (int, np.integer)):
        return [int(v)]
    return [int(s.item() if isinstance(s, torch.Tensor) else s) for s in v]


def _int(v):
    return int(v.item() if isinstance(v, torch.Tensor) else v)


@eager_op
def reshape(x, shape):
    return torch.reshape(x, _static_ints(shape))


def cast(x, dtype):
    """paddle.cast parity (a dtype change autograd tracks)."""
    if isinstance(x, torch.Tensor):
        return x.to(_dtypes.to_torch(dtype))
    return torch.as_tensor(np.asarray(x)).to(_dtypes.to_torch(dtype))


@eager_op
def flatten(x, start_axis=0, stop_axis=-1):
    nd = x.ndim
    if nd == 0:
        return torch.reshape(x, (1,))
    sa = start_axis % nd
    ea = stop_axis % nd
    return torch.reshape(x, tuple(x.shape[:sa]) + (-1,)
                         + tuple(x.shape[ea + 1:]))


@eager_op
def transpose(x, perm):
    return torch.permute(x, _static_ints(perm))


@eager_op
def moveaxis(x, source, destination):
    return torch.movedim(x, source, destination)


@eager_op
def swapaxes(x, axis0, axis1):
    return torch.swapaxes(x, axis0, axis1)


@eager_op
def t(x):
    if x.ndim <= 1:
        return x
    return torch.swapaxes(x, -1, -2) if x.ndim == 2 else \
        torch.permute(x, tuple(reversed(range(x.ndim))))


@eager_op
def squeeze(x, axis=None):
    if axis is None:
        return torch.squeeze(x)
    axes = _static_ints(axis) if not isinstance(axis, int) else [axis]
    axes = [a % x.ndim for a in axes]
    axes = [a for a in axes if x.shape[a] == 1]
    return torch.squeeze(x, tuple(axes)) if axes else x


@eager_op
def unsqueeze(x, axis):
    axes = _static_ints(axis) if not isinstance(axis, int) else [axis]
    out = x
    nd = x.ndim + len(axes)
    for a in sorted(a % nd for a in axes):
        out = torch.unsqueeze(out, a)
    return out


@eager_op
def concat(x, axis=0):
    return torch.cat(list(x), dim=_int(axis))


@eager_op
def stack(x, axis=0):
    return torch.stack(list(x), dim=_int(axis))


@eager_op
def unstack(x, axis=0, num=None):
    n = num if num is not None else x.shape[axis]
    return [torch.squeeze(s, axis) for s in torch.tensor_split(x, n, axis)]


@eager_op
def split(x, num_or_sections, axis=0):
    axis = _int(axis)
    if isinstance(num_or_sections, int):
        if x.shape[axis] % num_or_sections:
            raise ValueError(f"split: {x.shape[axis]} is not divisible "
                             f"into {num_or_sections} equal sections")
        return list(torch.tensor_split(x, num_or_sections, axis))
    secs = _static_ints(num_or_sections)
    total = x.shape[axis]
    if any(s == -1 for s in secs):
        known = sum(s for s in secs if s != -1)
        secs = [total - known if s == -1 else s for s in secs]
    idx = np.cumsum(secs)[:-1].tolist()
    return list(torch.tensor_split(x, idx, axis))


@eager_op
def chunk(x, chunks, axis=0):
    return list(torch.tensor_split(x, chunks, _int(axis)))


@eager_op
def tile(x, repeat_times):
    return torch.tile(x, _static_ints(repeat_times))


@eager_op
def expand(x, shape):
    tgt = _static_ints(shape)
    src = list(x.shape)
    # paddle expand: -1 keeps dim; broadcasting from the right
    while len(src) < len(tgt):
        src.insert(0, 1)
    out_shape = [s if t == -1 else t for s, t in zip(src, tgt)]
    return torch.broadcast_to(torch.reshape(x, src), out_shape)


@eager_op
def expand_as(x, y):
    return torch.broadcast_to(x, y.shape)


@eager_op
def broadcast_to(x, shape):
    return torch.broadcast_to(x, _static_ints(shape))


def broadcast_tensors(inputs):
    shape = torch.broadcast_shapes(*[i.shape for i in inputs])
    return [broadcast_to(i, list(shape)) for i in inputs]


@eager_op
def flip(x, axis):
    axes = _static_ints(axis) if not isinstance(axis, int) else [axis]
    return torch.flip(x, axes)


@eager_op
def rot90(x, k=1, axes=(0, 1)):
    return torch.rot90(x, k, list(axes))


@eager_op
def roll(x, shifts, axis=None):
    if axis is not None and not isinstance(axis, int):
        axis = tuple(_static_ints(axis))
    if not isinstance(shifts, int):
        shifts = tuple(_static_ints(shifts))
    if axis is None:
        return torch.roll(x, shifts)
    return torch.roll(x, shifts, axis)


@eager_op
def slice(x, axes, starts, ends):
    idx = [builtins.slice(None)] * x.ndim
    for a, s, e in zip(_static_ints(axes), _static_ints(starts),
                       _static_ints(ends)):
        idx[a] = builtins.slice(s, e)
    return x[tuple(idx)]


@eager_op
def strided_slice(x, axes, starts, ends, strides):
    for a, s, e, st in zip(_static_ints(axes), _static_ints(starts),
                           _static_ints(ends), _static_ints(strides)):
        x = _strided(x, a, s, e, st)
    return x


@eager_op
def gather(x, index, axis=0):
    index = torch.reshape(index, (-1,)) if index.ndim > 1 else index
    return _take(x, index, _int(axis))


@eager_op
def gather_nd(x, index):
    return x[tuple(torch.movedim(index, -1, 0))]


@eager_op
def take_along_axis(arr, indices, axis, broadcast=True):
    if broadcast:
        shape = list(arr.shape)
        shape[axis] = indices.shape[axis]
        indices = torch.broadcast_to(indices, shape)
    return torch.take_along_dim(arr, indices, dim=axis)


@eager_op
def put_along_axis(arr, indices, values, axis, reduce="assign"):
    values = torch.broadcast_to(torch.as_tensor(
        values, dtype=arr.dtype, device=arr.device), indices.shape)
    axis = axis % arr.ndim
    if reduce == "assign":
        return torch.scatter(arr, axis, indices, values)
    if reduce in ("add", "sum"):
        return torch.scatter_add(arr, axis, indices, values)
    if reduce in ("mul", "multiply"):
        return torch.scatter_reduce(arr, axis, indices, values, "prod")
    raise ValueError(f"unknown reduce {reduce}")


@eager_op
def scatter(x, index, updates, overwrite=True):
    index = torch.reshape(index, (-1,))
    updates = updates.to(x.dtype)
    if overwrite:
        return torch.index_put(x, (index,), updates)
    # overwrite=False: rows hit by index are zeroed then accumulated
    # (duplicate indices sum) — paddle scatter semantics.
    zeroed = torch.index_put(x, (index,), torch.zeros_like(updates))
    return torch.index_put(zeroed, (index,), updates, accumulate=True)


@eager_op
def scatter_nd_add(x, index, updates):
    return torch.index_put(x, tuple(torch.movedim(index, -1, 0)),
                           updates.to(x.dtype), accumulate=True)


@eager_op
def scatter_nd(index, updates, shape):
    zeros = torch.zeros(_static_ints(shape), dtype=updates.dtype,
                        device=updates.device)
    return torch.index_put(zeros, tuple(torch.movedim(index, -1, 0)),
                           updates, accumulate=True)


@eager_op
def index_select(x, index, axis=0):
    return _take(x, torch.reshape(index, (-1,)), axis)


@eager_op
def index_sample(x, index):
    return torch.take_along_dim(x, index, dim=1)


@eager_op
def index_add(x, index, axis, value):
    index = torch.reshape(index, (-1,))
    moved = torch.movedim(x, axis, 0)
    vmoved = torch.movedim(value, axis, 0)
    out = moved.index_add(0, index, vmoved.to(x.dtype))
    return torch.movedim(out, 0, axis)


@eager_op
def index_put(x, indices, value, accumulate=False):
    idx = tuple(indices)
    value = torch.as_tensor(value, dtype=x.dtype, device=x.device)
    if accumulate:
        return torch.index_put(x, idx, value, accumulate=True)
    return torch.index_put(x, idx, torch.broadcast_to(value, x[idx].shape))


@eager_op
def repeat_interleave(x, repeats, axis=None):
    if axis is None:
        return torch.repeat_interleave(torch.reshape(x, (-1,)), repeats)
    return torch.repeat_interleave(x, repeats, dim=axis)


@eager_op
def unbind(x, axis=0):
    return list(torch.unbind(x, axis))


@eager_op
def as_complex(x):
    return torch.complex(x[..., 0], x[..., 1])


@eager_op
def as_real(x):
    return torch.stack([torch.real(x), torch.imag(x)], dim=-1)


@eager_op
def masked_select(x, mask):
    # a dynamic-shape op: its size is read on the host
    return x[torch.broadcast_to(mask, x.shape)]


@eager_op
def masked_fill(x, mask, value):
    return torch.where(mask, torch.as_tensor(value, dtype=x.dtype,
                                             device=x.device), x)


@eager_op
def where(condition, x=None, y=None):
    if x is None and y is None:
        return torch.nonzero(condition, as_tuple=True)
    return torch.where(condition, x, y)


def _pad_index(n, lo, hi, mode, device):
    """Source positions of an axis of n padded by (lo, hi):
    ``jnp.pad``'s reflect (no edge repeat), edge and wrap."""
    pos = torch.arange(-lo, n + hi, device=device)
    if mode == "edge":
        return torch.clamp(pos, 0, n - 1)
    if mode == "wrap":
        return torch.remainder(pos, n)
    period = 2 * (n - 1)
    if period == 0:
        return torch.zeros_like(pos)
    p = torch.remainder(pos, period)
    return torch.where(p >= n, period - p, p)


@eager_op
def pad(x, pad, mode="constant", value=0.0, data_format="NCHW",
        pad_from_left_axis=True):
    pads = _static_ints(pad)
    nd = x.ndim
    if len(pads) == 2 * nd:
        # full per-axis spec, paddle order: axis-major lo/hi
        width = [(pads[2 * i], pads[2 * i + 1]) for i in range(nd)]
    else:
        # partial spec applies to trailing spatial dims; paddle packs
        # reversed (last axis first) like torch.nn.functional.pad
        k = len(pads) // 2
        width = [(0, 0)] * nd
        for i in range(k):
            width[nd - 1 - i] = (pads[2 * i], pads[2 * i + 1])
    jmode = {"constant": "constant", "reflect": "reflect",
             "replicate": "edge", "circular": "wrap"}[mode]
    if jmode == "constant":
        flat = [p for lo_hi in reversed(width) for p in lo_hi]
        return torch.nn.functional.pad(x, flat, mode="constant",
                                       value=value)
    out = x
    for ax, (lo, hi) in enumerate(width):
        if lo or hi:
            out = torch.index_select(out, ax, _pad_index(
                out.shape[ax], lo, hi, jmode, x.device))
    return out


@eager_op
def crop(x, shape=None, offsets=None):
    sh = _static_ints(shape)
    off = _static_ints(offsets) if offsets is not None else [0] * x.ndim
    sh = [x.shape[i] if s == -1 else s for i, s in enumerate(sh)]
    return x[tuple(builtins.slice(o, o + s) for o, s in zip(off, sh))]


@eager_op
def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None):
    """``jnp.unique``: sorted values; the first occurrence's index, the
    inverse (x's shape for axis None) and the counts as asked."""
    flat = torch.reshape(x, (-1,)) if axis is None else x
    dim = 0 if axis is None else axis
    vals, inv, counts = torch.unique(flat, sorted=True, return_inverse=True,
                                     return_counts=True, dim=dim)
    res = [vals]
    if return_index:
        n = flat.shape[dim]
        first = torch.full((vals.shape[dim],), n, dtype=torch.int64,
                           device=x.device)
        res.append(first.scatter_reduce(
            0, inv, torch.arange(n, device=x.device), "amin"))
    if return_inverse:
        res.append(inv.reshape(x.shape) if axis is None else inv)
    if return_counts:
        res.append(counts)
    return res[0] if len(res) == 1 else tuple(res)


@eager_op
def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None):
    if axis is not None:
        raise NotImplementedError("unique_consecutive with axis")
    out, inv, counts = torch.unique_consecutive(
        torch.reshape(x, (-1,)), return_inverse=True, return_counts=True)
    results = [out]
    if return_inverse:
        results.append(inv)
    if return_counts:
        results.append(counts)
    return results[0] if len(results) == 1 else tuple(results)


@eager_op
def rot90_(x, k=1):
    return torch.rot90(x, k, [0, 1])


@eager_op
def view(x, shape_or_dtype):
    if isinstance(shape_or_dtype, (list, tuple)):
        return torch.reshape(x, _static_ints(shape_or_dtype))
    return x.view(_dtypes.to_torch(shape_or_dtype))


@eager_op
def numel(x):
    return torch.tensor(x.numel(), dtype=torch.int64, device=x.device)


@eager_op
def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):
    shard_size = (index_num + nshards - 1) // nshards
    lo = shard_id * shard_size
    hi = lo + shard_size
    in_shard = (input >= lo) & (input < hi)
    return torch.where(in_shard, input - lo, ignore_value)


# ---- long-tail structural ops (paddle.tensor manipulation parity) ----------

@eager_op
def atleast_1d(x):
    return torch.atleast_1d(x)


@eager_op
def atleast_2d(x):
    return torch.atleast_2d(x)


@eager_op
def atleast_3d(x):
    return torch.atleast_3d(x)


@eager_op
def column_stack(x):
    return torch.column_stack(list(x))


@eager_op
def row_stack(x):
    return torch.vstack(list(x))


@eager_op
def hstack(x):
    return torch.hstack(list(x))


@eager_op
def vstack(x):
    return torch.vstack(list(x))


@eager_op
def dstack(x):
    return torch.dstack(list(x))


@eager_op
def hsplit(x, num_or_indices):
    return tuple(torch.tensor_split(x, num_or_indices, 1 if x.ndim > 1
                                    else 0))


@eager_op
def vsplit(x, num_or_indices):
    return tuple(torch.tensor_split(x, num_or_indices, 0))


@eager_op
def dsplit(x, num_or_indices):
    return tuple(torch.tensor_split(x, num_or_indices, 2))


@eager_op
def tensor_split(x, num_or_indices, axis=0):
    return tuple(torch.tensor_split(x, num_or_indices, axis))


@eager_op
def block_diag(inputs):
    return torch.block_diag(*inputs)


@eager_op
def select_scatter(x, values, axis, index):
    return torch.select_scatter(x, values.to(x.dtype), axis, index)


@eager_op
def slice_scatter(x, value, axes, starts, ends, strides=None):
    strides = strides or [1] * len(axes)
    idx = torch.arange(x.numel(), device=x.device).reshape(x.shape)
    for ax, s, e, st in zip(axes, starts, ends, strides):
        idx = _strided(idx, ax, s, e, st)
    flat = torch.reshape(x, (-1,)).index_put(
        (torch.reshape(idx, (-1,)),),
        torch.reshape(torch.broadcast_to(value.to(x.dtype), idx.shape),
                      (-1,)))
    return flat.reshape(x.shape)


def rank(x):
    """Number of dimensions (paddle.rank parity)."""
    return x.ndim


@eager_op
def masked_scatter(x, mask, value):
    """Fill True positions of `mask` with `value`'s leading elements in
    row-major order (reference tensor/manipulation.py masked_scatter):
    position k of the mask takes value element number of True positions
    before it.  `value` must carry at least mask.sum() elements; the
    count is read on the host only when value has fewer elements than
    the mask."""
    m = torch.broadcast_to(mask, x.shape)
    vflat = torch.reshape(value, (-1,))
    if vflat.shape[0] < m.numel():
        need = int(m.sum())
        if vflat.shape[0] < need:
            raise ValueError(
                f"masked_scatter: mask selects {need} elements but value "
                f"supplies only {vflat.shape[0]} "
                f"({need - vflat.shape[0]} short)")
    if vflat.shape[0] == 0:
        return x
    order = torch.cumsum(torch.reshape(m, (-1,)).to(torch.int32), 0) - 1
    picked = vflat[torch.clamp(order, 0, vflat.shape[0] - 1)]
    return torch.where(m, picked.reshape(x.shape).to(x.dtype), x)


@eager_op
def view_as(x, other):
    """Reshape x to other's shape (reference view_as)."""
    return torch.reshape(x, other.shape)


__all__ = [_n for _n, _v in list(globals().items())
           if not _n.startswith("_") and callable(_v)
           and (hasattr(_v, "__wrapped_pure__")
                or getattr(_v, "__module__", None) == __name__)]
