"""Tensor creation ops (``paddle_tpu/ops/creation.py``; parity:
python/paddle/tensor/creation.py).

An op with no tensor input puts its output on the port's default device
(``device.set_device``; the card unless ``set_device("cpu")`` was
called, and without a card such an op raises).  Float outputs given no
dtype take the default dtype (``core/state.py``); an integer Python
fill or range is ``int64``, the dtype the JAX package's code names (JAX
itself gives int32 with x64 off)."""

from __future__ import annotations

import numpy as np
import torch

from paddle_tpu_torch.core import dtypes as _dtypes
from paddle_tpu_torch.core import state as _state
from paddle_tpu_torch.core.dispatch import eager_op

__all__ = [
    "to_tensor", "zeros", "ones", "full", "zeros_like", "ones_like",
    "full_like", "empty", "empty_like", "arange", "linspace", "logspace",
    "eye", "diag", "diagflat", "tril", "triu", "meshgrid", "assign",
    "clone", "tril_indices", "triu_indices", "complex", "polar",
]


def _resolve_dtype(dtype, default_float=True):
    if dtype is None:
        return _dtypes.to_torch(_state.get_default_dtype()) \
            if default_float else None
    return _dtypes.to_torch(dtype)


def _dev(place=None):
    if isinstance(place, str):
        from paddle_tpu_torch.device import torch_device_name
        place = torch_device_name(place)
    return _state.resolve_device(place)


def _scalar(v):
    return v.item() if isinstance(v, torch.Tensor) else v


def _shape(shape):
    if isinstance(shape, torch.Tensor):
        return tuple(int(s) for s in shape.reshape(-1).tolist())
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    return tuple(int(_scalar(s)) for s in shape)


def to_tensor(data, dtype=None, place=None, stop_gradient=True):
    """A new tensor on `place` (the default device when None).  A float64
    numpy array or Python float given no dtype becomes float32, as in
    the JAX package (``core/tensor.py:148-165``)."""
    dev = _dev(place)
    if isinstance(data, torch.Tensor):
        t = data.detach().to(device=dev, dtype=_dtypes.to_torch(dtype)
                             if dtype is not None else None, copy=True)
    else:
        arr = np.asarray(data)
        if dtype is None and arr.dtype == np.float64:
            arr = arr.astype(np.float32)
        t = torch.as_tensor(arr, device=dev)
        if dtype is not None:
            t = t.to(_dtypes.to_torch(dtype))
    if not stop_gradient and (t.is_floating_point() or t.is_complex()):
        t.requires_grad_(True)
    return t


def zeros(shape, dtype=None, name=None):
    return torch.zeros(_shape(shape), dtype=_resolve_dtype(dtype),
                       device=_dev())


def ones(shape, dtype=None, name=None):
    return torch.ones(_shape(shape), dtype=_resolve_dtype(dtype),
                      device=_dev())


def full(shape, fill_value, dtype=None, name=None):
    fill = _scalar(fill_value)
    if dtype is None and isinstance(fill, bool):
        dt = torch.bool
    elif dtype is None and isinstance(fill, int):
        dt = torch.int64
    else:
        dt = _resolve_dtype(dtype)
    return torch.full(_shape(shape), fill, dtype=dt, device=_dev())


@eager_op
def zeros_like(x, dtype=None):
    return torch.zeros_like(x, dtype=_dtypes.to_torch(dtype)
                            if dtype is not None else None)


@eager_op
def ones_like(x, dtype=None):
    return torch.ones_like(x, dtype=_dtypes.to_torch(dtype)
                           if dtype is not None else None)


@eager_op
def full_like(x, fill_value, dtype=None):
    return torch.full_like(x, _scalar(fill_value),
                           dtype=_dtypes.to_torch(dtype)
                           if dtype is not None else None)


def empty(shape, dtype=None, name=None):
    return zeros(shape, dtype)


@eager_op
def empty_like(x, dtype=None):
    return torch.zeros_like(x, dtype=_dtypes.to_torch(dtype)
                            if dtype is not None else None)


def arange(start=0, end=None, step=1, dtype=None, name=None):
    start, end, step = _scalar(start), _scalar(end), _scalar(step)
    if end is None:
        start, end = 0, start
    if dtype is None:
        if any(isinstance(v, float) for v in (start, end, step)):
            dt = _resolve_dtype(None)
        else:
            dt = torch.int64
    else:
        dt = _dtypes.to_torch(dtype)
    return torch.arange(start, end, step, dtype=dt, device=_dev())


def linspace(start, stop, num, dtype=None, name=None):
    return torch.linspace(_scalar(start), _scalar(stop), int(_scalar(num)),
                          dtype=_resolve_dtype(dtype), device=_dev())


def logspace(start, stop, num, base=10.0, dtype=None, name=None):
    return torch.logspace(_scalar(start), _scalar(stop), int(_scalar(num)),
                          base=_scalar(base), dtype=_resolve_dtype(dtype),
                          device=_dev())


def eye(num_rows, num_columns=None, dtype=None, name=None):
    n = int(num_rows)
    return torch.eye(n, n if num_columns is None else int(num_columns),
                     dtype=_resolve_dtype(dtype), device=_dev())


@eager_op
def diag(x, offset=0, padding_value=0):
    if x.ndim == 1:
        d = torch.diag(x, offset)
        if padding_value != 0:
            mask = torch.diag(torch.ones(x.shape[0], dtype=torch.bool,
                                         device=x.device), offset)
            d = torch.where(mask, d, torch.as_tensor(
                padding_value, dtype=d.dtype, device=d.device))
        return d
    return torch.diag(x, offset)


@eager_op
def diagflat(x, offset=0):
    return torch.diagflat(x, offset)


@eager_op
def tril(x, diagonal=0):
    return torch.tril(x, diagonal)


@eager_op
def triu(x, diagonal=0):
    return torch.triu(x, diagonal)


def meshgrid(*args, **kwargs):
    arrs = args[0] if len(args) == 1 and isinstance(args[0], (list, tuple)) \
        else args
    return list(torch.meshgrid(*arrs, indexing="ij"))


@eager_op
def assign(x, output=None):
    if isinstance(x, torch.Tensor):
        return x.clone()
    return to_tensor(x)


@eager_op
def clone(x):
    return x.clone()


def tril_indices(row, col, offset=0, dtype="int64"):
    out = torch.tril_indices(int(row), int(col), int(offset), device=_dev())
    return out.to(_dtypes.to_torch(dtype))


def triu_indices(row, col=None, offset=0, dtype="int64"):
    out = torch.triu_indices(int(row), int(col or row), int(offset),
                             device=_dev())
    return out.to(_dtypes.to_torch(dtype))


@eager_op(name="complex")
def complex(real, imag):
    return torch.complex(real, imag)


@eager_op
def polar(abs, angle):
    return torch.complex(abs * torch.cos(angle), abs * torch.sin(angle))
