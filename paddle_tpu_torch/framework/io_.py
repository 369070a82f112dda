"""``paddle.save`` / ``paddle.load`` (``paddle_tpu/framework/io_.py``):
the JAX package's file, written and read by the port.

A file is the magic ``PDTPU001`` and then a pickle (protocol 4 by
default) of nested dicts, lists and tuples in which a ``Parameter``
becomes ``{"__paddle_tpu_param__": True, "data", "trainable", "name"}``
and any other tensor ``{"__paddle_tpu_tensor__": True, "data",
"stop_gradient", "name"}``, ``data`` a numpy array.  A file without the
magic is read as a plain pickle.

bfloat16 and float8 have no numpy dtype without ``ml_dtypes``, which the
card's machine does not have.  ``save`` writes such a tensor as the
pickle of an ``ml_dtypes`` array (``numpy.dtype(ml_dtypes.bfloat16)``,
reached through ``importlib.import_module("ml_dtypes")``, over the raw
bits), so the JAX package's ``load`` returns an ``ml_dtypes`` array of
the same bits, without the port importing ``ml_dtypes``.  ``load`` reads
such arrays, the JAX package's included, through an unpickler that
rebuilds them from their bits: a tagged one becomes a tensor of that
dtype; an untagged one (a JAX ``TrainStep`` state, say) an ``ml_dtypes``
array where ``ml_dtypes`` imports, else a CPU tensor (the convention of
``optimizer.to_numpy``).

``load`` returns tensors on ``device`` (the port's device rule: ``cuda``
unless the caller passes another or called ``set_device("cpu")``), a
``Parameter`` with its ``trainable`` and ``name``, a tensor with
``requires_grad = not stop_gradient`` (floating tensors only; its name is
not kept: torch's ``Tensor.name`` cannot be written); ``return_numpy=True`` returns every tagged array as numpy
(bfloat16 / float8 as ``ml_dtypes`` arrays, or CPU tensors without
``ml_dtypes``)."""

from __future__ import annotations

import importlib
import os
import pickle
from typing import Any

import numpy as np
import torch

from paddle_tpu_torch.core import state as _state
from paddle_tpu_torch.core.tensor import Parameter

__all__ = ["save", "load"]

_MAGIC = b"PDTPU001"

# ml_dtypes' floats: torch dtype, numpy view of the bits, the state numpy
# gives their dtype's pickle (np.dtype(t).__reduce__()[2])
_ML = {"bfloat16": (torch.bfloat16, np.int16,
                    (3, "<", None, None, None, 2, 2, 64)),
       "float8_e4m3fn": (torch.float8_e4m3fn, np.uint8,
                         (3, "<", None, None, None, 1, 1, 64)),
       "float8_e5m2": (torch.float8_e5m2, np.uint8,
                       (3, "<", None, None, None, 1, 1, 64))}
_ML_OF_TORCH = {v[0]: k for k, v in _ML.items()}


# -- writing ------------------------------------------------------------------

class _Reduce:
    """Pickles as ``fn(*args)`` (then ``__setstate__(state)`` when given):
    how an object of a module this one does not import is written."""

    def __init__(self, fn, args, state=None):
        self.fn, self.args, self.state = fn, args, state

    def __reduce__(self):
        if self.state is None:
            return self.fn, self.args
        return self.fn, self.args, self.state


def _ml_array(t: torch.Tensor):
    """A bfloat16 / float8 tensor's bits, pickled as the ``ml_dtypes``
    numpy array numpy itself would write: ``numpy.dtype(ml_dtypes.<name>)``
    reached through ``importlib.import_module`` over the raw bytes."""
    name = _ML_OF_TORCH[t.dtype]
    bits = t.detach().to("cpu").contiguous().view(
        torch.int16 if t.element_size() == 2 else torch.uint8)
    scalar = _Reduce(getattr, (_Reduce(importlib.import_module,
                                       ("ml_dtypes",)), name))
    dtype = _Reduce(np.dtype, (scalar, False, True), _ML[name][2])
    fn, args = np.ndarray((0,), np.int8).__reduce__()[:2]   # _reconstruct
    return _Reduce(fn, args, (1, tuple(t.shape), dtype, False,
                              bits.numpy().tobytes()))


def _data(t: torch.Tensor):
    if t.dtype in _ML_OF_TORCH:
        return _ml_array(t)
    return t.detach().to("cpu", copy=True).numpy()


def _to_storable(obj):
    if isinstance(obj, torch.nn.Parameter):
        return {"__paddle_tpu_param__": True, "data": _data(obj),
                "trainable": bool(getattr(obj, "trainable",
                                          obj.requires_grad)),
                "name": getattr(obj, "name", None)}
    if torch.is_tensor(obj):
        return {"__paddle_tpu_tensor__": True, "data": _data(obj),
                "stop_gradient": not obj.requires_grad,
                "name": getattr(obj, "name", None)}
    if isinstance(obj, dict):
        return {k: _to_storable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_storable(v) for v in obj)
    return obj


def save(obj: Any, path: str, protocol: int = 4, **configs):
    """Write `obj` (nested dicts / lists / tuples of tensors, numpy
    arrays and picklable values) to `path` in the JAX package's format;
    parent directories are made."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        f.write(_MAGIC)
        pickle.dump(_to_storable(obj), f, protocol=protocol)


# -- reading ------------------------------------------------------------------

class _MLScalar:
    """Stands for ``ml_dtypes.<name>`` in a pickle."""

    def __init__(self, name):
        self.name = name


class _MLModule:
    def __getattr__(self, name):
        if name in _ML:
            return _MLScalar(name)
        raise AttributeError(name)


class _MLDtype:
    """Stands for ``numpy.dtype(ml_dtypes.<name>)`` (its pickled state is
    ignored)."""

    def __init__(self, name):
        self.name = name

    def __setstate__(self, state):
        pass


def _dtype(obj, align=False, copy=True):
    if isinstance(obj, _MLScalar):
        return _MLDtype(obj.name)
    return np.dtype(obj, align, copy)


def _import_module(name):
    if name == "ml_dtypes":
        return _MLModule()
    return importlib.import_module(name)


class _Loaded(np.ndarray):
    """An array as the pickle rebuilds it; one of an ``ml_dtypes`` dtype
    holds its bits (``ml`` names the dtype)."""

    ml = None

    def __setstate__(self, state):
        version, shape, dtype, fortran, raw = state
        if isinstance(dtype, _MLDtype):
            self.ml = dtype.name
            dtype = np.dtype(_ML[dtype.name][1])
        super().__setstate__((version, shape, dtype, fortran, raw))


def _reconstruct(subtype, shape, typecode):
    return np.ndarray.__new__(_Loaded, shape, np.dtype(typecode))


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module == "ml_dtypes" and name in _ML:
            return _MLScalar(name)
        if (module, name) == ("importlib", "import_module"):
            return _import_module
        if (module, name) == ("numpy", "dtype"):
            return _dtype
        if module in ("numpy.core.multiarray", "numpy._core.multiarray") \
                and name == "_reconstruct":
            return _reconstruct
        return super().find_class(module, name)


def _ml_value(arr: "_Loaded"):
    """An ``ml_dtypes`` array's bits as a CPU tensor of its dtype."""
    dt, view, _ = _ML[arr.ml]
    return torch.from_numpy(np.array(arr.view(np.ndarray).view(view))) \
        .view(dt)


def _plain(arr):
    """A loaded array outside a tag: numpy, or an ``ml_dtypes`` one as
    ``ml_dtypes`` gives it (a CPU tensor where it is missing)."""
    if not isinstance(arr, _Loaded):
        return arr
    if arr.ml is None:
        return arr.view(np.ndarray)
    try:
        ml = importlib.import_module("ml_dtypes")
    except ImportError:
        return _ml_value(arr)
    return arr.view(np.ndarray).view(getattr(ml, arr.ml))


def _tensor(arr, device):
    if isinstance(arr, _Loaded) and arr.ml is not None:
        return _ml_value(arr).to(device)
    arr = np.asarray(arr)
    return torch.from_numpy(np.array(arr)).to(device)


def _from_storable(obj, return_numpy, device):
    if isinstance(obj, dict):
        if obj.get("__paddle_tpu_param__"):
            if return_numpy:
                return _plain(obj["data"])
            return Parameter(_tensor(obj["data"], device),
                             trainable=obj["trainable"], name=obj["name"])
        if obj.get("__paddle_tpu_tensor__"):
            if return_numpy:
                return _plain(obj["data"])
            t = _tensor(obj["data"], device)
            if t.is_floating_point() and not obj["stop_gradient"]:
                t.requires_grad_(True)
            return t
        return {k: _from_storable(v, return_numpy, device)
                for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_from_storable(v, return_numpy, device)
                         for v in obj)
    return _plain(obj)


def load(path: str, return_numpy: bool = False, device=None, **configs):
    """Read a file of :func:`save` or of the JAX package's ``save``."""
    with open(path, "rb") as f:
        if f.read(len(_MAGIC)) != _MAGIC:
            f.seek(0)
        obj = _Unpickler(f).load()
    dev = None if return_numpy else _state.resolve_device(device)
    return _from_storable(obj, return_numpy, dev)
