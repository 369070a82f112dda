"""Layer — the module base class, an ``nn.Module`` with the JAX
package's naming (``paddle_tpu/nn/layer.py``).

Sublayers registered with :meth:`Layer.add_sublayer` and attributes give
the same dotted state-dict names as the JAX package
(``model.layers_0.self_attn.q_proj.weight``), and weights keep its
``[in, out]`` layout, so a state dict moves between the two packages as
plain numpy arrays (:meth:`Layer.set_state_dict`)."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from paddle_tpu_torch.core import dtypes as _dtypes

__all__ = ["Layer"]


# ml_dtypes' types (what JAX's bf16 and fp8 arrays become under
# ``np.asarray``), which torch cannot read directly: their bits are
# reinterpreted through an integer view of the same width, not converted
_ML_DTYPES = {"bfloat16": (np.int16, torch.bfloat16),
              "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn)}
# stored types whose values are codes, not numbers: loaded bit for bit
_EXACT = (torch.int8, torch.float8_e4m3fn)


def _from_numpy(arr: np.ndarray) -> torch.Tensor:
    """numpy → CPU tensor, including ml_dtypes' bfloat16 and
    float8_e4m3fn."""
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:     # torch tensors may not alias read-only
        arr = arr.copy()
    if arr.dtype.name in _ML_DTYPES:
        view, dt = _ML_DTYPES[arr.dtype.name]
        return torch.from_numpy(arr.view(view)).view(dt)
    return torch.from_numpy(arr)


def _dtype_of(value) -> torch.dtype:
    """The torch dtype that ``value`` (a tensor or an array) would load
    as, without converting it."""
    if torch.is_tensor(value):
        return value.dtype
    dt = np.dtype(value.dtype) if hasattr(value, "dtype") else \
        np.asarray(value).dtype
    if dt.name in _ML_DTYPES:
        return _ML_DTYPES[dt.name][1]
    return torch.from_numpy(np.empty(0, dtype=dt)).dtype


class Layer(nn.Module):
    """Base of every layer of the port.

    ``dtype`` is the parameter dtype new parameters are created in and
    ``device`` where they live (CPU when not given: the models resolve
    their device once and hand it down).  Parameters are trainable
    (``requires_grad=True``); serving runs under ``torch.inference_mode``
    and builds no graph."""

    def __init__(self, dtype="float32", device=None):
        super().__init__()
        self._dtype = _dtypes.name_of(_dtypes.to_torch(dtype))
        self._device = torch.device("cpu" if device is None else device)

    # -- registration --------------------------------------------------------
    def add_sublayer(self, name: str, sublayer: "Layer") -> "Layer":
        self.add_module(name, sublayer)
        return sublayer

    def register_buffer(self, name: str, tensor, persistable: bool = True,
                        persistent=None):
        """``persistable=False`` keeps the buffer out of ``state_dict``
        (the RoPE tables), as in the JAX package.  ``persistent`` is
        torch's spelling of the same flag."""
        keep = persistable if persistent is None else persistent
        super().register_buffer(name, tensor, persistent=keep)
        return tensor

    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None):
        """A :class:`~paddle_tpu_torch.core.tensor.Parameter` of `shape`
        on the layer's device, resolved as in the JAX package
        (``nn/layer.py:120-139``): the explicit initializer, else
        ``attr.initializer``, else Xavier-normal for weights and zeros for
        biases.  `attr` is read duck-typed (any object with
        ``initializer``, ``learning_rate`` or ``trainable``; there is no
        ``ParamAttr`` class): ``learning_rate`` goes into
        ``optimize_attr``, ``trainable=False`` sets ``stop_gradient``."""
        from paddle_tpu_torch.core.tensor import Parameter
        from paddle_tpu_torch.nn import initializer as I
        init = default_initializer
        if init is None and attr is not None:
            init = getattr(attr, "initializer", None)
        if init is None:
            init = I.Constant(0.0) if is_bias else I.XavierNormal()
        p = Parameter(init(shape, dtype or self._dtype, self._device))
        if attr is not None and \
                getattr(attr, "learning_rate", None) is not None:
            p.optimize_attr["learning_rate"] = attr.learning_rate
        if attr is not None and getattr(attr, "trainable", True) is False:
            p.stop_gradient = True
            p.trainable = False
        return p

    def add_parameter(self, name: str, parameter):
        """Register `parameter` (a tensor is wrapped) under `name`."""
        from paddle_tpu_torch.core.tensor import Parameter
        if parameter is not None and \
                not isinstance(parameter, torch.nn.Parameter):
            parameter = Parameter(parameter)
        self.register_parameter(name, parameter)
        return parameter

    # -- parameters ----------------------------------------------------------
    def parameters(self, recurse: bool = True):
        """The parameters as a list (the JAX package's return type), in
        state-dict order: what an optimizer walks.  ``recurse`` is the
        JAX package's ``include_sublayers``, under torch's name, which
        torch's own callers pass."""
        return [p for _, p in self.named_parameters(recurse=recurse)]

    def clear_gradients(self):
        """Drop every parameter's gradient."""
        for p in self.parameters():
            p.grad = None

    # -- state ---------------------------------------------------------------
    def set_state_dict(self, state_dict: Dict[str, np.ndarray]):
        """Load ``{name: numpy array or tensor}`` (e.g. a JAX model's
        weights via ``np.asarray``).  Names must match this layer's state
        dict exactly and every shape must agree; anything else raises
        before a single value is written.  Values are converted to each
        parameter's dtype and copied in place on its device, except the
        quantized buffers (int8, ``float8_e4m3fn``): those take a value of
        their own dtype only and copy its bits."""
        own = self.state_dict(keep_vars=True)
        missing = sorted(set(own) - set(state_dict))
        unexpected = sorted(set(state_dict) - set(own))
        if missing or unexpected:
            raise ValueError(f"state dict mismatch: missing {missing}, "
                             f"unexpected {unexpected}")
        for name, t in own.items():
            value = state_dict[name]
            shape = tuple(np.shape(value))
            if shape != tuple(t.shape):
                raise ValueError(
                    f"shape mismatch for '{name}': checkpoint {shape} vs "
                    f"layer {tuple(t.shape)}")
            dt = _dtype_of(value)
            if t.dtype in _EXACT and dt != t.dtype:
                raise TypeError(
                    f"'{name}' holds {t.dtype} codes; the checkpoint's "
                    f"{dt} would be converted, not copied")
        # one value converted at a time: a read-only (JAX) array is copied
        # to the host by _from_numpy, and never more than one at once
        with torch.no_grad():
            for name, t in own.items():
                value = state_dict[name]
                src = value.detach() if torch.is_tensor(value) else \
                    _from_numpy(np.asarray(value))
                t.copy_(src.to(t.dtype))

    # -- dtype ---------------------------------------------------------------
    def astype(self, dtype) -> "Layer":
        """Cast every floating parameter and buffer to `dtype`, through
        each sublayer's own ``astype`` (so a sublayer can keep a buffer
        in its dtype)."""
        dt = _dtypes.to_torch(dtype)
        for child in self.children():
            if isinstance(child, Layer):
                child.astype(dt)
        with torch.no_grad():
            for store in (self._parameters, self._buffers):
                for t in store.values():
                    if t is not None and t.is_floating_point():
                        t.data = t.data.to(dt)
        self._dtype = _dtypes.name_of(dt)
        return self
