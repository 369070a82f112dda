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


def _from_numpy(arr: np.ndarray) -> torch.Tensor:
    """numpy → CPU tensor, including ml_dtypes' bfloat16 (what a JAX
    bf16 array becomes under ``np.asarray``), which torch cannot read
    directly: its bits are reinterpreted, not converted."""
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:     # torch tensors may not alias read-only
        arr = arr.copy()
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


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

    def create_parameter(self, shape, dtype=None, is_bias=False,
                         default_initializer=None) -> nn.Parameter:
        """Explicit initializer, else Xavier-normal for weights and zeros
        for biases (the JAX package's resolution order)."""
        from paddle_tpu_torch.nn import initializer as I
        init = default_initializer
        if init is None:
            init = I.Constant(0.0) if is_bias else I.XavierNormal()
        data = init(shape, dtype or self._dtype, self._device)
        return nn.Parameter(data, requires_grad=True)

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
        """Load ``{name: numpy array}`` (e.g. a JAX model's weights via
        ``np.asarray``).  Names must match this layer's state dict
        exactly and every shape must agree; anything else raises before
        a single value is written.  Values are converted to each
        parameter's dtype and copied in place on its device."""
        own = self.state_dict(keep_vars=True)
        missing = sorted(set(own) - set(state_dict))
        unexpected = sorted(set(state_dict) - set(own))
        if missing or unexpected:
            raise ValueError(f"state dict mismatch: missing {missing}, "
                             f"unexpected {unexpected}")
        for name, t in own.items():
            shape = tuple(np.shape(state_dict[name]))
            if shape != tuple(t.shape):
                raise ValueError(
                    f"shape mismatch for '{name}': checkpoint {shape} vs "
                    f"layer {tuple(t.shape)}")
        with torch.no_grad():
            for name, t in own.items():
                src = _from_numpy(np.asarray(state_dict[name]))
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
