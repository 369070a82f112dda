"""``functional_call``: run a Layer with its parameters and buffers
replaced by given tensors (``paddle_tpu/core/functional.py:26-109``).

The JAX package swaps every parameter access for a traced value through
a context-local map; here ``torch.func.functional_call`` does the swap,
and a context variable carries only the substitution flag that the
layers read: a sparse embedding runs dense while a substitution is
active (:func:`substitution_active`), as it does under the JAX
package's ``functional_call``, so a functional gradient never meets a
row-sparse one.  ``TrainStep`` sets the flag around its body.

The functional RNG streams are explicit ``torch.Generator``s (JAX:
threefry keys folded with a counter): ``functional_call(..., rngs=
{"dropout": g})`` makes the dropouts inside draw from ``g`` instead of
the device's global generator; an int seeds one generator a device."""

from __future__ import annotations

import contextlib
import contextvars
from typing import Any, Dict, Optional

import torch

__all__ = ["functional_call", "params_of", "trainable_mask", "substitute",
           "substitution_active", "next_functional_generator"]

_SUBST: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "param_substitution", default=False)
_RNG: contextvars.ContextVar[Optional[dict]] = contextvars.ContextVar(
    "functional_rng", default=None)


def substitution_active() -> bool:
    return _SUBST.get()


@contextlib.contextmanager
def substitute(rngs: Optional[Dict[str, Any]] = None):
    """Mark a substitution active and install the functional RNG
    streams `rngs` for the block."""
    tok = _SUBST.set(True)
    tok2 = _RNG.set({k: {"src": v} for k, v in (rngs or {}).items()})
    try:
        yield
    finally:
        _SUBST.reset(tok)
        _RNG.reset(tok2)


def next_functional_generator(stream: str = "dropout", device="cpu"):
    """The generator of `stream` on `device` inside a functional call
    with ``rngs``, else None (the caller takes the global one).  A
    stream given as an int gets one generator a device, seeded by it."""
    st = _RNG.get()
    if not st or stream not in st:
        return None
    entry = st[stream]
    src = entry["src"]
    if isinstance(src, torch.Generator):
        return src
    key = str(torch.device(device))
    gen = entry.get(key)
    if gen is None:
        gen = entry[key] = torch.Generator(device=device)
        gen.manual_seed(int(src))
    return gen


def functional_call(layer, params_and_buffers: Dict[str, Any], *args,
                    rngs: Optional[Dict[str, Any]] = None,
                    method: Optional[str] = None, **kwargs):
    """Call `layer` (or its bound `method`, e.g. ``"loss"``) with the
    parameters and buffers named in `params_and_buffers` (state-dict
    names, tensors) in place of its own; the others stay the layer's.
    An unknown name raises ``KeyError``, as in the JAX package."""
    state = layer.state_dict(keep_vars=True)
    own = dict(layer.named_parameters())
    own.update(layer.named_buffers())
    values = {}
    for name, value in params_and_buffers.items():
        if name not in state and name not in own:
            raise KeyError(f"unknown parameter/buffer '{name}' for "
                           f"{type(layer).__name__}")
        if not torch.is_tensor(value):
            orig = own.get(name, state.get(name))
            value = torch.as_tensor(value, device=orig.device)
        values[name] = value
    with substitute(rngs):
        if method is None:
            return torch.func.functional_call(layer, values, args, kwargs,
                                              strict=False)
        # a bound method other than forward: swap the tensors in the
        # module tree for the call, as functional_call does for forward
        with torch.nn.utils.stateless._reparametrize_module(layer, values):
            return getattr(layer, method)(*args, **kwargs)


def params_of(layer, dtype=None) -> Dict[str, torch.Tensor]:
    """``{state-dict name: tensor}`` of every parameter and buffer
    (detached); floating ones cast to `dtype` where given."""
    from paddle_tpu_torch.core import dtypes as _dtypes
    dt = None if dtype is None else _dtypes.to_torch(dtype)
    out = {}
    for name, t in layer.state_dict(keep_vars=True).items():
        t = t.detach()
        if dt is not None and t.is_floating_point():
            t = t.to(dt)
        out[name] = t
    return out


def trainable_mask(layer) -> Dict[str, bool]:
    """``{name: bool}``: True for a trainable parameter (not a buffer,
    not ``stop_gradient``)."""
    params = {id(p) for p in layer.parameters()}
    return {name: id(t) in params and t.requires_grad
            for name, t in layer.state_dict(keep_vars=True).items()}
