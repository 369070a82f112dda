"""The op hook (``paddle_tpu/core/dispatch.py:91`` ``dispatch``, ``:177``
``eager_op``).

Every op of the port's surface (the generated ops, the hand-written op
modules and the ``nn.functional`` functions that the JAX package
decorates) is one function wrapped by :func:`eager_op`, under the JAX
package's op name.  Torch's autograd is the tape, so the wrapper does
only what the JAX chokepoint does besides the tape, in its order:

1. the AMP cast by op name (``amp.maybe_cast_args``) under
   ``amp.auto_cast``;
2. ``amp.debugging.record_op`` while operator stats are collected;
3. the call;
4. the NaN/Inf sweep of the outputs under ``FLAGS_check_nan_inf``
   (level 0 raises ``FloatingPointError``, any other level prints),
   skipped while a CUDA graph is capturing, as the JAX sweep never sees
   a traced value.

The fast path, with AMP off, stats off and the flag off, reads one
context variable (the AMP state) and one module flag (:data:`_watch`,
kept current by ``flags.on_change`` and the stats switch) before the
call.  Tensors that meet through a Python operator (``x + y``) do not
pass here: torch's operators are not the port's ops (the JAX package's
tensor dunders are, ROADMAP.md queue 3)."""

from __future__ import annotations

import contextvars
import functools
from typing import Callable

import torch
from torch.utils import _pytree

from paddle_tpu_torch import flags as _flags

__all__ = ["eager_op", "AMP_STATE"]

# the active auto_cast policy (amp._AmpState) or None
AMP_STATE: contextvars.ContextVar = contextvars.ContextVar(
    "amp_state", default=None)
_amp_get = AMP_STATE.get

_stats_on = False
_sweep_on = False
_watch = False


def _refresh():
    global _sweep_on, _watch
    _sweep_on = bool(_flags.get("check_nan_inf"))
    _watch = _stats_on or _sweep_on


def set_stats(on: bool):
    """Switch the operator stats' recording (``amp.debugging``)."""
    global _stats_on
    _stats_on = bool(on)
    _refresh()


_flags.on_change(_refresh)


def _capturing() -> bool:
    return torch.cuda.is_available() and \
        torch.cuda.is_current_stream_capturing()


def _check_nan_inf(op_name: str, out):
    """``FLAGS_check_nan_inf``'s sweep (``paddle_tpu/core/dispatch.py:
    66``): a host read per floating output, as the reference's blocking
    check."""
    if _capturing():
        return
    level = _flags.get("check_nan_inf_level")
    for leaf in _pytree.tree_leaves(out):
        if isinstance(leaf, torch.Tensor) and (
                leaf.is_floating_point() or leaf.is_complex()):
            bad = int(torch.logical_not(torch.isfinite(leaf)).sum())
            if bad:
                msg = (f"[check_nan_inf] op '{op_name}' produced {bad} "
                       f"non-finite values (shape {list(leaf.shape)}, "
                       f"dtype {str(leaf.dtype).replace('torch.', '')})")
                if level == 0:
                    raise FloatingPointError(msg)
                print(msg)


def _first_float_dtype(leaves):
    for a in leaves:
        if isinstance(a, torch.Tensor) and a.is_floating_point():
            return a.dtype
    return None


def _slow(f, op_name, st, args, kwargs):
    if st is not None and st.enable:
        from paddle_tpu_torch import amp as _amp
        leaves, spec = _pytree.tree_flatten((args, kwargs))
        leaves = _amp.maybe_cast_args(op_name, leaves)
        args, kwargs = _pytree.tree_unflatten(leaves, spec)
    if _stats_on:
        from paddle_tpu_torch.amp import debugging as _dbg
        _dbg.record_op(op_name, _first_float_dtype(
            _pytree.tree_leaves((args, kwargs))))
    out = f(*args, **kwargs)
    if _sweep_on:
        _check_nan_inf(op_name, out)
    return out


def eager_op(fn: Callable = None, *, name: str = None,
             factory: bool = False):
    """Decorator: put `fn` on the hook under ``name or fn.__name__``.
    A ``name=`` keyword of the op itself (Paddle's API) is swallowed.
    ``factory`` (JAX's mark of an op with no tensor input, whose outputs
    it wraps) changes nothing here: torch tensors are the port's."""

    def deco(f):
        opname = name or f.__name__

        @functools.wraps(f)
        def wrapper(*args, **kwargs):
            if kwargs:
                kwargs.pop("name", None)
            st = _amp_get()
            if st is None and not _watch:
                return f(*args, **kwargs)
            return _slow(f, opname, st, args, kwargs)

        wrapper.__wrapped_pure__ = f
        wrapper.__op_name__ = opname
        return wrapper

    if fn is not None:
        return deco(fn)
    return deco
