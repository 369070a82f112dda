"""AMP (``paddle_tpu/amp/__init__.py``; parity: python/paddle/amp/ —
``auto_cast``, ``decorate``, ``GradScaler``, the white and black lists).

The cast rides the op hook (``core/dispatch.py``): under
:func:`auto_cast` every op on the hook has its floating tensor
arguments cast by the op's name, with the JAX package's rules
(``:75-104``):

* O1: an op on the white list (or the custom white list) runs in the
  AMP dtype, one on the black list in fp32, any other as its inputs
  come;
* O2: every op but the black list runs in the AMP dtype.

Torch's ``autocast`` is not used: its lists and its O2 differ from
Paddle's.  :func:`decorate` at O2 casts the model (``Layer.astype``)
and sets the optimizers' ``_multi_precision``, so they keep fp32 master
weights.  :class:`GradScaler` is the JAX package's dynamic loss scaling
protocol; it unscales with one ``torch._foreach_mul_`` a device and
reads one found-inf flag on the host a step."""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

from paddle_tpu_torch.amp import debugging  # noqa: F401
from paddle_tpu_torch.core import dtypes as _dtypes
from paddle_tpu_torch.core.dispatch import AMP_STATE as _STATE

__all__ = ["auto_cast", "amp_guard", "decorate", "GradScaler",
           "is_auto_cast_enabled", "get_amp_dtype", "white_list",
           "black_list"]

# ops that benefit from low precision (tensor-core ops) — reference
# amp_lists.py
WHITE_LIST = frozenset({
    "matmul", "mm", "bmm", "linear", "conv1d", "conv2d", "conv3d",
    "conv1d_transpose", "conv2d_transpose", "conv3d_transpose", "einsum",
    "scaled_dot_product_attention", "flash_attention", "addmm",
})
# numerically sensitive ops forced to fp32
BLACK_LIST = frozenset({
    "exp", "log", "log2", "log10", "log1p", "pow", "square", "sqrt", "rsqrt",
    "softmax", "log_softmax", "cross_entropy", "softmax_with_cross_entropy",
    "mean", "sum", "logsumexp", "cumsum", "layer_norm", "batch_norm",
    "rms_norm", "group_norm", "instance_norm", "erf", "erfinv",
})


class _AmpState:
    __slots__ = ("enable", "dtype", "level", "custom_white", "custom_black")

    def __init__(self, enable, dtype, level, white, black):
        self.enable = enable
        self.dtype = dtype
        self.level = level
        self.custom_white = white
        self.custom_black = black


def is_auto_cast_enabled() -> bool:
    st = _STATE.get()
    return st is not None and st.enable


def get_amp_dtype() -> Optional[str]:
    st = _STATE.get()
    return st.dtype if st else None


def white_list():
    return WHITE_LIST


def black_list():
    return BLACK_LIST


def maybe_cast_args(op_name, flat_args):
    """Called from the hook: cast floating tensors per the active
    policy."""
    st = _STATE.get()
    if st is None or not st.enable:
        return flat_args
    target = _dtypes.to_torch(st.dtype)
    in_black = op_name in BLACK_LIST or op_name in st.custom_black
    if st.level == "O2":
        # O2: everything low-precision except the black list
        in_white = not in_black
    else:
        in_white = (op_name in WHITE_LIST or op_name in st.custom_white) and \
            not in_black
    if not in_white and not in_black:
        return flat_args
    to = target if in_white else torch.float32

    def cast(a):
        if isinstance(a, torch.Tensor) and a.is_floating_point():
            return a.to(to)
        return a

    return [cast(a) for a in flat_args]


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16", use_promote=True):
    st = _AmpState(enable, dtype, level,
                   frozenset(custom_white_list or ()),
                   frozenset(custom_black_list or ()))
    tok = _STATE.set(st)
    try:
        yield
    finally:
        _STATE.reset(tok)


amp_guard = auto_cast

_LOW = (torch.bfloat16, torch.float16)


def decorate(models, optimizers=None, level="O1", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """O2: cast the models' parameters to the AMP dtype and have the
    optimizers keep fp32 masters (``_multi_precision``).  An optimizer
    makes a parameter's state at its first update, master included; a
    state made before ``decorate`` gets its master here, from the cast
    parameter, as the first update would make it."""
    single = not isinstance(models, (list, tuple))
    model_list = [models] if single else list(models)
    if level == "O2":
        for m in model_list:
            m.astype(dtype)
    if optimizers is None:
        return models if single else model_list
    opt_list = [optimizers] if not isinstance(optimizers, (list, tuple)) \
        else list(optimizers)
    if level == "O2" and (master_weight is None or master_weight):
        for o in opt_list:
            o._multi_precision = True  # fp32 master weights (see Optimizer)
            for key, (_, p) in o._registered.items():
                st = o._accumulators.get(key)
                if st is not None and "_master" not in st and \
                        p.dtype in _LOW:
                    st["_master"] = p.detach().float()
    return (models if single else model_list), optimizers


class GradScaler:
    """Dynamic loss scaling (reference grad_scaler.py:577; the JAX
    package's protocol): scale the loss, unscale the gradients once a
    step, skip the step when any gradient is not finite, then back off
    (``decr_ratio`` after ``decr_every_n_nan_or_inf`` bad steps, never
    below 1) or grow (``incr_ratio`` after ``incr_every_n_steps`` good
    ones)."""

    def __init__(self, enable=True, init_loss_scaling=2.0 ** 15,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=2000,
                 decr_every_n_nan_or_inf=1, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling) if enable else 1.0
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        self._already_unscaled = False

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def get_loss_scaling(self):
        return self._scale

    def scale(self, loss):
        if not self._enable:
            return loss
        return loss * self._scale

    @torch.no_grad()
    def unscale_(self, optimizer):
        """Multiply every gradient by 1 / scale (one ``_foreach_mul_``
        a device and dtype) and read one found-inf flag: the inf-norms
        of the unscaled gradients, stacked, checked on the device.  A
        row-sparse gradient's values are unscaled in place (the JAX
        package's GradScaler fails on one: ROADMAP.md, queue 3)."""
        if not self._enable or self._already_unscaled:
            return
        inv = 1.0 / self._scale
        groups = {}
        for p in optimizer._parameters or []:
            g = p.grad
            if g is None:
                continue
            if g.layout == torch.sparse_coo:
                g = g._values()
            groups.setdefault((g.device, g.dtype), []).append(g)
        flags = []
        for grads in groups.values():
            torch._foreach_mul_(grads, inv)
            norms = torch._foreach_norm(grads, float("inf"))
            flags.append(torch.logical_not(
                torch.isfinite(torch.stack(norms))).any().reshape(1))
        found = False
        if flags:
            dev = flags[0].device
            found = bool(torch.cat([f.to(dev) for f in flags]).any())
        self._found_inf = found
        self._already_unscaled = True

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()
        self._update_scale()
        self._already_unscaled = False

    def update(self):
        pass  # paddle API parity; scale update happens in step()

    def minimize(self, optimizer, scaled_loss):
        scaled_loss.backward()
        self.step(optimizer)

    def _update_scale(self):
        if not self._dynamic:
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every:
                self._scale *= self._incr_ratio
                self._good_steps = 0

    def state_dict(self):
        return {"scale": self._scale, "incr_ratio": self._incr_ratio,
                "decr_ratio": self._decr_ratio,
                "good_steps": self._good_steps, "bad_steps": self._bad_steps}

    def load_state_dict(self, state):
        self._scale = state["scale"]
        self._good_steps = state.get("good_steps", 0)
        self._bad_steps = state.get("bad_steps", 0)
