"""The port's ``paddle_tpu.static.nn`` (``paddle_tpu/static/nn.py``):
the static-graph layer-builder API.

Reference parity: ``paddle.static.nn`` (python/paddle/static/nn/common.py
— ``fc`` / ``conv2d`` / ``batch_norm`` / ... that create parameters
inside the ambient default main Program).  As in the JAX package:

* the "Program" is a PARAMETER SCOPE — a name -> Parameter store plus an
  auto-name counter (paddle's ``unique_name`` generator);
* ``program_guard()`` resets the counter while reusing the store, so
  re-executing the same builder code resolves to the SAME parameters —
  how the reference builds the program once and executes it many times;
* execution is ordinary eager evaluation (or a ``torch.export`` trace).

A parameter is created on its input's device, by the same initializer
objects ``Layer.create_parameter`` uses (the device's seeded stream).
"""

from __future__ import annotations

from collections import defaultdict
from contextlib import contextmanager
from typing import Optional

import torch

__all__ = ["fc", "embedding", "conv2d", "batch_norm", "layer_norm",
           "program_guard", "reset_program", "parameters"]

# the "default main program": parameter store + per-prefix name counters
_PARAMS: dict = {}
_COUNTERS: defaultdict = defaultdict(int)


def reset_program():
    """Drop all builder-created parameters (a fresh default Program)."""
    _PARAMS.clear()
    _COUNTERS.clear()


@contextmanager
def program_guard():
    """Reference ``static.program_guard``: while active, auto-generated
    parameter names restart from the same sequence, so the same builder
    code resolves to the same parameters on every execution."""
    saved = dict(_COUNTERS)
    _COUNTERS.clear()
    try:
        yield
    finally:
        _COUNTERS.clear()
        _COUNTERS.update(saved)


def _auto_name(prefix: str) -> str:
    n = _COUNTERS[prefix]
    _COUNTERS[prefix] += 1
    return f"{prefix}_{n}"


def _get_param(name: str, shape, initializer, device, dtype="float32"):
    """Create-or-fetch from the program scope."""
    p = _PARAMS.get(name)
    if p is not None:
        if list(p.shape) != list(shape):
            raise ValueError(
                f"static.nn parameter '{name}' exists with shape "
                f"{list(p.shape)}, requested {shape} — same name must mean "
                "same parameter")
        return p
    from paddle_tpu_torch.core.tensor import Parameter
    p = Parameter(initializer(tuple(shape), dtype, device))
    p.name = name
    _PARAMS[name] = p
    return p


def _xavier():
    from paddle_tpu_torch.nn.initializer import XavierUniform
    return XavierUniform()


def _zeros():
    from paddle_tpu_torch.nn.initializer import Constant
    return Constant(0.0)


def _ones():
    from paddle_tpu_torch.nn.initializer import Constant
    return Constant(1.0)


def _normal():
    from paddle_tpu_torch.nn.initializer import Normal
    return Normal(0.0, 1.0)


def _as_tensorish(x, what: str):
    """Builders take tensors / arrays; an InputSpec from static.data is a
    DECLARATION — say how the two compose here."""
    from paddle_tpu_torch.jit.save_load import InputSpec
    if isinstance(x, InputSpec):
        raise TypeError(
            f"static.nn.{what} received an InputSpec. The graph is "
            "captured by running real values: wrap your builder code in a "
            "function run under paddle_tpu_torch.jit.to_static (or a Layer "
            "exported by jit.save), passing the InputSpec there, or call "
            "the builder with a tensor.")
    return x if torch.is_tensor(x) else torch.as_tensor(x)


def parameters():
    """All parameters created by the builders (pass to an Optimizer)."""
    return list(_PARAMS.values())


def fc(x, size: int, num_flatten_dims: int = 1,
       activation: Optional[str] = None, name: Optional[str] = None):
    """Reference ``static.nn.fc`` (common.py): flatten trailing dims,
    affine, optional activation."""
    from paddle_tpu_torch.nn import functional as F
    x = _as_tensorish(x, "fc")
    name = name or _auto_name("fc")
    in_dim = 1
    for d in x.shape[num_flatten_dims:]:
        in_dim *= int(d)
    w = _get_param(f"{name}.w", [in_dim, size], _xavier(), x.device)
    b = _get_param(f"{name}.b", [size], _zeros(), x.device)
    lead = list(x.shape[:num_flatten_dims])
    out = x.reshape(lead + [in_dim]) @ w + b
    if activation is not None:
        out = getattr(F, activation)(out)
    return out


def embedding(input, size, padding_idx: Optional[int] = None,
              sparse: bool = False, name: Optional[str] = None):
    """Reference ``static.nn.embedding``: size = [vocab, dim]."""
    from paddle_tpu_torch.nn import functional as F
    input = _as_tensorish(input, "embedding")
    name = name or _auto_name("embedding")
    w = _get_param(f"{name}.w", list(size), _normal(), input.device)
    return F.embedding(input, w, padding_idx=padding_idx, sparse=sparse)


def conv2d(input, num_filters: int, filter_size, stride=1, padding=0,
           groups: int = 1, activation: Optional[str] = None,
           name: Optional[str] = None):
    """Reference ``static.nn.conv2d`` (NCHW)."""
    from paddle_tpu_torch.nn import functional as F
    input = _as_tensorish(input, "conv2d")
    if isinstance(filter_size, int):
        filter_size = (filter_size, filter_size)
    name = name or _auto_name("conv2d")
    cin = int(input.shape[1])
    w = _get_param(f"{name}.w", [num_filters, cin // groups, *filter_size],
                   _xavier(), input.device)
    b = _get_param(f"{name}.b", [num_filters], _zeros(), input.device)
    out = F.conv2d(input, w, bias=b, stride=stride, padding=padding,
                   groups=groups)
    if activation is not None:
        out = getattr(F, activation)(out)
    return out


def batch_norm(input, epsilon: float = 1e-5, momentum: float = 0.9,
               is_test: bool = False, name: Optional[str] = None):
    """Reference ``static.nn.batch_norm``.  Running statistics live in the
    program scope like parameters (the reference stores them as
    non-trainable program vars); training mode updates them in place,
    as ``nn.BatchNorm`` does, except under a functional call."""
    from paddle_tpu_torch.core import functional as _cfunc
    from paddle_tpu_torch.nn import functional as F
    input = _as_tensorish(input, "batch_norm")
    name = name or _auto_name("batch_norm")
    c = int(input.shape[1])
    dev = input.device
    scale = _get_param(f"{name}.scale", [c], _ones(), dev)
    bias = _get_param(f"{name}.bias", [c], _zeros(), dev)
    mean = _get_param(f"{name}.mean", [c], _zeros(), dev)
    var = _get_param(f"{name}.var", [c], _ones(), dev)
    mean.stop_gradient = True
    var.stop_gradient = True
    out = F.batch_norm(input, mean, var, weight=scale, bias=bias,
                       training=not is_test, momentum=momentum,
                       epsilon=epsilon)
    if not is_test and not _cfunc.substitution_active():
        with torch.no_grad():
            bm, bv = F.batch_norm_stats(input.detach())
            mean.copy_(momentum * mean + (1 - momentum) * bm)
            var.copy_(momentum * var + (1 - momentum) * bv)
    return out


def layer_norm(input, begin_norm_axis: int = 1, epsilon: float = 1e-5,
               name: Optional[str] = None):
    """Reference ``static.nn.layer_norm``: normalize over dims
    [begin_norm_axis:]."""
    from paddle_tpu_torch.nn import functional as F
    input = _as_tensorish(input, "layer_norm")
    name = name or _auto_name("layer_norm")
    shape = [int(d) for d in input.shape[begin_norm_axis:]]
    scale = _get_param(f"{name}.scale", shape, _ones(), input.device)
    bias = _get_param(f"{name}.bias", shape, _zeros(), input.device)
    return F.layer_norm(input, normalized_shape=shape, weight=scale,
                        bias=bias, epsilon=epsilon)
