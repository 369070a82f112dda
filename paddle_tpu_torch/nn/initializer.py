"""Weight initializers (``paddle_tpu/nn/initializer.py``).

Each is a callable ``(shape, dtype, device) -> tensor``.  The random
ones draw from the device's global generator (``core.state.generator``)
in float32 and cast once, so a bf16 parameter rounds once; their numbers
are torch's, never JAX's (parity goes through copied weights), while
their fans, bounds, gains and scales are the JAX package's.  ``Assign``,
``Constant`` and ``Dirac`` are deterministic and equal JAX's exactly."""

from __future__ import annotations

import math

import numpy as np
import torch

from paddle_tpu_torch.core import dtypes as _dtypes
from paddle_tpu_torch.core import state as _state

__all__ = ["Constant", "Normal", "TruncatedNormal", "Uniform", "XavierNormal",
           "XavierUniform", "KaimingNormal", "KaimingUniform", "Assign",
           "Dirac", "Orthogonal", "calculate_gain"]


def _fans(shape):
    """(fan_in, fan_out), the JAX package's rule (``initializer.py:23-33``):
    a 2-D weight is ``[in, out]``; above two dimensions the conv layout
    ``[out, in, *rest]``, each fan times the product of the rest (so a
    stacked expert weight ``[E, d, h]`` has fans d*h and E*h)."""
    shape = tuple(shape)
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = math.prod(shape[2:])
    return shape[1] * receptive, shape[0] * receptive


def calculate_gain(nonlinearity, param=None):
    gains = {"sigmoid": 1.0, "linear": 1.0, "conv1d": 1.0, "conv2d": 1.0,
             "conv3d": 1.0, "tanh": 5.0 / 3.0, "relu": math.sqrt(2.0),
             "leaky_relu": math.sqrt(2.0 / (1 + (param or 0.01) ** 2)),
             "selu": 3.0 / 4.0}
    return gains[nonlinearity]


def _draw(shape, device, fn):
    """``fn(shape, generator)`` in fp32 on `device`."""
    return fn(tuple(shape), _state.generator(device))


class Initializer:
    def __call__(self, shape, dtype="float32", device="cpu"):
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, shape, dtype="float32", device="cpu"):
        return torch.full(tuple(shape), self.value,
                          dtype=_dtypes.to_torch(dtype), device=device)


class Assign(Initializer):
    """The given values (an array, a list or a tensor), reshaped."""

    def __init__(self, value):
        self.value = value

    def __call__(self, shape, dtype="float32", device="cpu"):
        v = self.value
        arr = v.detach().cpu() if torch.is_tensor(v) else \
            torch.from_numpy(np.array(v))
        return arr.to(_dtypes.to_torch(dtype)).reshape(tuple(shape)).to(
            device)


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype="float32", device="cpu"):
        x = _draw(shape, device, lambda s, g: torch.randn(
            s, dtype=torch.float32, device=device, generator=g))
        return (x * self.std + self.mean).to(_dtypes.to_torch(dtype))


class TruncatedNormal(Initializer):
    """``mean + std * z``, z standard normal truncated to ``[a, b]``."""

    def __init__(self, mean=0.0, std=1.0, a=-2.0, b=2.0):
        self.mean, self.std, self.a, self.b = mean, std, a, b

    def __call__(self, shape, dtype="float32", device="cpu"):
        z = torch.empty(tuple(shape), dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(z, 0.0, 1.0, self.a, self.b,
                                    generator=_state.generator(device))
        return (self.mean + self.std * z).to(_dtypes.to_torch(dtype))


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = low, high

    def __call__(self, shape, dtype="float32", device="cpu"):
        u = _draw(shape, device, lambda s, g: torch.rand(
            s, dtype=torch.float32, device=device, generator=g))
        return (u * (self.high - self.low) + self.low).to(
            _dtypes.to_torch(dtype))


class XavierNormal(Initializer):
    """std = gain * sqrt(2 / (fan_in + fan_out)); a 2-D weight is
    ``[in, out]``."""

    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype="float32", device="cpu"):
        fi, fo = _fans(shape)
        fi = self.fan_in or fi
        fo = self.fan_out or fo
        std = self.gain * math.sqrt(2.0 / (fi + fo))
        return Normal(0.0, std)(shape, dtype, device)


class XavierUniform(Initializer):
    """U(-limit, limit), limit = gain * sqrt(6 / (fan_in + fan_out))."""

    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype="float32", device="cpu"):
        fi, fo = _fans(shape)
        fi = self.fan_in or fi
        fo = self.fan_out or fo
        limit = self.gain * math.sqrt(6.0 / (fi + fo))
        return Uniform(-limit, limit)(shape, dtype, device)


class KaimingNormal(Initializer):
    """std = gain / sqrt(fan_in)."""

    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def __call__(self, shape, dtype="float32", device="cpu"):
        fi, _ = _fans(shape)
        fi = self.fan_in or fi
        gain = calculate_gain(self.nonlinearity, self.negative_slope)
        return Normal(0.0, gain / math.sqrt(fi))(shape, dtype, device)


class KaimingUniform(Initializer):
    """U(-limit, limit), limit = gain * sqrt(3 / fan_in)."""

    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def __call__(self, shape, dtype="float32", device="cpu"):
        fi, _ = _fans(shape)
        fi = self.fan_in or fi
        gain = calculate_gain(self.nonlinearity, self.negative_slope)
        limit = gain * math.sqrt(3.0 / fi)
        return Uniform(-limit, limit)(shape, dtype, device)


class Dirac(Initializer):
    """Ones at the centre tap of ``(i, i % in_c)`` for ``i < min(out_c,
    in_c * groups)`` of a ``[out_c, in_c, *spatial]`` kernel."""

    def __init__(self, groups=1):
        self.groups = groups

    def __call__(self, shape, dtype="float32", device="cpu"):
        arr = np.zeros(tuple(shape), np.float32)
        out_c, in_c = shape[0], shape[1]
        centers = [s // 2 for s in shape[2:]]
        for i in range(min(out_c, in_c * self.groups)):
            arr[(i, i % in_c) + tuple(centers)] = 1.0
        return torch.from_numpy(arr).to(device=device,
                                        dtype=_dtypes.to_torch(dtype))


class Orthogonal(Initializer):
    """``gain`` times ``jax.nn.initializers.orthogonal()``'s matrix: the
    last axis is the column axis; a ``[rows, prod(rest)]`` normal draw
    (transposed when it has more columns) through QR, the signs of R's
    diagonal taken into Q.  Columns are orthonormal when the last axis
    is the shorter, rows otherwise."""

    def __init__(self, gain=1.0):
        self.gain = gain

    def __call__(self, shape, dtype="float32", device="cpu"):
        shape = tuple(shape)
        n_rows = shape[-1]
        n_cols = math.prod(shape) // n_rows
        mshape = (n_rows, n_cols) if n_rows > n_cols else (n_cols, n_rows)
        a = _draw(mshape, device, lambda s, g: torch.randn(
            s, dtype=torch.float32, device=device, generator=g))
        q, r = torch.linalg.qr(a)
        q = q * torch.sign(torch.diagonal(r))
        if n_rows < n_cols:
            q = q.T
        q = q.reshape((n_rows,) + shape[:-1])
        q = torch.movedim(q, 0, -1)
        return (self.gain * q).to(_dtypes.to_torch(dtype))
