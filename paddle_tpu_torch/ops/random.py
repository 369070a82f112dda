"""Random ops (``paddle_tpu/ops/random.py``).

Calls draw from the port's per-device generators (``core/state.py``),
all seeded by :func:`seed`: an op given a shape draws on the default
device's generator (``device.set_device``), one given a tensor on that
tensor's device.  The functional forms (``*_p``) take the generator as
their key, as JAX's take a key.  Torch's Philox / MT streams never
equal JAX's threefry, and the CPU's stream differs from the card's:
what holds across packages is the distribution, and within one device
the sequence under a seed."""

from __future__ import annotations

import numpy as np
import torch

from paddle_tpu_torch.core import dtypes as _dtypes
from paddle_tpu_torch.core import state as _state

__all__ = ["seed", "get_rng_state", "set_rng_state", "uniform_p",
           "normal_p", "randint_p", "bernoulli_p", "rand", "randn",
           "standard_normal", "normal", "uniform", "randint", "randint_like",
           "randperm", "shuffle", "bernoulli", "poisson", "multinomial",
           "rand_like", "randn_like", "exponential_"]

seed = _state.seed
get_rng_state = _state.get_rng_state
set_rng_state = _state.set_rng_state


def _shape(shape):
    if isinstance(shape, torch.Tensor):
        return tuple(int(s) for s in shape.reshape(-1).tolist())
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    return tuple(int(s.item() if isinstance(s, torch.Tensor) else s)
                 for s in shape)


def _dt(dtype):
    if dtype is None:
        return _dtypes.to_torch(_state.get_default_dtype())
    return _dtypes.to_torch(dtype)


def _gen(device=None):
    dev = _state.resolve_device(device)
    return dev, _state.generator(dev)


# ---- functional (generator-explicit) forms ---------------------------------

def uniform_p(key, shape, dtype=torch.float32, min=-1.0, max=1.0):
    out = torch.empty(_shape(shape), dtype=_dtypes.to_torch(dtype),
                      device=key.device)
    return out.uniform_(min, max, generator=key)


def normal_p(key, shape, dtype=torch.float32, mean=0.0, std=1.0):
    return mean + std * torch.randn(_shape(shape), generator=key,
                                    dtype=_dtypes.to_torch(dtype),
                                    device=key.device)


def randint_p(key, low, high, shape, dtype=torch.int32):
    return torch.randint(int(low), int(high), _shape(shape), generator=key,
                         dtype=_dtypes.to_torch(dtype), device=key.device)


def bernoulli_p(key, p, shape, dtype=torch.float32):
    u = torch.rand(_shape(shape), generator=key, device=key.device)
    return (u < p).to(_dtypes.to_torch(dtype))


# ---- eager paddle-parity API -----------------------------------------------

def rand(shape, dtype=None, name=None):
    dev, g = _gen()
    return torch.rand(_shape(shape), generator=g, dtype=_dt(dtype),
                      device=dev)


def randn(shape, dtype=None, name=None):
    dev, g = _gen()
    return torch.randn(_shape(shape), generator=g, dtype=_dt(dtype),
                       device=dev)


def standard_normal(shape, dtype=None, name=None):
    return randn(shape, dtype)


def normal(mean=0.0, std=1.0, shape=None, name=None):
    if isinstance(mean, torch.Tensor) or isinstance(std, torch.Tensor) \
            or shape is None:
        like = mean if isinstance(mean, torch.Tensor) else std
        dev, g = _gen(like.device if isinstance(like, torch.Tensor)
                      else None)
        out_shape = torch.broadcast_shapes(
            tuple(np.shape(mean)) if not isinstance(mean, torch.Tensor)
            else mean.shape,
            tuple(np.shape(std)) if not isinstance(std, torch.Tensor)
            else std.shape)
        return mean + std * torch.randn(out_shape, generator=g,
                                        dtype=_dt(None), device=dev)
    dev, g = _gen()
    return mean + std * torch.randn(_shape(shape), generator=g,
                                    dtype=_dt(None), device=dev)


def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0, name=None):
    dev, g = _gen()
    out = torch.empty(_shape(shape), dtype=_dt(dtype), device=dev)
    return out.uniform_(min, max, generator=g)


def randint(low=0, high=None, shape=(1,), dtype=None, name=None):
    if high is None:
        low, high = 0, low
    dt = torch.int64 if dtype is None else _dtypes.to_torch(dtype)
    dev, g = _gen()
    return torch.randint(int(low), int(high), _shape(shape), generator=g,
                         dtype=dt, device=dev)


def randint_like(x, low=0, high=None, dtype=None, name=None):
    if high is None:
        low, high = 0, low
    dt = x.dtype if dtype is None else _dtypes.to_torch(dtype)
    _, g = _gen(x.device)
    out = torch.randint(int(low), int(high), tuple(x.shape), generator=g,
                        dtype=torch.int64, device=x.device)
    return out.to(dt)


def randperm(n, dtype="int64", name=None):
    dev, g = _gen()
    return torch.randperm(int(n), generator=g, device=dev).to(
        _dtypes.to_torch(dtype))


def shuffle(x, axis=0):
    _, g = _gen(x.device)
    perm = torch.randperm(x.shape[axis], generator=g, device=x.device)
    return torch.index_select(x, axis, perm)


def bernoulli(x, name=None):
    _, g = _gen(x.device)
    return torch.bernoulli(x, generator=g).to(x.dtype)


def poisson(x, name=None):
    _, g = _gen(x.device)
    return torch.poisson(x, generator=g).to(x.dtype)


def multinomial(x, num_samples=1, replacement=False, name=None):
    _, g = _gen(x.device)
    return torch.multinomial(x, num_samples, replacement=replacement,
                             generator=g)


def rand_like(x, dtype=None):
    dt = x.dtype if dtype is None else _dtypes.to_torch(dtype)
    _, g = _gen(x.device)
    return torch.rand(tuple(x.shape), generator=g, dtype=dt, device=x.device)


def randn_like(x, dtype=None, name=None):
    dt = x.dtype if dtype is None else _dtypes.to_torch(dtype)
    _, g = _gen(x.device)
    return torch.randn(tuple(x.shape), generator=g, dtype=dt,
                       device=x.device)


def exponential_(x, lam=1.0, name=None):
    """Fill x in place with Exp(lam) draws; returns x."""
    _, g = _gen(x.device)
    with torch.no_grad():
        x.exponential_(lam, generator=g)
    return x
