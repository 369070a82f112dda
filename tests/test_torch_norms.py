"""The conv-side norms of the port against the JAX package's on the CPU:
``batch_norm`` (training and running statistics, NC... and N...C, 2-d
inputs), ``batch_norm_stats``, ``instance_norm``, ``group_norm``,
``local_response_norm``; the layers' state-dict names, the running-
statistics update and its momentum convention over several steps,
``use_global_stats``, eval mode, ``SyncBatchNorm`` in one process and its
conversion, ``SpectralNorm``; and gradients through BatchNorm2D.  fp32;
the statistics sum in another order than XLA's: 1e-5 relative with
1e-5 absolute."""

import numpy as np
import pytest
import torch

import paddle_tpu as pp
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF

import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.nn.functional as TF
from paddle_tpu_torch.core import functional as TFC

TOL = 1e-5


def _r(shape, seed=0, scale=1.0, shift=0.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale +
            shift).astype(np.float32)


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else x.numpy()


def _close(t, j, rtol=TOL, atol=TOL):
    assert tuple(t.shape) == tuple(j.shape)
    np.testing.assert_allclose(_np(t), _np(j), rtol=rtol, atol=atol)


def _both(fn, arrays, **kw):
    j = getattr(JF, fn)(*[None if a is None else pp.to_tensor(a)
                          for a in arrays], **kw)
    t = getattr(TF, fn)(*[None if a is None else torch.from_numpy(a)
                          for a in arrays], **kw)
    return j, t


@pytest.mark.parametrize("xs,fmt,training,affine", [
    ((4, 3, 5, 6), "NCHW", True, True),
    ((4, 3, 5, 6), "NCHW", False, True),
    ((4, 5, 6, 3), "NHWC", True, True),
    ((4, 3, 7), "NCL", True, False),
    ((6, 3), "NCHW", True, True),
    ((2, 3, 4, 4, 4), "NCDHW", False, False),
])
def test_batch_norm_matches_jax(xs, fmt, training, affine):
    c = xs[1] if fmt.startswith("NC") else xs[-1]
    x = _r(xs, 1, 3.0, 1.0)
    mean, var = _r((c,), 2), np.abs(_r((c,), 3)) + 0.5
    w, b = (_r((c,), 4), _r((c,), 5)) if affine else (None, None)
    j, t = _both("batch_norm", [x, mean, var, w, b], training=training,
                 epsilon=1e-5, data_format=fmt)
    _close(t, j)


def test_batch_norm_bf16_keeps_the_jax_cast_point():
    """A bf16 input takes JAX's operations: the normalised activations
    cast to bf16, then the fp32 weight and bias (fp32 out, as JAX's
    promotion gives)."""
    x = _r((4, 3, 5, 5), 6)
    w, b = _r((3,), 7), _r((3,), 8)
    jx = pp.to_tensor(x).astype("bfloat16")
    tx = torch.from_numpy(x).to(torch.bfloat16)
    j = JF.batch_norm(jx, pp.zeros([3]), pp.ones([3]), pp.to_tensor(w),
                      pp.to_tensor(b), training=True)
    t = TF.batch_norm(tx, torch.zeros(3), torch.ones(3), torch.from_numpy(w),
                      torch.from_numpy(b), training=True)
    assert t.dtype == torch.float32
    np.testing.assert_allclose(t.numpy(), np.asarray(j.astype("float32")
                                                     .numpy()),
                               rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("fmt,xs", [("NCHW", (4, 3, 5, 6)),
                                    ("NHWC", (4, 5, 6, 3))])
def test_batch_norm_stats_match_jax(fmt, xs):
    x = _r(xs, 9, 2.0, -1.0)
    (jm, jv), (tm, tv) = JF.batch_norm_stats(pp.to_tensor(x), fmt), \
        TF.batch_norm_stats(torch.from_numpy(x), fmt)
    _close(tm, jm)
    _close(tv, jv)


@pytest.mark.parametrize("fmt,xs", [("NCHW", (2, 3, 5, 6)),
                                    ("NHWC", (2, 5, 6, 3)),
                                    ("NCHW", (2, 3, 7))])
def test_instance_norm_matches_jax(fmt, xs):
    c = xs[1] if fmt == "NCHW" else xs[-1]
    x, w, b = _r(xs, 10, 2.0), _r((c,), 11), _r((c,), 12)
    j, t = _both("instance_norm", [x, None, None, w, b], eps=1e-5,
                 data_format=fmt)
    _close(t, j)


@pytest.mark.parametrize("fmt,xs,g", [("NCHW", (2, 6, 4, 5), 3),
                                      ("NHWC", (2, 4, 5, 6), 2),
                                      ("NCHW", (3, 8), 4)])
def test_group_norm_matches_jax(fmt, xs, g):
    c = xs[1] if fmt == "NCHW" else xs[-1]
    x, w, b = _r(xs, 13, 2.0), _r((c,), 14), _r((c,), 15)
    j = JF.group_norm(pp.to_tensor(x), g, 1e-5, pp.to_tensor(w),
                      pp.to_tensor(b), fmt)
    t = TF.group_norm(torch.from_numpy(x), g, 1e-5, torch.from_numpy(w),
                      torch.from_numpy(b), fmt)
    _close(t, j)


@pytest.mark.parametrize("fmt,xs,size", [("NCHW", (2, 7, 4, 5), 5),
                                         ("NHWC", (2, 4, 5, 6), 3),
                                         ("NCHW", (2, 4, 3, 3), 4)])
def test_local_response_norm_matches_jax(fmt, xs, size):
    x = _r(xs, 16, 2.0)
    j, t = _both("local_response_norm", [x], size=size, alpha=1e-3,
                 beta=0.75, k=2.0, data_format=fmt)
    _close(t, j)


def _bn_pair(cls, c, **kw):
    pp.seed(0)
    jl = getattr(jnn, cls)(c, **kw)
    tl = getattr(tnn, cls)(c, **kw)
    state = {k: v.numpy() for k, v in jl.state_dict().items()}
    tl.set_state_dict(state)
    return jl, tl, state


@pytest.mark.parametrize("cls,xs,kw", [
    ("BatchNorm2D", (4, 3, 5, 5), {}),
    ("BatchNorm2D", (4, 3, 5, 5), {"momentum": 0.5}),
    ("BatchNorm1D", (8, 3), {}),
    ("BatchNorm1D", (4, 3, 6), {}),
    ("BatchNorm3D", (2, 3, 3, 4, 4), {"epsilon": 1e-3}),
    ("BatchNorm", (4, 3, 5, 5), {}),
    ("BatchNorm2D", (4, 5, 5, 3), {"data_format": "NHWC"}),
    ("SyncBatchNorm", (4, 3, 5, 5), {}),
])
def test_batch_norm_layer_running_stats_match_jax(cls, xs, kw):
    """Names (weight, bias, _mean, _variance), three training steps'
    outputs and running statistics, then eval's output."""
    c = xs[1] if kw.get("data_format", "NC").startswith("NC") else xs[-1]
    jl, tl, state = _bn_pair(cls, c, **kw)
    assert list(tl.state_dict()) == list(state) == \
        ["weight", "bias", "_mean", "_variance"]
    for step in range(3):
        x = _r(xs, 20 + step, 2.0, 0.5 * step)
        _close(tl(torch.from_numpy(x)), jl(pp.to_tensor(x)))
        _close(tl._mean, jl._mean)
        _close(tl._variance, jl._variance)
    jl.eval()
    tl.eval()
    x = _r(xs, 30)
    _close(tl(torch.from_numpy(x)), jl(pp.to_tensor(x)))


def test_batch_norm_use_global_stats_and_functional_call():
    """``use_global_stats`` normalises with the running statistics and
    leaves them alone; so does a functional call (the substitution
    flag), as the JAX package's does under functional_call."""
    jl, tl, _ = _bn_pair("BatchNorm2D", 3, use_global_stats=True)
    x = _r((4, 3, 5, 5), 31, 2.0, 1.0)
    _close(tl(torch.from_numpy(x)), jl(pp.to_tensor(x)))
    assert not tl._mean.any()
    _, tl2, _ = _bn_pair("BatchNorm2D", 3)
    TFC.functional_call(tl2, {}, torch.from_numpy(x))
    assert not tl2._mean.any() and torch.equal(tl2._variance,
                                               torch.ones(3))


def test_batch_norm_grads_match_jax():
    jl, tl, _ = _bn_pair("BatchNorm2D", 3)
    x = _r((4, 3, 5, 5), 32, 2.0)
    jx = pp.to_tensor(x, stop_gradient=False)
    tx = torch.tensor(x, requires_grad=True)
    g = _r((4, 3, 5, 5), 33)
    (jl(jx) * pp.to_tensor(g)).sum().backward()
    (tl(tx) * torch.from_numpy(g)).sum().backward()
    _close(tx.grad, jx.grad, atol=1e-5)
    _close(tl.weight.grad, jl.weight.grad, atol=1e-5)
    _close(tl.bias.grad, jl.bias.grad, atol=1e-5)


def test_convert_sync_batchnorm():
    seq = tnn.Sequential(tnn.Conv2D(3, 4, 3), tnn.BatchNorm2D(4))
    with torch.no_grad():
        seq[1]._mean.fill_(0.25)
        seq[1].weight.fill_(2.0)
    out = tnn.SyncBatchNorm.convert_sync_batchnorm(seq)
    assert isinstance(out[1], tnn.SyncBatchNorm)
    assert float(out[1]._mean[0]) == 0.25 and float(out[1].weight[0]) == 2.0
    assert list(out.state_dict()) == list(seq.state_dict())


@pytest.mark.parametrize("cls,args,xs", [
    ("GroupNorm", (2, 4), (2, 4, 3, 3)),
    ("InstanceNorm2D", (3,), (2, 3, 4, 4)),
    ("InstanceNorm1D", (3,), (2, 3, 6)),
    ("InstanceNorm3D", (2,), (1, 2, 3, 3, 3)),
    ("LocalResponseNorm", (3,), (2, 5, 3, 3)),
])
def test_norm_layers_match_jax(cls, args, xs):
    pp.seed(1)
    jl = getattr(jnn, cls)(*args)
    tl = getattr(tnn, cls)(*args)
    state = {k: v.numpy() for k, v in jl.state_dict().items()}
    assert list(tl.state_dict()) == list(state)
    tl.set_state_dict({k: v + 0.5 for k, v in state.items()})
    jl.set_state_dict({k: pp.to_tensor(v + 0.5) for k, v in state.items()})
    x = _r(xs, 34, 2.0)
    _close(tl(torch.from_numpy(x)), jl(pp.to_tensor(x)))
    if cls.startswith("Instance"):
        assert list(state) == ["scale", "bias"]


def test_spectral_norm_matches_jax():
    jl = jnn.SpectralNorm([6, 4, 3], dim=0, power_iters=3)
    tl = tnn.SpectralNorm([6, 4, 3], dim=0, power_iters=3)
    assert list(tl.state_dict()) == ["weight_u", "weight_v"]
    np.testing.assert_array_equal(tl.weight_u.numpy(), jl.weight_u.numpy())
    np.testing.assert_array_equal(tl.weight_v.numpy(), jl.weight_v.numpy())
    w = _r((6, 4, 3), 35)
    _close(tl(torch.from_numpy(w)), jl(pp.to_tensor(w)))
    w = _r((3, 5), 36)
    jl = jnn.SpectralNorm([3, 5], dim=1, power_iters=2)
    tl = tnn.SpectralNorm([3, 5], dim=1, power_iters=2)
    _close(tl(torch.from_numpy(w)), jl(pp.to_tensor(w)))
