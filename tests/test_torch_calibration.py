"""The calibration side of quantization against the JAX package's, on the
CPU in fp32, on the same numpy inputs and copied weights: the observers'
scales, ``quant_dequant`` and its straight-through gradient,
``quantize_weight``, ``QuantedLinear`` in both flavours, ``PTQ`` (calibrate
over 4 batches, convert, forward) and ``QAT`` (20 eager SGD steps, then
convert), with JAX's quirks kept."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as pp
from paddle_tpu import quantization as JQ

from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import quantization as Q
from paddle_tpu_torch.nn import functional as TF


def _x(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) *
            scale).astype(np.float32)


@pytest.mark.parametrize("name", ["AbsMaxObserver",
                                  "MovingAverageAbsMaxObserver",
                                  "HistogramObserver", "KLObserver"])
def test_observer_scales_equal_jax(name):
    """Each observer over the same batches, the second wider than the
    first (the histogram re-bins): the same scale, exactly (the
    histogram ones in float64 numpy on both sides)."""
    kw = {"bins_count": 512} if name in ("HistogramObserver",
                                         "KLObserver") else {}
    jo, to = getattr(JQ, name)(**kw), getattr(Q, name)(**kw)
    for i, s in enumerate((1.0, 3.0, 0.5, 2.0)):
        x = _x(i, (64, 48), s)
        jo(pp.to_tensor(x))
        to(torch.from_numpy(x))
    assert to.scale() == jo.scale()


def test_moving_average_first_batch_and_rate():
    obs = Q.MovingAverageAbsMaxObserver(moving_rate=0.5)
    obs(torch.tensor([4.0]))
    obs(torch.tensor([2.0]))
    assert obs._absmax == pytest.approx(3.0)


@pytest.mark.parametrize("bits", [8, 4])
def test_quant_dequant_and_ste_bitwise(bits):
    """Forward and straight-through gradient equal JAX's bit for bit in
    fp32 (the mask ``|v / s| <= qmax + 1`` passes the gradient; the scale
    gets zeros)."""
    x = _x(3, (7, 33), 2.0)
    x[0, :3] = [100.0, -100.0, 0.05]
    s = np.float32(0.03)
    g = _x(4, (7, 33))
    jy, jvjp = jax.vjp(lambda v, sc: JQ.quant_dequant(v, sc, bits=bits),
                       jnp.asarray(x), jnp.asarray(s))
    jgx, jgs = jvjp(jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_()
    ts = torch.tensor(s).requires_grad_()
    ty = Q.quant_dequant(tx, ts, bits=bits)
    ty.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(ty.detach().numpy(), np.asarray(jy))
    np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(jgx))
    assert float(ts.grad) == float(jgs) == 0.0


@pytest.mark.parametrize("axis", [None, 0, 1])
def test_quantize_weight_bitwise(axis):
    """Codes clipped to [-128, 127] and scales floored at 1e-8, per
    tensor or per channel: JAX's bit for bit."""
    w = _x(5, (24, 40))
    w[:, 2] = 0.0
    jq, js = JQ.quantize_weight(pp.to_tensor(w), axis=axis)
    tq, ts = Q.quantize_weight(torch.from_numpy(w), axis=axis)
    assert tq.dtype == torch.int8 and tuple(ts.shape) == np.shape(js)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def _linear_pair(seed, fin, fout):
    jl = pp.nn.Linear(fin, fout)
    tl = tnn.Linear(fin, fout)
    tl.set_state_dict({"weight": _x(seed, (fin, fout), 0.2),
                       "bias": _x(seed + 1, (fout,), 0.1)})
    jl.set_state_dict({k: pp.to_tensor(v.detach().numpy())
                       for k, v in tl.state_dict().items()})
    return jl, tl


@pytest.mark.parametrize("act_scale", [None, 0.02])
def test_quanted_linear_matches_jax(act_scale):
    """W8A8 (``act_scale``: int32 accumulators equal JAX's exactly) and
    weight-only without a mode (``quantize_weight``'s codes through the
    quant matmul's plain version): outputs within 1e-5 of the largest."""
    jl, tl = _linear_pair(6, 64, 48)
    x = _x(8, (5, 64))
    jq = JQ.QuantedLinear(jl, act_scale=act_scale)
    tq = Q.QuantedLinear(tl, act_scale=act_scale)
    np.testing.assert_array_equal(tq.qweight.numpy(), np.asarray(
        jq.qweight.numpy()))
    want = jq(pp.to_tensor(x)).numpy()
    got = tq(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    if act_scale is not None:
        xq = jnp.clip(jnp.round(jnp.asarray(x) / act_scale), -128,
                      127).astype(jnp.int8)
        acc = jax.lax.dot_general(
            xq, jnp.asarray(jq.qweight.numpy()), (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.int32)
        np.testing.assert_array_equal(
            Q.int8_linear_accumulate(torch.from_numpy(x), act_scale,
                                     tq.qweight).numpy(), np.asarray(acc))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_w8a8_codes_and_accumulators_equal_jax(dtype):
    """The input's int8 codes at ``act_scale`` (a Python scale taken in
    x's dtype, as JAX takes a weak scalar) and the int32 accumulators:
    JAX's exactly, in fp32 and in bf16."""
    from paddle_tpu_torch.nn.layer import _from_numpy
    x = jnp.asarray(_x(9, (6, 64)), dtype)
    q = np.random.default_rng(10).integers(-128, 128, (64, 40)).astype(
        np.int8)
    xq = jnp.clip(jnp.round(x / 0.013), -128, 127).astype(jnp.int8)
    acc = jax.lax.dot_general(xq, jnp.asarray(q), (((1,), (0,)), ((), ())),
                              preferred_element_type=jnp.int32)
    got = Q.int8_linear_accumulate(_from_numpy(np.asarray(x)), 0.013,
                                   torch.from_numpy(q))
    np.testing.assert_array_equal(got.numpy(), np.asarray(acc))


def _mlp_pair():
    """JAX's test network (Linear 8 -> 32, ReLU, Linear 32 -> 4) in both
    packages with the same weights."""
    pp.seed(3)
    jnet = pp.nn.Sequential(pp.nn.Linear(8, 32), pp.nn.ReLU(),
                            pp.nn.Linear(32, 4))
    tnet = tnn.Sequential(tnn.Linear(8, 32), tnn.ReLU(), tnn.Linear(32, 4))
    tnet.set_state_dict({k: v.numpy() for k, v in
                         jnet.state_dict().items()})
    return jnet, tnet


def test_ptq_calibrate_convert_matches_jax():
    """PTQ: 4 calibration forwards, convert, forward: the converted
    layers and their activation scales equal JAX's, the outputs within
    1e-5 of the largest; state-dict names during calibration are JAX's
    (``inner.weight``)."""
    jnet, tnet = _mlp_pair()
    jptq, tptq = JQ.PTQ(), Q.PTQ()
    jptq.quantize(jnet)
    tptq.quantize(tnet)
    assert sorted(tnet.state_dict()) == sorted(jnet.state_dict())
    for i in range(4):
        x = _x(10 + i, (16, 8), 1.0 + i)
        jnet(pp.to_tensor(x))
        tnet(torch.from_numpy(x))
    jptq.convert(jnet)
    tptq.convert(tnet)
    for i in (0, 2):
        assert isinstance(tnet[i], Q.QuantedLinear)
        assert tnet[i].act_scale == jnet[i].act_scale
        np.testing.assert_array_equal(tnet[i].qweight.numpy(),
                                      np.asarray(jnet[i].qweight.numpy()))
    x = _x(20, (16, 8))
    want = jnet(pp.to_tensor(x)).numpy()
    got = tnet(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_qat_twenty_steps_match_jax():
    """QAT: fake-quant wrappers, 20 eager SGD steps (lr 0.5) on the same
    batch from copied weights: every loss within 1e-4 (relative) of
    JAX's, every step's gradients within 1e-5 of their largest, the loss
    falls, and the converted network's outputs within 1e-4 of JAX's
    largest.  SGD, not Adam: Adam scales a gradient element near zero up
    to a full step, so the packages' rounding-level gradient differences
    (3e-8) grow to 1e-6 in the weights and reach a fake-quant code
    boundary after ~15 steps (a 1.7e-4 loss step); SGD keeps them at
    rounding level."""
    jnet, tnet = _mlp_pair()
    jqat, tqat = JQ.QAT(), Q.QAT()
    jqat.quantize(jnet)
    tqat.quantize(tnet)
    assert isinstance(tnet[0], Q.FakeQuantLinear)
    assert sorted(tnet.state_dict()) == sorted(jnet.state_dict())
    jopt = pp.optimizer.SGD(learning_rate=0.5, parameters=jnet.parameters())
    topt_ = topt.SGD(learning_rate=0.5, parameters=tnet.parameters())
    x = _x(30, (32, 8))
    y = (np.arange(32) % 4).astype(np.int64)
    jl, tl = [], []
    for _ in range(20):
        loss = pp.nn.functional.cross_entropy(jnet(pp.to_tensor(x)),
                                              pp.to_tensor(y))
        loss.backward()
        tloss = TF.cross_entropy(tnet(torch.from_numpy(x)),
                                 torch.from_numpy(y))
        tloss.backward()
        for jp, tp in zip(jnet.parameters(), tnet.parameters()):
            want = jp.grad.numpy()
            np.testing.assert_allclose(tp.grad.numpy(), want, rtol=0,
                                       atol=1e-5 * np.abs(want).max())
        jopt.step()
        jopt.clear_grad()
        topt_.step()
        topt_.clear_grad()
        jl.append(float(loss.numpy()))
        tl.append(float(tloss.detach()))
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tl[-1] < tl[0]
    jqat.convert(jnet)
    tqat.convert(tnet)
    assert isinstance(tnet[0], Q.QuantedLinear)
    want = jnet(pp.to_tensor(x)).numpy()
    got = tnet(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


def test_jax_quirks_are_kept():
    """``add_type_config`` ignores its observer arguments; fake-quant and
    PTQ observe with a moving average whatever the config names; the
    default config quantizes Linears only."""
    cfg = Q.QuantConfig(activation=Q.KLObserver, weight=Q.KLObserver)
    cfg.add_type_config(tnn.Linear, activation=Q.HistogramObserver)
    assert cfg._layer_types == [tnn.Linear]
    assert cfg.activation_factory is Q.KLObserver
    net = tnn.Sequential(tnn.Linear(4, 4), tnn.LayerNorm(4))
    Q.QAT(cfg).quantize(net)
    assert isinstance(net[0].act_observer, Q.MovingAverageAbsMaxObserver)
    assert isinstance(net[1], tnn.LayerNorm)
    ptq = Q.PTQ(cfg)
    ptq.quantize(tnn.Sequential(tnn.Linear(4, 4)))
    assert all(isinstance(o, Q.MovingAverageAbsMaxObserver)
               for o in ptq._observers.values())
