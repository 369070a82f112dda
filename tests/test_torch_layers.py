"""The rest of the layer surface against the JAX package's, on the CPU in
fp32 on seeded numpy inputs and copied weights: the 29 activation
functions and their layers (2e-5), PReLU, Bilinear, CosineSimilarity,
the containers and their state-dict names, the dropouts, the
initializers (the deterministic ones exactly, the random ones by fans,
bounds and moments, Orthogonal by orthogonality), ``attr=`` /
``weight_attr``, ``trainable`` / ``stop_gradient``, ``need_clip``, grad
mode and the RNG state."""

import collections
import math

import numpy as np
import pytest
import torch

import paddle_tpu as pp
from paddle_tpu import nn as jnn
from paddle_tpu.nn import functional as JF
from paddle_tpu.nn import initializer as JI

from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.core import state as TS
from paddle_tpu_torch.core import tensor as TT
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.nn import initializer as TI

TOL = 2e-5


def _x(seed=0, shape=(4, 6, 8), scale=3.0):
    return (np.random.default_rng(seed).standard_normal(shape) *
            scale).astype(np.float32)


# (name, positional args, keyword args)
ACTS = [("relu", (), {}), ("relu6", (), {}), ("sigmoid", (), {}),
        ("tanh", (), {}), ("silu", (), {}), ("swish", (), {}),
        ("mish", (), {}), ("hardswish", (), {}), ("hardsigmoid", (), {}),
        ("hardtanh", (), {"min": -0.5, "max": 2.0}),
        ("elu", (), {"alpha": 0.7}), ("celu", (), {"alpha": 1.3}),
        ("selu", (), {}), ("leaky_relu", (), {"negative_slope": 0.2}),
        ("softplus", (), {"beta": 2.0, "threshold": 5.0}),
        ("softsign", (), {}), ("tanhshrink", (), {}), ("log_sigmoid", (), {}),
        ("gelu", (), {}), ("gelu", (), {"approximate": True}),
        ("softmax", (), {"axis": 1}), ("log_softmax", (), {}),
        ("softshrink", (), {"threshold": 0.7}),
        ("hardshrink", (), {"threshold": 0.7}),
        ("thresholded_relu", (), {"threshold": 0.5, "value": -1.0}),
        ("rrelu", (), {}), ("maxout", (2,), {"axis": 1}),
        ("glu", (), {}), ("gumbel_softmax", (), {"temperature": 0.5}),
        ("gumbel_softmax", (), {"hard": True})]


@pytest.mark.parametrize("name,args,kw", ACTS,
                         ids=[f"{a[0]}{i}" for i, a in enumerate(ACTS)])
def test_activation_matches_jax(name, args, kw):
    x = _x()
    want = getattr(JF, name)(pp.to_tensor(x), *args, **kw).numpy()
    got = getattr(TF, name)(torch.from_numpy(x), *args, **kw).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_every_jax_activation_is_ported():
    from paddle_tpu.nn.functional import activation as JA
    from paddle_tpu_torch.nn.functional import activation as TA
    assert sorted(JA.__all__) == sorted(TA.__all__)
    assert len(TA.__all__) == 29


LAYERS = [("ReLU", (), {}), ("ReLU6", (), {}), ("GELU", (), {}),
          ("SiLU", (), {}), ("Swish", (), {}), ("Mish", (), {}),
          ("Sigmoid", (), {}), ("Tanh", (), {}), ("LeakyReLU", (0.1,), {}),
          ("ELU", (), {"alpha": 0.5}), ("CELU", (), {}), ("SELU", (), {}),
          ("Hardswish", (), {}), ("Hardsigmoid", (), {}),
          ("Hardtanh", (), {}), ("Hardshrink", (), {}),
          ("Softshrink", (), {}), ("Tanhshrink", (), {}),
          ("ThresholdedReLU", (), {}), ("Softplus", (), {}),
          ("Softsign", (), {}), ("LogSigmoid", (), {}),
          ("Softmax", (), {"axis": -1, "name": "s"}), ("LogSoftmax", (), {}),
          ("Maxout", (3,), {"axis": 2}), ("GLU", (), {"axis": 1}),
          ("RReLU", (), {}), ("Identity", (), {}), ("Flatten", (), {}),
          ("Flatten", (0, 1), {})]


@pytest.mark.parametrize("name,args,kw", LAYERS,
                         ids=[f"{a[0]}{i}" for i, a in enumerate(LAYERS)])
def test_layer_matches_jax(name, args, kw):
    x = _x(1, (2, 6, 12))
    want = getattr(jnn, name)(*args, **kw)(pp.to_tensor(x)).numpy()
    got = getattr(tnn, name)(*args, **kw)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("num", [1, 6])
def test_prelu_matches_jax(num):
    jl = jnn.PReLU(num_parameters=num, init=0.3)
    tl = tnn.PReLU(num_parameters=num, init=0.3)
    assert sorted(tl.state_dict()) == sorted(jl.state_dict()) == ["weight"]
    w = _x(2, (num,), 0.5)
    jl.set_state_dict({"weight": pp.to_tensor(w)})
    tl.set_state_dict({"weight": w})
    x = _x(3, (2, 6, 5))
    np.testing.assert_allclose(tl(torch.from_numpy(x)).detach().numpy(),
                               jl(pp.to_tensor(x)).numpy(), rtol=TOL,
                               atol=TOL)


def test_bilinear_and_cosine_similarity_match_jax():
    jb, tb = jnn.Bilinear(5, 7, 3), tnn.Bilinear(5, 7, 3)
    assert sorted(tb.state_dict()) == sorted(jb.state_dict())
    tb.set_state_dict({k: v.numpy() for k, v in jb.state_dict().items()})
    tb.set_state_dict({"weight": _x(4, (3, 5, 7)),
                       "bias": _x(5, (3,))})
    jb.set_state_dict({k: pp.to_tensor(v.detach().numpy())
                       for k, v in tb.state_dict().items()})
    x1, x2 = _x(6, (4, 5)), _x(7, (4, 7))
    np.testing.assert_allclose(
        tb(torch.from_numpy(x1), torch.from_numpy(x2)).detach().numpy(),
        jb(pp.to_tensor(x1), pp.to_tensor(x2)).numpy(), rtol=TOL,
        atol=TOL * 10)
    a, b = _x(8, (3, 9, 4)), _x(9, (3, 9, 4))
    a[0, :, 0] = 0.0
    for axis in (1, -1):
        np.testing.assert_allclose(
            tnn.CosineSimilarity(axis=axis)(torch.from_numpy(a),
                                            torch.from_numpy(b)).numpy(),
            jnn.CosineSimilarity(axis=axis)(pp.to_tensor(a),
                                            pp.to_tensor(b)).numpy(),
            rtol=TOL, atol=TOL)


def test_containers_names_and_forward_match_jax():
    """Sequential (positional, pairs, OrderedDict), LayerDict and
    ParameterList: JAX's state-dict names and Sequential's forward."""
    pp.seed(0)
    jseq = jnn.Sequential(jnn.Linear(4, 8), jnn.GELU(), jnn.Linear(8, 3))
    tseq = tnn.Sequential(tnn.Linear(4, 8), tnn.GELU(), tnn.Linear(8, 3))
    assert list(tseq.state_dict()) == list(jseq.state_dict())
    tseq.set_state_dict({k: v.numpy() for k, v in jseq.state_dict().items()})
    x = _x(10, (5, 4))
    np.testing.assert_allclose(tseq(torch.from_numpy(x)).detach().numpy(),
                               jseq(pp.to_tensor(x)).numpy(), rtol=TOL,
                               atol=TOL)
    assert len(tseq) == 3 and isinstance(tseq[1], tnn.GELU)
    assert isinstance(tseq[1:], tnn.Sequential) and len(tseq[1:]) == 2
    named = [("a", tnn.Linear(2, 2)), ("b", tnn.ReLU())]
    for t, j in ((tnn.Sequential(*named),
                  jnn.Sequential(("a", jnn.Linear(2, 2)), ("b", jnn.ReLU()))),
                 (tnn.Sequential(collections.OrderedDict(named)),
                  jnn.Sequential(collections.OrderedDict(
                      [("a", jnn.Linear(2, 2)), ("b", jnn.ReLU())])))):
        assert list(t.state_dict()) == list(j.state_dict())
    td = tnn.LayerDict({"p": tnn.Linear(2, 3), "q": tnn.Linear(3, 1)})
    jd = jnn.LayerDict({"p": jnn.Linear(2, 3), "q": jnn.Linear(3, 1)})
    assert list(td.state_dict()) == list(jd.state_dict())
    assert list(td.keys()) == ["p", "q"] and len(td) == 2
    del td["p"]
    assert list(td) == ["q"]
    tpl = tnn.ParameterList([torch.zeros(2), torch.ones(3)])
    jpl = jnn.ParameterList([pp.zeros([2]), pp.ones([3])])
    tpl.append(torch.ones(1))
    jpl.append(pp.ones([1]))
    assert list(tpl.state_dict()) == list(jpl.state_dict())
    assert len(tpl) == 3 and all(p.requires_grad for p in tpl)


def test_dropouts_eval_identity_and_train_structure():
    """Eval: the identity (as JAX).  Training: Dropout2D / 3D drop whole
    channels, kept ones scaled by 1 / (1 - p); AlphaDropout keeps the
    mean and variance of a unit normal."""
    x = torch.from_numpy(_x(11, (8, 16, 5, 5), 1.0)) + 3.0
    for layer in (tnn.Dropout2D(0.5), tnn.Dropout3D(0.5),
                  tnn.AlphaDropout(0.5)):
        layer.eval()
        assert torch.equal(layer(x if not isinstance(layer, tnn.Dropout3D)
                                 else x[..., None]),
                           x if not isinstance(layer, tnn.Dropout3D)
                           else x[..., None])
    d2 = tnn.Dropout2D(0.5)
    y = d2(x)
    per_channel = (y == 0).reshape(8, 16, -1)
    assert bool((per_channel.all(-1) | (~per_channel).all(-1)).all())
    kept = ~per_channel.all(-1)
    torch.testing.assert_close(y.reshape(8, 16, -1)[kept],
                               2 * x.reshape(8, 16, -1)[kept])
    y3 = tnn.Dropout3D(0.5)(x[..., None])
    z3 = (y3 == 0).reshape(8, 16, -1)
    assert bool((z3.all(-1) | (~z3).all(-1)).all())
    a = tnn.AlphaDropout(0.2)(torch.randn(200000))
    assert abs(float(a.mean())) < 0.02 and abs(float(a.std()) - 1) < 0.02


def test_deterministic_initializers_equal_jax():
    """Constant, Assign and Dirac equal JAX's exactly; calculate_gain
    too."""
    for t, j, shape in ((TI.Constant(0.37), JI.Constant(0.37), [3, 4]),
                        (TI.Assign(np.arange(12.0)), JI.Assign(
                            np.arange(12.0)), [3, 4]),
                        (TI.Dirac(), JI.Dirac(), [4, 2, 3, 3]),
                        (TI.Dirac(groups=2), JI.Dirac(groups=2),
                         [6, 2, 5])):
        np.testing.assert_array_equal(t(shape).numpy(),
                                      np.asarray(j(shape)))
    for name, param in (("sigmoid", None), ("linear", None), ("tanh", None),
                        ("relu", None), ("leaky_relu", 0.2), ("selu", None),
                        ("conv2d", None)):
        assert TI.calculate_gain(name, param) == JI.calculate_gain(name,
                                                                   param)


@pytest.mark.parametrize("shape", [[64, 96], [32, 8, 3, 3]])
def test_random_initializers_fans_bounds_moments(shape):
    """Each random initializer's bound or standard deviation from JAX's
    fan rule: uniform draws within ±limit with variance limit^2 / 3,
    normal draws with the stated std, truncated normal inside [a, b]."""
    TS.seed(7)
    fi, fo = TI._fans(shape)
    assert (fi, fo) == JI._fans(shape)
    n = math.prod(shape)
    tol = 6 / math.sqrt(n)          # relative spread of a variance estimate

    def check_uniform(init, limit):
        w = init(shape)
        assert float(w.abs().max()) <= limit
        assert abs(float(w.var()) / (limit ** 2 / 3) - 1) < tol

    def check_normal(init, std):
        w = init(shape)
        assert abs(float(w.std()) / std - 1) < tol
        assert abs(float(w.mean())) < 6 * std / math.sqrt(n)

    check_uniform(TI.XavierUniform(), math.sqrt(6.0 / (fi + fo)))
    check_uniform(TI.XavierUniform(gain=2.0, fan_in=10),
                  2.0 * math.sqrt(6.0 / (10 + fo)))
    check_uniform(TI.KaimingUniform(), math.sqrt(2.0) * math.sqrt(3.0 / fi))
    check_uniform(TI.Uniform(-0.3, 0.3), 0.3)
    check_normal(TI.XavierNormal(), math.sqrt(2.0 / (fi + fo)))
    check_normal(TI.KaimingNormal(nonlinearity="leaky_relu",
                                  negative_slope=0.1),
                 TI.calculate_gain("leaky_relu", 0.1) / math.sqrt(fi))
    check_normal(TI.Normal(0.0, 0.02), 0.02)
    w = TI.TruncatedNormal(1.0, 0.5, -1.0, 1.5)(shape)
    assert float(w.min()) >= 1.0 - 0.5 and float(w.max()) <= 1.0 + 0.75
    u = TI.Uniform(2.0, 5.0)(shape, "bfloat16")
    assert u.dtype == torch.bfloat16 and 2.0 <= float(u.min()) and \
        float(u.max()) <= 5.0


@pytest.mark.parametrize("shape", [[16, 6], [6, 16], [4, 3, 5]])
def test_orthogonal_is_orthogonal_like_jax(shape):
    """JAX's convention (the last axis the columns): orthonormal columns
    when the last axis is the shorter, rows otherwise, times the gain;
    JAX's own draw shows the same property."""
    w = TI.Orthogonal(gain=1.5)(shape).reshape(-1, shape[-1]).double()
    jw = torch.from_numpy(np.asarray(JI.Orthogonal(gain=1.5)(shape),
                                     np.float64)).reshape(-1, shape[-1])
    for m in (w, jw):
        r, c = m.shape
        gram = m.T @ m if r >= c else m @ m.T
        torch.testing.assert_close(gram, 2.25 * torch.eye(min(r, c),
                                                          dtype=gram.dtype),
                                   rtol=0, atol=1e-5)


class _Attr:
    """A duck-typed attr, as JAX reads one (there is no ParamAttr)."""

    def __init__(self, initializer=None, learning_rate=None,
                 trainable=True):
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.trainable = trainable


def test_attr_resolution_matches_jax():
    """``weight_attr`` / ``bias_attr``: the attr's initializer, its
    learning rate into ``optimize_attr``, ``trainable=False`` as
    ``stop_gradient``; an explicit default initializer wins (Embedding
    with an attr and no initializer falls to Xavier)."""
    w = _x(12, (3, 4))
    for mod, tmod in ((jnn, tnn),):
        jl = mod.Linear(3, 4, weight_attr=_Attr(JI.Assign(w), 0.5),
                        bias_attr=_Attr(JI.Constant(0.25), trainable=False))
        tl = tmod.Linear(3, 4, weight_attr=_Attr(TI.Assign(w), 0.5),
                         bias_attr=_Attr(TI.Constant(0.25), trainable=False))
    np.testing.assert_array_equal(tl.weight.detach().numpy(),
                                  jl.weight.numpy())
    np.testing.assert_array_equal(tl.bias.detach().numpy(), jl.bias.numpy())
    for attr in ("trainable", "stop_gradient", "need_clip",
                 "is_distributed", "regularizer", "optimize_attr"):
        for jp, tp in ((jl.weight, tl.weight), (jl.bias, tl.bias)):
            assert getattr(tp, attr) == getattr(jp, attr), attr
    assert tl.bias.stop_gradient and not tl.bias.requires_grad
    assert tl.weight.optimize_attr == {"learning_rate": 0.5}
    # LayerNorm's explicit ones win over the attr's initializer, in both
    ln = tnn.LayerNorm(4, weight_attr=_Attr(TI.Constant(2.0), 0.1),
                       bias_attr=False)
    jln = jnn.LayerNorm(4, weight_attr=_Attr(JI.Constant(2.0), 0.1),
                        bias_attr=False)
    assert ln.bias is None and jln.bias is None
    np.testing.assert_array_equal(ln.weight.detach().numpy(),
                                  jln.weight.numpy())
    assert ln.weight.optimize_attr == jln.weight.optimize_attr
    rms = tnn.RMSNorm(4, weight_attr=_Attr(trainable=False))
    assert rms.weight.stop_gradient
    emb = tnn.Embedding(50, 6, weight_attr=_Attr())
    assert abs(float(emb.weight.std()) - math.sqrt(2 / 56)) < 0.05
    pad = tnn.Embedding(10, 3, padding_idx=2)
    jpad = jnn.Embedding(10, 3, padding_idx=2)
    assert float(pad.weight[2].abs().sum()) == 0.0
    pad.set_state_dict({"weight": jpad.weight.numpy() + 1.0})
    jpad.set_state_dict({"weight": pp.to_tensor(
        pad.weight.detach().numpy())})
    ids = np.array([[1, 2, 3], [2, 2, 0]])
    np.testing.assert_array_equal(
        pad(torch.as_tensor(ids)).detach().numpy(),
        jpad(pp.to_tensor(ids)).numpy())
    enc = tnn.TransformerEncoderLayer(8, 2, 16, dropout=0.0, device="cpu",
                                      weight_attr=_Attr(TI.Constant(0.1)))
    assert float(enc.linear1.weight.mean()) == pytest.approx(0.1)
    assert float(enc.self_attn.q_proj.weight.mean()) == pytest.approx(0.1)


def test_stop_gradient_and_need_clip_in_an_eager_step_match_jax():
    """An eager optimizer step with a global-norm clip: a frozen
    parameter (``stop_gradient``) keeps its value, a ``need_clip=False``
    one takes its unclipped gradient, the others the clipped one; every
    parameter equal to JAX's after two steps (2e-6)."""
    pp.seed(1)
    jnet = jnn.Sequential(jnn.Linear(6, 5), jnn.Tanh(), jnn.Linear(5, 3))
    tnet = tnn.Sequential(tnn.Linear(6, 5), tnn.Tanh(), tnn.Linear(5, 3))
    tnet.set_state_dict({k: v.numpy() for k, v in jnet.state_dict().items()})
    for net in (jnet, tnet):
        net[0].bias.stop_gradient = True
        net[2].weight.need_clip = False
    jopt = pp.optimizer.SGD(learning_rate=0.1, parameters=jnet.parameters(),
                            grad_clip=jnn.ClipGradByGlobalNorm(0.05))
    topt_ = topt.SGD(learning_rate=0.1, parameters=tnet.parameters(),
                     grad_clip=tnn.ClipGradByGlobalNorm(0.05))
    x = _x(13, (7, 6))
    before = tnet[0].bias.detach().clone()
    for _ in range(2):
        (jnet(pp.to_tensor(x)) ** 2).sum().backward()
        jopt.step()
        jopt.clear_grad()
        (tnet(torch.from_numpy(x)) ** 2).sum().backward()
        topt_.step()
        topt_.clear_grad()
    assert torch.equal(tnet[0].bias.detach(), before)
    for k, v in jnet.state_dict().items():
        np.testing.assert_allclose(tnet.state_dict()[k].numpy(), v.numpy(),
                                   rtol=0, atol=2e-6, err_msg=k)


def test_grad_mode_functions():
    assert TT.is_grad_enabled()
    w = torch.ones(2, requires_grad=True)
    with TT.no_grad():
        assert not TT.is_grad_enabled()
        assert not (w * 2).requires_grad
        with TT.enable_grad():
            assert (w * 2).requires_grad
    TT.set_grad_enabled(False)
    try:
        assert not TT.is_grad_enabled()
    finally:
        TT.set_grad_enabled(True)
    assert TT.is_grad_enabled()
    p = TT.Parameter(torch.zeros(3), trainable=False)
    assert p.stop_gradient and not p.trainable and not p.requires_grad
    p.stop_gradient = False
    assert p.requires_grad and not p.trainable      # kept apart, as in JAX


def test_rng_state_round_trip():
    """Philox cannot equal threefry: the draws after a restore repeat
    those that followed the saved state, per device and for all."""
    TS.seed(11)
    state = TS.get_rng_state()
    a = TI.Normal()([5])
    b = TF.dropout(torch.ones(64), 0.5)
    TS.set_rng_state(state)
    assert torch.equal(TI.Normal()([5]), a)
    assert torch.equal(TF.dropout(torch.ones(64), 0.5), b)
    one = TS.get_rng_state("cpu")
    c = TI.Uniform()([4])
    TS.set_rng_state(one)
    assert torch.equal(TI.Uniform()([4]), c)
