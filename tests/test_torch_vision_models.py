"""The port's vision model zoo against the JAX package's on the CPU: each
model's parameter and buffer names and shapes, its forward in training
mode (batch statistics) at a small input, ResNet-50 at b = 2, 64 x 64,
and one ResNet-18 training step (loss and gradients against JAX's, then
the Momentum update).

The JAX model runs the port's weights through ``functional_call`` under
``jax.jit`` (one compile a model), and is built with its initializers
replaced by zeros (the JAX package's eager random initializers compile
each parameter's shape: about 20 s a model here); its weights never
matter, since the port's are substituted.  Dropout layers are in eval
mode (each package draws its own masks).  fp32; a forward through up to
fifty convolutions, each summing in another order than XLA's, with
BatchNorms on the batch statistics of a few values a channel in the
last stages (8 at ResNet's last stage here): elementwise 1e-4 relative
and absolute on the small nets' logits; for the ResNets every element
within 1e-4 of the largest magnitude (the errors are a few 1e-5 of it,
and a near-zero logit or gradient has no relative error to speak of),
as stated per test."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pp
import paddle_tpu.nn.initializer as JI
from paddle_tpu.core.functional import functional_call
from paddle_tpu.nn import functional as JF
from paddle_tpu.vision import models as jmodels

import paddle_tpu_torch as tp
import paddle_tpu_torch.nn.functional as TF
from paddle_tpu_torch.vision import models as tmodels


@pytest.fixture(autouse=True)
def _cpu():
    from paddle_tpu_torch.core import state
    prev = state.get_default_device()
    tp.set_device("cpu")
    yield
    state.set_default_device(prev)


@contextlib.contextmanager
def _zero_inits():
    """The JAX initializers replaced by numpy zeros (no compile)."""
    saved = {}
    for name in JI.__all__:
        cls = getattr(JI, name)
        if isinstance(cls, type) and "__call__" in vars(cls):
            saved[cls] = vars(cls)["__call__"]
            cls.__call__ = lambda self, shape, dtype="float32": \
                jnp.asarray(np.zeros(tuple(shape), np.float32))
    try:
        yield
    finally:
        for cls, fn in saved.items():
            cls.__call__ = fn


def _r(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _eval_dropout(model):
    subs = model.sublayers() if hasattr(model, "sublayers") else \
        model.modules()
    for s in subs:
        if type(s).__name__ == "Dropout":
            s.eval()


def _pair(name, **kw):
    """(JAX model, port model, the port's state as numpy)."""
    with _zero_inits():
        jm = getattr(jmodels, name)(**kw)
    tp.seed(0)
    tm = getattr(tmodels, name)(**kw)
    jshapes = {k: tuple(v.shape) for k, v in jm.state_dict().items()}
    tshapes = {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    assert list(tshapes) == list(jshapes)
    assert tshapes == jshapes
    _eval_dropout(jm)
    _eval_dropout(tm)
    state = {k: v.detach().numpy().copy()
             for k, v in tm.state_dict().items()}
    return jm, tm, state


def _scaled_close(got, want, tol, what=""):
    """Every element within `tol` times the largest |want|."""
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (what, err, np.abs(want).max())


def _jax_forward(jm, state, x):
    f = jax.jit(lambda p, x: functional_call(jm, p, x))
    return np.asarray(f({k: jnp.asarray(v) for k, v in state.items()}, x))


MODELS = [
    ("LeNet", dict(num_classes=10), (2, 1, 28, 28), 1e-5),
    ("AlexNet", dict(num_classes=7), (2, 3, 64, 64), 1e-4),
    ("vgg11", dict(num_classes=4), (1, 3, 32, 32), 1e-4),
    ("vgg11", dict(num_classes=4, batch_norm=True), (2, 3, 32, 32), 1e-4),
    ("mobilenet_v2", dict(scale=0.35, num_classes=7), (2, 3, 64, 64), 1e-4),
    ("squeezenet1_0", dict(num_classes=5), (1, 3, 64, 64), 1e-4),
    ("squeezenet1_1", dict(num_classes=5), (1, 3, 64, 64), 1e-4),
    ("resnet18", dict(num_classes=10), (2, 3, 64, 64), None),
    ("resnet50", dict(num_classes=1000), (2, 3, 64, 64), None),
]


@pytest.mark.parametrize("name,kw,xs,tol", MODELS,
                         ids=[f"{m[0]}-{i}" for i, m in enumerate(MODELS)])
def test_forward_matches_jax(name, kw, xs, tol):
    jm, tm, state = _pair(name, **kw)
    x = _r(xs, 1)
    want = _jax_forward(jm, state, x)
    got = tm(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape == (xs[0], kw["num_classes"])
    if tol is None:
        _scaled_close(got, want, 1e-4)
    else:
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_resnet50_size_and_running_stats():
    """25.6 M parameters; the running statistics after one training
    forward (the port's eager update against JAX's eager layer, whose
    update starts from the same zeros and ones)."""
    jm, tm, state = _pair("resnet50")
    assert sum(p.numel() for p in tm.parameters()) == 25557032
    x = _r((1, 3, 32, 32), 2)
    jm.set_state_dict(state)
    jm.bn1(jm.conv1(pp.to_tensor(x)))
    tm.bn1(tm.conv1(torch.from_numpy(x)))
    for name in ("_mean", "_variance"):
        np.testing.assert_allclose(getattr(tm.bn1, name).numpy(),
                                   getattr(jm.bn1, name).numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


def test_resnet18_training_step_matches_jax():
    """Cross-entropy of ResNet-18 at b = 2, 64 x 64: the loss (1e-5) and
    a sample of gradients against ``jax.grad`` of the JAX model (each
    within 1e-4 of its largest magnitude: back through 18 layers), then
    the port's Momentum(0.9, weight_decay=1e-4) first step,
    ``p - lr (g + wd p)``."""
    jm, tm, state = _pair("resnet18", num_classes=10)
    x = _r((2, 3, 64, 64), 3)
    y = np.array([3, 7])

    def loss(p):
        return JF.cross_entropy(functional_call(jm, p, x),
                                pp.to_tensor(y))._data

    jp = {k: jnp.asarray(v) for k, v in state.items()}
    jl, jg = jax.jit(jax.value_and_grad(loss))(jp)
    tl = TF.cross_entropy(tm(torch.from_numpy(x)), torch.from_numpy(y))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    tl.backward()
    params = dict(tm.named_parameters())
    sample = ("conv1.weight", "layer1.0.bn1.weight", "layer3.1.conv2.weight",
              "layer4.0.downsample.0.weight", "fc.weight", "fc.bias")
    for name in sample:
        _scaled_close(params[name].grad.numpy(), np.asarray(jg[name]), 1e-4,
                      name)
    opt = tp.optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                                weight_decay=1e-4,
                                parameters=tm.parameters())
    opt.step()
    for name in sample:
        p0, g = state[name], params[name].grad.numpy()
        np.testing.assert_allclose(params[name].detach().numpy(),
                                   p0 - 0.1 * (g + 1e-4 * p0), rtol=1e-5,
                                   atol=1e-6, err_msg=name)


def test_mobilenet_residual_structure():
    m = tmodels.MobileNetV2(scale=0.35, num_classes=2)
    assert len([b for b in m.features if getattr(b, "use_res", False)]) >= 5


def test_models_run_on_the_default_device():
    from paddle_tpu_torch.core import state
    state.set_default_device("cuda")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tmodels.resnet18()
    assert tmodels.LeNet(device="cpu").fc[0].weight.device.type == "cpu"
