"""The port's autograd API against the JAX package's on the CPU: every
case of ``tests/test_higher_order_grad.py`` run through both packages on
the same numpy inputs, ``backward`` / ``grad`` arguments, PyLayer's
contract, and ``jacobian`` / ``hessian`` shapes and values.  fp32; the
tolerance is stated in each test (1e-5 relative unless it says why)."""

import numpy as np
import pytest
import torch

import paddle_tpu as pp

import paddle_tpu_torch as tp
from paddle_tpu_torch import autograd as tag

TOL = 1e-5


def _j(v):
    return pp.to_tensor(np.asarray(v, np.float32), stop_gradient=False)


def _t(v):
    return torch.tensor(np.asarray(v, np.float32), requires_grad=True)


def _np(t):
    return t.detach().numpy() if torch.is_tensor(t) else np.asarray(t._data)


def _close(got, want, rtol=TOL, atol=1e-6):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol)


# -- the cases of test_higher_order_grad.py ----------------------------------

def test_double_grad_polynomial():
    xv = np.array([1.5, -2.0, 0.7], np.float32)
    jx, tx = _j(xv), _t(xv)
    (jg1,) = pp.grad((jx ** 3).sum(), jx, create_graph=True)
    (tg1,) = tp.grad((tx ** 3).sum(), tx, create_graph=True)
    _close(tg1, jg1)
    assert tg1.requires_grad
    (jg2,) = pp.grad(jg1.sum(), jx)
    (tg2,) = tp.grad(tg1.sum(), tx)
    _close(tg2, jg2)
    np.testing.assert_allclose(_np(tg2), 6 * xv, rtol=TOL)


def test_double_grad_vs_numeric():
    xv = np.random.default_rng(0).uniform(0.3, 1.2, (4,)).astype(np.float32)
    jx, tx = _j(xv), _t(xv)
    (jg1,) = pp.grad((pp.sin(jx) * pp.exp(jx)).sum(), jx, create_graph=True)
    (jg2,) = pp.grad(jg1.sum(), jx)
    (tg1,) = tp.grad((torch.sin(tx) * torch.exp(tx)).sum(), tx,
                     create_graph=True)
    (tg2,) = tp.grad(tg1.sum(), tx)
    _close(tg2, jg2)
    x64 = xv.astype(np.float64)    # d2/dx2 sin(x) e^x = 2 cos(x) e^x
    np.testing.assert_allclose(_np(tg2), 2 * np.cos(x64) * np.exp(x64),
                               rtol=TOL)


def test_triple_grad():
    jx, tx = _j([2.0]), _t([2.0])
    outs = []
    for grad, x in ((pp.grad, jx), (tp.grad, tx)):
        (g1,) = grad((x ** 4).sum(), x, create_graph=True)
        (g2,) = grad(g1.sum(), x, create_graph=True)
        (g3,) = grad(g2.sum(), x)
        outs.append(g3)
    _close(outs[1], outs[0])
    np.testing.assert_allclose(_np(outs[1]), [48.0], rtol=TOL)


def test_mixed_inputs_double_grad():
    xv, yv = np.array([1.0, 2.0], np.float32), np.array([3.0, 4.0],
                                                        np.float32)
    outs = []
    for grad, mk in ((pp.grad, _j), (tp.grad, _t)):
        x, y = mk(xv), mk(yv)
        (gx,) = grad((x * y * y).sum(), x, create_graph=True)
        (gxy,) = grad(gx.sum(), y)
        outs.append(gxy)
    _close(outs[1], outs[0])
    np.testing.assert_allclose(_np(outs[1]), 2 * yv, rtol=TOL)


def test_backward_of_grad_through_layer():
    """A gradient penalty ``||dL/dx||^2`` differentiated with respect to
    a Linear's weight; the weight copied across."""
    import paddle_tpu.nn as jnn
    jl = jnn.Linear(3, 1)
    tl = tp.nn.Linear(3, 1)
    tl.set_state_dict({k: np.asarray(v._data)
                       for k, v in jl.state_dict().items()})
    xv = np.random.default_rng(1).normal(size=(2, 3)).astype(np.float32)
    jx, tx = _j(xv), _t(xv)
    (jgx,) = pp.grad(pp.tanh(jl(jx)).sum(), jx, create_graph=True)
    (jgw,) = pp.grad((jgx * jgx).sum(), jl.weight)
    (tgx,) = tp.grad(torch.tanh(tl(tx)).sum(), tx, create_graph=True)
    (tgw,) = tp.grad((tgx * tgx).sum(), tl.weight)
    assert tgw.shape == tl.weight.shape
    _close(tgw, jgw, atol=1e-6)


def test_leaf_in_outputs_keeps_history():
    outs = []
    for grad, mk in ((pp.grad, _j), (tp.grad, _t)):
        x = mk(2.0)
        (g,) = grad([x, (x * x).sum()], [x], create_graph=True)
        (g2,) = grad(g.sum(), x)
        outs.append((g, g2))
    _close(outs[1][0], outs[0][0])
    _close(outs[1][1], outs[0][1])
    np.testing.assert_allclose(_np(outs[1][0]), 5.0, rtol=TOL)


def test_create_graph_false_unchanged():
    x = _t([1.0])
    (g1,) = tp.grad((x ** 2).sum(), x)
    assert not g1.requires_grad     # raw grads carry no history
    with pytest.raises(RuntimeError):
        tp.grad(g1.sum(), x)


def _cube(base):
    class Cube(base):
        @staticmethod
        def forward(ctx, x):
            ctx.save_for_backward(x)
            return x * x * x

        @staticmethod
        def backward(ctx, gy):
            (x,) = ctx.saved_tensor
            return gy * 3 * x * x
    return Cube


def test_pylayer_double_grad():
    xv = np.array([1.5, 0.5], np.float32)
    outs = []
    for grad, base, mk in ((pp.grad, pp.autograd.PyLayer, _j),
                           (tp.grad, tag.PyLayer, _t)):
        x = mk(xv)
        (g1,) = grad(_cube(base).apply(x).sum(), x, create_graph=True)
        (g2,) = grad(g1.sum(), x)
        outs.append((g1, g2))
    _close(outs[1][0], outs[0][0])
    _close(outs[1][1], outs[0][1])


def test_jacobian_diagonal():
    xv = np.array([0.3, 1.1, -0.4], np.float32)
    tx = _t(xv)
    J = tag.jacobian(torch.sin(tx), tx)
    jx = _j(xv)
    _close(J, pp.autograd.jacobian(pp.sin(jx), jx))
    np.testing.assert_allclose(_np(J), np.diag(np.cos(xv)), rtol=TOL,
                               atol=1e-6)


def test_jacobian_matmul():
    rng = np.random.default_rng(2)
    A = rng.normal(size=(2, 3)).astype(np.float32)
    xv = rng.normal(size=(3,)).astype(np.float32)
    tx, jx = _t(xv), _j(xv)
    J = tag.jacobian(torch.matmul(torch.from_numpy(A), tx), tx)
    _close(J, pp.autograd.jacobian(pp.matmul(pp.to_tensor(A), jx), jx))
    np.testing.assert_allclose(_np(J), A, rtol=TOL)


def test_jacobian_batched():
    xv = np.random.default_rng(4).normal(size=(3, 2)).astype(np.float32)
    tx, jx = _t(xv), _j(xv)
    J = tag.jacobian(torch.sin(tx), tx, batch_axis=0)
    assert list(J.shape) == [3, 2, 2]
    _close(J, pp.autograd.jacobian(pp.sin(jx), jx, batch_axis=0))


def test_hessian_cross_blocks():
    outs = []
    for mod, mk in ((pp.autograd, _j), (tag, _t)):
        x1, x2 = mk([1.0, 2.0]), mk([3.0, 4.0])
        outs.append(mod.hessian((x1 * x2).sum(), [x1, x2]))
    for i in range(2):
        for j in range(2):
            _close(outs[1][i][j], outs[0][i][j])
    np.testing.assert_allclose(_np(outs[1][0][1]), np.eye(2), atol=1e-6)
    np.testing.assert_allclose(_np(outs[1][0][0]), np.zeros((2, 2)),
                               atol=1e-6)


def test_hessian_quadratic():
    rng = np.random.default_rng(3)
    Q = rng.normal(size=(3, 3)).astype(np.float32)
    Q = Q + Q.T
    xv = rng.normal(size=(3,)).astype(np.float32)
    tx, jx = _t(xv), _j(xv)
    H = tag.hessian(0.5 * torch.matmul(tx, torch.matmul(torch.from_numpy(Q),
                                                        tx)), tx)
    Hj = pp.autograd.hessian(0.5 * pp.matmul(jx, pp.matmul(pp.to_tensor(Q),
                                                           jx)), jx)
    _close(H, Hj, rtol=1e-4, atol=1e-5)   # JAX's own test's tolerance
    np.testing.assert_allclose(_np(H), Q, rtol=1e-4, atol=1e-5)


# -- backward / grad arguments ------------------------------------------------

def test_backward_accumulates_and_takes_seeds():
    xv = np.array([1.0, -2.0, 3.0], np.float32)
    seed = np.array([0.5, 2.0, -1.0], np.float32)
    jx, tx = _j(xv), _t(xv)
    pp.autograd.backward([jx * jx], [pp.to_tensor(seed)], retain_graph=True)
    tag.backward([tx * tx], [torch.from_numpy(seed)])
    _close(tx.grad, jx.grad)
    tag.backward((tx * tx).sum())          # a scalar: the implicit one
    pp.autograd.backward((jx * jx).sum())
    _close(tx.grad, jx.grad)               # accumulated in .grad
    np.testing.assert_allclose(tx.grad.numpy(), 2 * xv * seed + 2 * xv,
                               rtol=TOL)


def test_backward_needs_seed_for_non_scalar():
    tx = _t([1.0, 2.0])
    with pytest.raises(RuntimeError, match="scalar"):
        tag.backward(tx * 2)
    with pytest.raises(RuntimeError, match="stop_gradient"):
        tag.backward(torch.ones(1))


def test_grad_none_seed_and_allow_unused():
    x, y, z = _t([1.0, 2.0]), _t([3.0]), _t([5.0])
    out = (x * x).sum() * y.sum()
    gx, gy, gz = tp.grad([out], [x, y, z], grad_outputs=[None],
                         allow_unused=True)
    assert gz is None
    np.testing.assert_allclose(gx.numpy(), [6.0, 12.0], rtol=TOL)
    np.testing.assert_allclose(gy.numpy(), [5.0], rtol=TOL)
    with pytest.raises(RuntimeError, match="allow_unused"):
        tp.grad((x * y).sum(), [x, z])
    # an input that requires no gradient at all: None as well
    c = torch.ones(2)
    assert tp.grad((x * 2).sum(), [x, c], allow_unused=True)[1] is None


def test_grad_retain_graph_defaults_to_create_graph():
    x = _t([1.5])
    y = (x ** 3).sum()
    tp.grad(y, x, create_graph=True)
    tp.grad(y, x)                     # the graph survived (retained)
    y2 = (x ** 3).sum()
    tp.grad(y2, x)
    with pytest.raises(RuntimeError):
        tp.grad(y2, x)                # freed after the first call


# -- PyLayer's contract -------------------------------------------------------

def test_pylayer_forward_runs_without_grad_and_keeps_ctx():
    seen = {}

    class Scale(tag.PyLayer):
        @staticmethod
        def forward(ctx, x, k, factor=1.0):
            seen["grad"] = torch.is_grad_enabled()
            ctx.save_for_backward(x, k)
            ctx.factor = factor
            return x * k * factor

        @staticmethod
        def backward(ctx, g):
            x, k = ctx.saved_tensors()
            assert ctx.saved_tensor == (x, k)
            return g * k * ctx.factor, g * x * ctx.factor

    x, k = _t([1.0, 2.0]), _t([3.0, 4.0])
    out = Scale.apply(x, k, factor=2.0)
    assert seen["grad"] is False
    out.sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), [6.0, 8.0], rtol=TOL)
    np.testing.assert_allclose(k.grad.numpy(), [2.0, 4.0], rtol=TOL)


def test_pylayer_grads_per_tensor_input_drop_stop_gradient():
    """One gradient per tensor input: those of inputs that need none are
    dropped; one per differentiable input is accepted too; any other
    count raises, as in the JAX package."""
    def layer(n_grads):
        class L(tag.PyLayer):
            @staticmethod
            def forward(ctx, a, b):
                return a * b

            @staticmethod
            def backward(ctx, g):
                return tuple(g * (i + 1) for i in range(n_grads))
        return L

    a = _t([1.0, 2.0])
    b = torch.tensor([3.0, 4.0])          # stop_gradient
    layer(2).apply(a, b).sum().backward()
    np.testing.assert_allclose(a.grad.numpy(), [1.0, 1.0])
    a.grad = None
    layer(1).apply(a, b).sum().backward()
    np.testing.assert_allclose(a.grad.numpy(), [1.0, 1.0])
    with pytest.raises(RuntimeError, match="returned 3 grads"):
        layer(3).apply(a, b).sum().backward()


def test_pylayer_multiple_outputs_match_jax():
    xv = np.array([0.5, -1.0, 2.0], np.float32)

    def make(base):
        class SinCos(base):
            @staticmethod
            def forward(ctx, x):
                ctx.save_for_backward(x)
                s = pp.sin(x) if base is pp.autograd.PyLayer else \
                    torch.sin(x)
                c = pp.cos(x) if base is pp.autograd.PyLayer else \
                    torch.cos(x)
                return s, c

            @staticmethod
            def backward(ctx, gs, gc):
                (x,) = ctx.saved_tensor
                if base is pp.autograd.PyLayer:
                    return gs * pp.cos(x) - gc * pp.sin(x)
                return gs * torch.cos(x) - gc * torch.sin(x)
        return SinCos

    jx, tx = _j(xv), _t(xv)
    js, jc = make(pp.autograd.PyLayer).apply(jx)
    ts, tc = make(tag.PyLayer).apply(tx)
    (js * 2 + jc * 3).sum().backward()
    (ts * 2 + tc * 3).sum().backward()
    _close(tx.grad, jx.grad)


def test_grad_mode_api():
    assert tag.is_grad_enabled()
    with tag.no_grad():
        assert not tag.is_grad_enabled()
        with tag.enable_grad():
            assert tag.is_grad_enabled()
    with tag.set_grad_enabled(False):
        assert not tag.is_grad_enabled()
    assert tp.autograd is tag and tp.grad is tag.grad


def test_jacobian_lists_and_unused():
    xv = np.array([0.2, 0.7], np.float32)
    tx, ty = _t(xv), _t([1.5])
    jx, jy = _j(xv), _j([1.5])
    got = tag.jacobian([torch.sin(tx), tx * ty], [tx, ty])
    want = pp.autograd.jacobian([pp.sin(jx), jx * jy], [jx, jy])
    for i in range(2):
        for j in range(2):
            assert list(got[i][j].shape) == list(want[i][j].shape)
            _close(got[i][j], want[i][j])
    # ys that do not reach xs: zeros of the JAX shape
    z = tag.jacobian(ty * 2, tx)
    assert list(z.shape) == [1, 2] and not z.detach().numpy().any()
    single = tag.jacobian([torch.sin(tx)], tx)
    assert isinstance(single, list) and len(single) == 1
    with pytest.raises(ValueError):
        tag.jacobian(torch.sin(tx), tx, batch_axis=1)
    with pytest.raises(ValueError):
        tag.hessian((tx * tx).sum(), tx, batch_axis=0)
