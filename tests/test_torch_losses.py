"""The losses of the port against the JAX package's on the CPU:
``chip_smoke.loss_cases()`` (every loss functional of
``nn/functional/loss.py`` but the kernel-routed two, each reduction,
``flash_attn_unpadded`` and ``flash_attention``) through JAX's function and the port's on the
same seeded numpy inputs: every float output, and the gradient of
``sum(out * cot)`` with respect to the listed inputs (``jax.grad``
against torch's autograd).  fp32, 1e-5 relative with 1e-6 absolute (the
softmax and the CTC recursion sum in other orders).  Each loss layer
equals its functional exactly; ``reduction`` names outside JAX's raise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.nn.functional as JF

import chip_smoke
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.nn.functional as TF

RTOL, ATOL = 1e-5, 1e-6
CASES = chip_smoke.loss_cases()
LAYERS = chip_smoke.loss_layer_cases()


def _jax_arg(a):
    if isinstance(a, np.ndarray):
        return jnp.asarray(a.astype(np.int32) if a.dtype.kind in "iu"
                           else a)
    return a


def _run_jax(name, args, diff, kw):
    fn = getattr(JF, name).__wrapped_pure__
    js = [_jax_arg(a) for a in args]
    jkw = {k: _jax_arg(v) for k, v in kw.items()}

    def call(*d):
        full = list(js)
        for i, v in zip(diff, d):
            full[i] = v
        return fn(*full, **jkw)

    out = call(*[js[i] for i in diff])
    outs = out if isinstance(out, tuple) else (out,)
    cot = jnp.asarray(chip_smoke.loss_cot(outs[0].shape))

    def scalar(*d):
        o = call(*d)
        return jnp.sum((o[0] if isinstance(o, tuple) else o) * cot)
    grads = jax.grad(scalar, argnums=tuple(range(len(diff))))(
        *[js[i] for i in diff]) if diff else ()
    return ([np.asarray(o) for o in outs if o is not None],
            [np.asarray(g) for g in grads])


def _run_torch(name, args, diff, kw):
    outs, grads = chip_smoke.loss_run(name, args, diff, kw, "cpu")
    return [o.numpy() for o in outs], [g.numpy() for g in grads]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_loss_matches_jax(case):
    _, name, args, diff, kw = case
    j_out, j_grads = _run_jax(name, args, diff, kw)
    t_out, t_grads = _run_torch(name, args, diff, kw)
    assert len(j_out) == len(t_out)
    for j, t in zip(j_out, t_out):
        assert j.shape == t.shape
        np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL)
    for j, t in zip(j_grads, t_grads):
        assert j.shape == t.shape
        np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL)


def test_infeasible_ctc_costs_the_sentinel():
    """More labels than frames: JAX's -1e30 sentinel gives ~1e30, never
    inf, and a finite gradient; the feasible row stays finite."""
    case = dict((c[0], c) for c in CASES)["ctc_loss-infeasible"]
    out, grads = _run_torch(*case[1:])
    assert out[0][0] > 1e29 and out[0][1] < 1e3
    assert np.isfinite(grads[0]).all()


@pytest.mark.parametrize("case", LAYERS, ids=[c[0] for c in LAYERS])
def test_loss_layer_equals_functional(case):
    layer, ckw, name, args, fkw = case
    ts = [torch.from_numpy(a) for a in args]
    got = getattr(tnn, layer)(**ckw)(*ts)
    want = getattr(TF, name)(*ts, **fkw)
    assert torch.equal(got, want)


def test_layers_and_functions_cover_jax():
    import paddle_tpu.nn as jnn
    import paddle_tpu.nn.functional.loss as jloss
    import paddle_tpu.nn.loss_layers as jlayers
    from paddle_tpu_torch.nn.functional import loss as tloss
    from paddle_tpu_torch.nn import loss_layers as tlayers
    assert set(jloss.__all__) <= set(tloss.__all__)
    assert set(jlayers.__all__) <= set(tlayers.__all__)
    assert all(hasattr(tnn, n) for n in jlayers.__all__)
    assert all(hasattr(TF, n) for n in jloss.__all__)
    assert hasattr(TF, "flash_attn_unpadded") and hasattr(jnn, "CTCLoss")
    import paddle_tpu.nn.functional.attention as jatt
    import paddle_tpu.nn.functional.common as jcommon
    from paddle_tpu_torch.nn.functional import attention as tatt
    from paddle_tpu_torch.nn.functional import common as tcommon
    assert set(jatt.__all__) <= set(tatt.__all__)
    assert set(jcommon.__all__) <= set(tcommon.__all__)
    tested = {c[1] for c in CASES} | {"cross_entropy",
                                      "fused_linear_cross_entropy"}
    assert set(jloss.__all__) - tested == set()
    assert {c[0] for c in LAYERS} == set(jlayers.__all__)


@pytest.mark.parametrize("name", ["mse_loss", "l1_loss", "huber_loss"])
def test_unknown_reduction_raises(name):
    x = torch.zeros(3)
    with pytest.raises(ValueError, match="reduction"):
        getattr(TF, name)(x, x, reduction="avg")


def test_unpadded_dropout_draws_from_the_port_stream():
    """Dropout's mask comes from the port's generator: two calls under
    one seed agree, and the kept probabilities are scaled by 1/(1-p)."""
    import paddle_tpu_torch as tp
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((6, 2, 4)).astype(
        np.float32)) for _ in range(3))
    cu = torch.tensor([0, 2, 6], dtype=torch.int32)
    tp.seed(3)
    a = TF.flash_attn_unpadded(q, k, v, cu, cu, 4, 4, dropout=0.5,
                               return_softmax=True)
    tp.seed(3)
    b = TF.flash_attn_unpadded(q, k, v, cu, cu, 4, 4, dropout=0.5,
                               return_softmax=True)
    full = TF.flash_attn_unpadded(q, k, v, cu, cu, 4, 4,
                                  return_softmax=True)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    kept = a[1] != 0
    torch.testing.assert_close(a[1][kept], full[1][kept] * 2.0)
    assert 0 < int(kept.sum()) < int((full[1] != 0).sum())
