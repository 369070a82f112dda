"""The PyTorch port's GPT pretraining slice against the JAX package on the
CPU: the fused softmax cross-entropy (loss, lse and dlogits against the
Pallas kernels in interpret mode), ``F.cross_entropy`` and
``CrossEntropyLoss`` in every branch, ``LayerNorm``, ``Dropout`` and
dropout inside attention, the ``GPTForCausalLM`` loss and every gradient,
and three ``TrainStep`` updates.  Inputs come from
``numpy.random.default_rng`` and weights are copied across; everything is
fp32 unless a test says otherwise, with the tolerance stated in each
test.  Where the JAX function routes to a Pallas kernel behind
``PADDLE_TPU_FUSED_CE``, the test runs it both ways (forced on, in
interpret mode, and off).  The kernels on the card are in
``test_torch_cuda.py``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as pp
import paddle_tpu.nn as jnn
from paddle_tpu.core.functional import functional_call, params_of
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.models import GPTConfig as JGPTConfig
from paddle_tpu.models import GPTForCausalLM as JGPTForCausalLM
from paddle_tpu.nn import functional as JF
from paddle_tpu.ops.pallas import cross_entropy as JCE
from paddle_tpu.optimizer import AdamW as JAdamW

import paddle_tpu_torch as pt
import paddle_tpu_torch.nn as tnn
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.ops.kernels import cross_entropy as CE
from paddle_tpu_torch.optimizer import AdamW


def _raw(x):
    return x._data if hasattr(x, "_data") else x


def _np(x):
    return np.asarray(_raw(x))


@pytest.fixture(params=["1", "0"], ids=["jax_fused_ce", "jax_plain_ce"])
def fused_ce(request, monkeypatch):
    """Run the JAX side with its Pallas cross-entropy forced on (interpret
    mode) and off."""
    monkeypatch.setenv("PADDLE_TPU_FUSED_CE", request.param)
    return request.param == "1"


# -- the fused softmax cross-entropy ------------------------------------------

@pytest.mark.parametrize("case", ["plain", "neg_inf_column", "out_of_range"])
def test_fused_ce_matches_pallas(case):
    """Loss, lse and dlogits (for a random per-row cotangent) of the
    port's fused CE (the plain version on the CPU) against the Pallas
    forward and backward kernels in interpret mode.  T=24, V=384: fp32
    sums over 384 classes in another order, 1e-5."""
    rng = np.random.default_rng(["plain", "neg_inf_column",
                                 "out_of_range"].index(case))
    T, V = 24, 384
    x = rng.standard_normal((T, V)).astype(np.float32) * 3
    lbl = rng.integers(0, V, T)
    if case == "neg_inf_column":
        x[:, 7] = -np.inf                     # a masked vocab entry
        lbl[lbl == 7] = 8
    if case == "out_of_range":
        lbl[[2, 5]] = [V, -3]                 # no column matches
    g = rng.standard_normal(T).astype(np.float32)
    jl = jnp.asarray(lbl, jnp.int32)
    ref_loss, ref_lse = JCE._fwd_pallas(jnp.asarray(x), jl[:, None],
                                        block_t=24, block_v=128,
                                        interpret=True)
    _, vjp = jax.vjp(lambda a: JCE.fused_softmax_cross_entropy(
        a, jl, interpret=True), jnp.asarray(x))
    (ref_dx,) = vjp(jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_(True)
    loss, lse = CE.cross_entropy_fwd(tx.detach(), torch.from_numpy(lbl))
    np.testing.assert_allclose(loss.numpy(), _np(ref_loss)[:, 0], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), _np(ref_lse)[:, 0], rtol=1e-5,
                               atol=1e-5)
    per = CE.fused_softmax_cross_entropy(tx, torch.from_numpy(lbl))
    per.backward(torch.from_numpy(g))
    np.testing.assert_allclose(per.detach().numpy(), _np(ref_loss)[:, 0],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), _np(ref_dx), rtol=1e-5,
                               atol=1e-6)
    if case == "neg_inf_column":
        assert not tx.grad[:, 7].any()        # p = 0, not NaN
    if case == "out_of_range":
        np.testing.assert_array_equal(loss[[2, 5]].numpy(),
                                      lse[[2, 5]].numpy())


def test_fused_ce_all_neg_inf_row_follows_the_kernel_arithmetic():
    """A row that is -inf throughout: lse = -inf (the max is floored at
    -1e30, as in the kernel, so no NaN comes from the sum); the gold
    logit is -inf too, so the loss is NaN, as on the TPU."""
    x = torch.zeros(3, 5)
    x[1] = -float("inf")
    loss, lse = CE.ce_fwd_reference(x, torch.tensor([0, 2, 9]))
    assert lse[1] == -float("inf") and torch.isnan(loss[1])
    assert torch.isfinite(loss[[0, 2]]).all()


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_cross_entropy_fused_route_matches_jax(fused_ce, reduction):
    """``F.cross_entropy`` on ``[B, S, V]`` logits with ``ignore_index``
    labels (and a ``[..., 1]`` label shape), value and dlogits, against
    JAX with its fused CE on and off: 1e-5.  Ignored rows get no
    gradient."""
    rng = np.random.default_rng(2)
    B, S, V = 2, 12, 256
    x = rng.standard_normal((B, S, V)).astype(np.float32)
    lbl = rng.integers(0, V, (B, S))
    lbl[0, :5] = -100
    lbl = lbl[..., None]

    def jloss(a):
        out = _raw(JF.cross_entropy(a, jnp.asarray(lbl),
                                    reduction=reduction))
        return out.sum(), out

    (_, ref), ref_dx = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    got = TF.cross_entropy(tx, torch.from_numpy(lbl), reduction=reduction)
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(ref_dx),
                               rtol=1e-5, atol=1e-6)
    assert not tx.grad[0, :5].any()


CE_BRANCHES = {
    "soft_label": dict(soft_label=True),
    "soft_label_smoothing": dict(soft_label=True, label_smoothing=0.1),
    "soft_label_weight": dict(soft_label=True, weight=True),
    "soft_label_weight_sum": dict(soft_label=True, weight=True,
                                  reduction="sum"),
    "weight": dict(weight=True),
    "weight_none": dict(weight=True, reduction="none"),
    "label_smoothing": dict(label_smoothing=0.2),
    "no_softmax": dict(use_softmax=False),
    "axis_1": dict(axis=1),
    "axis_1_weight": dict(axis=1, weight=True),
}


@pytest.mark.parametrize("case", list(CE_BRANCHES))
def test_cross_entropy_plain_branches_match_jax(case):
    """The plain fp32 branches of ``F.cross_entropy`` (soft labels, class
    weights, smoothing, probabilities without softmax, another axis),
    value and gradient against JAX: 2e-5.  Hard labels include
    ``ignore_index`` entries."""
    kw = dict(CE_BRANCHES[case])
    rng = np.random.default_rng(len(case))
    B, S, C = 3, 4, 10
    axis = kw.get("axis", -1)
    shape = (B, C, S) if axis == 1 else (B, S, C)
    x = rng.standard_normal(shape).astype(np.float32)
    if not kw.get("use_softmax", True):
        x = np.exp(x) / np.exp(x).sum(axis=-1, keepdims=True)
    if kw.get("soft_label"):
        lbl = rng.random((B, S, C)).astype(np.float32)
        lbl /= lbl.sum(-1, keepdims=True)
    else:
        lbl = rng.integers(0, C, (B, S))
        lbl[1, 2] = -100
    jkw, tkw = dict(kw), dict(kw)
    if kw.get("weight"):
        w = rng.random(C).astype(np.float32) + 0.5
        jkw["weight"], tkw["weight"] = jnp.asarray(w), torch.from_numpy(w)

    def jloss(a):
        return _raw(JF.cross_entropy(a, jnp.asarray(lbl), **jkw)).sum()

    ref, ref_dx = jax.value_and_grad(jloss)(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    got = TF.cross_entropy(tx, torch.from_numpy(lbl), **tkw).sum()
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(ref), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(ref_dx),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("kw", [dict(), dict(reduction="sum",
                                             label_smoothing=0.1),
                                dict(soft_label=True), dict(weight=True)],
                         ids=["fused", "smoothing", "soft", "weight"])
def test_cross_entropy_loss_layer_matches_jax(kw):
    """``nn.CrossEntropyLoss`` passes every option through: 2e-5."""
    kw = dict(kw)
    rng = np.random.default_rng(9)
    x = rng.standard_normal((6, 16)).astype(np.float32)
    if kw.get("soft_label"):
        lbl = rng.random((6, 16)).astype(np.float32)
    else:
        lbl = rng.integers(0, 16, 6)
        lbl[3] = -100
    jkw, tkw = dict(kw), dict(kw)
    if kw.pop("weight", False):
        w = rng.random(16).astype(np.float32) + 0.5
        jkw["weight"], tkw["weight"] = jnp.asarray(w), torch.from_numpy(w)
    ref = jnn.CrossEntropyLoss(**jkw)(jnp.asarray(x), jnp.asarray(lbl))
    got = tnn.CrossEntropyLoss(**tkw)(torch.from_numpy(x),
                                      torch.from_numpy(lbl))
    np.testing.assert_allclose(float(got), float(_np(ref)), rtol=2e-5,
                               atol=2e-5)


# -- LayerNorm and dropout ----------------------------------------------------

@pytest.mark.parametrize("shape,norm", [((2, 5, 32), 32),
                                        ((2, 5, 4, 8), [4, 8])])
@pytest.mark.parametrize("affine", [True, False])
def test_layer_norm_matches_jax(shape, norm, affine):
    """``LayerNorm`` with random weight and bias (or none) against JAX's,
    forward and input gradient: fp32, 1e-5."""
    rng = np.random.default_rng(len(shape))
    x = rng.standard_normal(shape).astype(np.float32) * 2 + 1
    attr = None if affine else False
    jl = jnn.LayerNorm(norm, epsilon=1e-5, weight_attr=attr, bias_attr=attr)
    tl = tnn.LayerNorm(norm, epsilon=1e-5, weight_attr=attr, bias_attr=attr)
    if affine:
        sd = {k: rng.standard_normal(v.shape).astype(np.float32)
              for k, v in jl.state_dict().items()}
        jl.set_state_dict(sd)
        tl.set_state_dict(sd)
    assert set(tl.state_dict()) == set(jl.state_dict())
    r = rng.standard_normal(shape).astype(np.float32)
    ref, vjp = jax.vjp(lambda a: _raw(jl(a)), jnp.asarray(x))
    (ref_dx,) = vjp(jnp.asarray(r))
    tx = torch.from_numpy(x).requires_grad_(True)
    got = tl(tx)
    got.backward(torch.from_numpy(r))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(ref_dx),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ["upscale_in_train", "downscale_in_infer"])
def test_dropout_identity_where_inactive(mode):
    """p = 0 in training and any p in eval: the identity, except that
    ``downscale_in_infer`` multiplies by 1 - p in eval, as JAX does."""
    x = np.random.default_rng(0).standard_normal((4, 6)).astype(np.float32)
    tx = torch.from_numpy(x)
    assert torch.equal(TF.dropout(tx, p=0.0, training=True, mode=mode), tx)
    got = TF.dropout(tx, p=0.3, training=False, mode=mode)
    ref = JF.dropout(jnp.asarray(x), p=0.3, training=False, mode=mode)
    np.testing.assert_allclose(got.numpy(), _np(ref), rtol=1e-6)
    layer = tnn.Dropout(0.3, mode=mode).eval()
    np.testing.assert_allclose(layer(tx).numpy(), _np(ref), rtol=1e-6)
    assert not tnn.Dropout(0.0).train()(tx).ne(tx).any()


@pytest.mark.parametrize("mode", ["upscale_in_train", "downscale_in_infer"])
@pytest.mark.parametrize("axis", [None, 1, [0, 2]])
def test_dropout_keep_rate_and_scaling(mode, axis):
    """Training at p = 0.3 over 64 x 64 x 64: the kept share of the
    mask's n draws (262,144; 64 along axis 1; 4,096 along [0, 2]) is 0.7
    within 4 standard deviations, 4 sqrt(0.21 / n); kept elements are
    x / 0.7 (upscale) or x (downscale), dropped ones 0; with `axis` the
    mask is constant along the other axes."""
    pt.seed(3)
    x = torch.rand(64, 64, 64) + 1.0           # no zeros of its own
    y = TF.dropout(x, p=0.3, axis=axis, training=True, mode=mode)
    kept = y != 0
    n = 64 ** (3 if axis is None else 1 if isinstance(axis, int) else 2)
    assert abs(float(kept.float().mean()) - 0.7) < 4 * (0.21 / n) ** 0.5
    scale = 1 / 0.7 if mode == "upscale_in_train" else 1.0
    torch.testing.assert_close(y[kept], (x * scale)[kept])
    if axis is not None:
        axes = [axis] if isinstance(axis, int) else axis
        other = [d for d in range(3) if d not in axes]
        assert (kept == kept.select(other[0], 0).unsqueeze(other[0])).all()


def test_attention_dropout_and_the_eval_identity():
    """``scaled_dot_product_attention`` with dropout: in eval (or at p =
    0) it equals the dropout-free attention; in training the
    probabilities are dropped and scaled.  With q = k = 0 every
    probability is 1/s, so each output of v = 1 is (kept keys) / (s (1 -
    p)): a multiple of that step, and 1/2 of the keys kept on average."""
    b, s, h, d = 2, 64, 2, 8
    q = torch.zeros(b, s, h, d)
    v = torch.ones(b, s, h, d)
    ref = TF.scaled_dot_product_attention(q, q, v)
    assert torch.equal(TF.scaled_dot_product_attention(
        q, q, v, dropout_p=0.5, training=False), ref)
    pt.seed(4)
    out = TF.scaled_dot_product_attention(q, q, v, dropout_p=0.5,
                                          training=True)
    kept = out[..., 0] * s * 0.5
    torch.testing.assert_close(kept, kept.round())
    assert abs(float(kept.mean()) / s - 0.5) < 0.03
    assert (out[..., 0] != ref[..., 0]).any()


# -- the model ----------------------------------------------------------------

def _pair(seed=0, **over):
    pp.seed(seed)
    jm = JGPTForCausalLM(JGPTConfig.tiny(**over))
    tm = GPTForCausalLM(GPTConfig.tiny(**over), device="cpu")
    tm.set_state_dict({k: v.numpy() for k, v in jm.state_dict().items()})
    return jm, tm


def _batch(seed, b=2, s=16, v=256):
    ids = np.random.default_rng(seed).integers(0, v, (b, s + 1))
    return ids[:, :-1], ids[:, 1:]


def test_gpt_state_dict_names_and_unported_entry_points():
    jm, tm = _pair()
    assert list(tm.state_dict()) == list(jm.state_dict())
    assert tm.lm_head is None                       # tied embeddings
    for call in (lambda: GPTForCausalLM.partition_specs(GPTConfig.tiny()),
                 lambda: GPTForCausalLM.spec_for("x", {})):
        with pytest.raises(NotImplementedError, match="queue 1, item 8"):
            call()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GPTForCausalLM(GPTConfig.tiny())            # no CUDA here


@pytest.mark.parametrize("mask", [None, "bool"])
def test_gpt_forward_matches_jax(mask):
    """Logits of the tiny model, causal (no mask) or with a bool mask,
    against JAX: fp32 through two layers, 2e-5 of values of order 10."""
    jm, tm = _pair(5)
    ids, _ = _batch(5)
    jmask = tmask = None
    if mask:
        m = np.tril(np.ones((16, 16), bool))
        m[:, 0] = True
        jmask, tmask = jnp.asarray(m), torch.from_numpy(m)
    ref = _np(jm(jnp.asarray(ids), attn_mask=jmask))
    got = tm(torch.from_numpy(ids), attn_mask=tmask)
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=2e-5,
                               atol=2e-4)


def test_gpt_loss_and_every_grad_match_jax(fused_ce):
    """``GPTForCausalLM.loss`` and the gradient of every parameter
    against ``jax.value_and_grad`` on copied weights, with JAX's fused CE
    on and off.  fp32 through two layers: loss 1e-5 relative, each grad
    within 1e-4 of its largest magnitude."""
    jm, tm = _pair(1)
    ids, lbl = _batch(3)
    params = params_of(jm)

    def f(p):
        return _raw(functional_call(jm, p, jnp.asarray(ids),
                                    jnp.asarray(lbl), method="loss"))

    ref, rgrads = jax.value_and_grad(f)(params)
    loss = tm.loss(torch.from_numpy(ids), torch.from_numpy(lbl))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(ref), rtol=1e-5)
    got = dict(tm.named_parameters())
    assert set(got) == set(rgrads)
    for n, r in rgrads.items():
        r = np.asarray(r)
        scale = float(np.abs(r).max())
        err = float(np.abs(got[n].grad.numpy() - r).max())
        assert err <= 1e-4 * scale + 1e-8, (n, err, scale)


def test_gpt_train_step_matches_jax_over_three_steps(fused_ce):
    """Three ``TrainStep`` updates (AdamW, lr 1e-3, multi_precision) of
    the tiny fp32 GPT against the JAX ``TrainStep`` on copied weights,
    JAX's fused CE on and off: each loss within 1e-5 relative, the final
    parameters within 1e-4 (a tenth of lr bounds Adam's magnification of
    fp32 ordering differences where a gradient is near zero)."""
    jm, tm = _pair(2)
    jstep = JTrainStep(jm, JAdamW(learning_rate=1e-3,
                                  parameters=jm.parameters(),
                                  multi_precision=True))
    step = TrainStep(tm, AdamW(learning_rate=1e-3, multi_precision=True))
    for i in range(3):
        ids, lbl = _batch(20 + i)
        batch = {"input_ids": ids, "labels": lbl}
        np.testing.assert_allclose(float(step(batch)),
                                   float(_raw(jstep(batch))), rtol=1e-5)
    got = step.params
    d = tm.config.hidden_size
    for n, r in jstep.params.items():
        g, r = got[n].numpy(), np.asarray(r)
        if n.endswith("qkv_proj.bias"):
            # the key bias adds q.b to every score of a row, which the
            # softmax cancels: its gradient is zero up to rounding, and
            # Adam turns that noise into steps of up to lr each
            np.testing.assert_allclose(g[d:2 * d], r[d:2 * d], atol=3e-3)
            g, r = np.delete(g, np.s_[d:2 * d]), np.delete(r, np.s_[d:2 * d])
        np.testing.assert_allclose(g, r, atol=1e-4, rtol=1e-4, err_msg=n)
