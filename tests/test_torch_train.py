"""The PyTorch port's training slice against the JAX package on the CPU:
the fused chunked lm-head + cross-entropy, the Llama loss and the
gradient of every parameter, AdamW with fp32 master weights, three
``TrainStep`` updates, and the non-finite step guard.  Inputs come from
``numpy.random.default_rng`` and weights are copied across; everything
runs in fp32 unless a test says otherwise, with the tolerance stated in
each test.  The same path on the card is in ``test_torch_cuda.py``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as pp
from paddle_tpu.core.functional import functional_call, params_of
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.models import LlamaConfig as JLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JLlamaForCausalLM
from paddle_tpu.nn import functional as JF
from paddle_tpu.optimizer import AdamW as JAdamW

import paddle_tpu_torch as pt
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.optimizer import Adam, AdamW
from paddle_tpu_torch.robustness import NonFiniteStepError

TINY = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=128)


def _raw(x):
    return x._data if hasattr(x, "_data") else x


def _pair(seed=0):
    pp.seed(seed)
    jm = JLlamaForCausalLM(JLlamaConfig.tiny(**TINY))
    tm = LlamaForCausalLM(LlamaConfig.tiny(**TINY), device="cpu")
    tm.set_state_dict({k: v.numpy() for k, v in jm.state_dict().items()})
    return jm, tm


def _batch(seed, b=2, s=16):
    ids = np.random.default_rng(seed).integers(0, 256, (b, s + 1))
    return ids[:, :-1], ids[:, 1:]


# -- fused lm-head + cross-entropy --------------------------------------------

@pytest.mark.parametrize("reduction", ["mean", "sum"])
def test_fused_linear_cross_entropy_matches_jax(reduction):
    """V=1000 over chunks of 256 (the last one padded), with
    ``ignore_index`` entries: loss, dh and dW against JAX.  fp32 sums over
    1000 classes and 64 features in another order: 1e-5."""
    rng = np.random.default_rng(0)
    T, d, V = 24, 64, 1000
    h = rng.standard_normal((T, d)).astype(np.float32)
    w = (rng.standard_normal((d, V)) * 0.1).astype(np.float32)
    lbl = rng.integers(0, V, T)
    lbl[[3, 10, 17]] = -100

    def jloss(hh, ww):
        return _raw(JF.fused_linear_cross_entropy(
            hh, ww, jnp.asarray(lbl), chunk_size=256, reduction=reduction))

    ref, (rdh, rdw) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(h), jnp.asarray(w))
    th = torch.from_numpy(h).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    loss = TF.fused_linear_cross_entropy(th, tw, torch.from_numpy(lbl),
                                         chunk_size=256, reduction=reduction)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(ref), rtol=1e-5)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(rdh), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(rdw), atol=1e-5,
                               rtol=1e-5)
    assert not th.grad[[3, 10, 17]].any()     # ignored rows: no gradient


def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 30)).astype(np.float32)
    lbl = rng.integers(0, 30, (2, 5))
    lbl[0, 1] = -100
    ref = JF.cross_entropy(jnp.asarray(x), jnp.asarray(lbl))
    got = TF.cross_entropy(torch.from_numpy(x), torch.from_numpy(lbl))
    np.testing.assert_allclose(float(got), float(_raw(ref)), rtol=1e-6)


# -- the model ----------------------------------------------------------------

def test_llama_loss_and_every_grad_match_jax():
    """``LlamaForCausalLM.loss`` and the gradient of every parameter
    against ``jax.value_and_grad`` on copied weights.  fp32 through two
    layers: loss 1e-5 relative, each grad within 1e-4 of its largest
    magnitude."""
    jm, tm = _pair()
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


def test_engine_forward_builds_no_graph():
    """The parameters are trainable now; the serving engine still runs
    under ``inference_mode``, so its logits carry no graph."""
    from paddle_tpu_torch.inference import ContinuousBatchingEngine
    _, tm = _pair()
    assert all(p.requires_grad for p in tm.parameters())
    eng = ContinuousBatchingEngine(tm, slots=1, max_len=32,
                                   prefill_buckets=(8, 16), kv_block_size=4,
                                   prefill_chunk=8, paged_kv=True)
    bt = np.zeros((1, eng._max_blocks), np.int32)
    first = eng._run("serving.prefill_chunk", eng._prefill_chunk_body,
                     ids=np.zeros((1, 8), np.int64), bt=bt,
                     start=np.zeros(1, np.int32),
                     last_idx=np.array(2, np.int64))
    assert first.is_inference() and first.grad_fn is None
    assert not any(p.requires_grad for p in eng._pool.kpools)


# -- the optimizer ------------------------------------------------------------

def test_adamw_multi_precision_matches_jax():
    """bf16 parameters with an fp32 master, weight decay 0.01, three
    updates from fixed bf16 grads, against ``AdamW.apply_gradients`` at
    an int32 device count, as the JAX ``TrainStep`` calls it (the bias
    corrections in fp32 on both sides).  Master and moments agree to
    fp32 rounding (1e-6); the bf16 parameters are the masters' rounding,
    and within one bf16 step of JAX's."""
    import ml_dtypes
    rng = np.random.default_rng(2)
    shapes = {"w": (8, 16), "b": (16,)}
    p0 = {n: rng.standard_normal(sh).astype(ml_dtypes.bfloat16)
          for n, sh in shapes.items()}
    grads = [{n: (rng.standard_normal(sh) * 0.1).astype(ml_dtypes.bfloat16)
              for n, sh in shapes.items()} for _ in range(3)]
    jopt = JAdamW(learning_rate=1e-2, weight_decay=0.01,
                  multi_precision=True)
    jp = {n: jnp.asarray(a) for n, a in p0.items()}
    js = jopt.init_state_pytree(jp)
    for i, g in enumerate(grads):
        jp, js = jopt.apply_gradients(jp, {n: jnp.asarray(a)
                                           for n, a in g.items()}, js,
                                      jnp.asarray(i + 1, jnp.int32))
    tp = [torch.from_numpy(p0[n].view(np.int16)).view(torch.bfloat16)
          .clone().requires_grad_(True) for n in shapes]
    opt = AdamW(learning_rate=1e-2, weight_decay=0.01, parameters=tp,
                multi_precision=True)
    for g in grads:
        for t, n in zip(tp, shapes):
            t.grad = torch.from_numpy(g[n].view(np.int16)).view(
                torch.bfloat16)
        opt.step()
    for t, n in zip(tp, shapes):
        st = opt._accumulators[id(t)]
        for key in ("_master", "moment1", "moment2"):
            np.testing.assert_allclose(st[key].numpy(),
                                       np.asarray(js[n][key]), rtol=1e-6,
                                       atol=1e-7, err_msg=f"{n}.{key}")
        assert t.dtype == torch.bfloat16
        assert torch.equal(t.detach(), st["_master"].to(torch.bfloat16))
        np.testing.assert_allclose(t.detach().float().numpy(),
                                   np.asarray(jp[n]).astype(np.float32),
                                   rtol=2 ** -7, atol=1e-6)


def test_adam_l2_decay_folds_into_the_gradient():
    """Adam's weight decay is L2 in the gradient (not decoupled): one
    fp32 update against JAX's rule."""
    from paddle_tpu.optimizer import Adam as JAdam
    rng = np.random.default_rng(4)
    p0 = rng.standard_normal((5, 3)).astype(np.float32)
    g = rng.standard_normal((5, 3)).astype(np.float32)
    jopt = JAdam(learning_rate=1e-2, weight_decay=0.1)
    jp, _ = jopt.apply_gradients({"p": jnp.asarray(p0)},
                                 {"p": jnp.asarray(g)},
                                 jopt.init_state_pytree(
                                     {"p": jnp.asarray(p0)}),
                                 jnp.asarray(1, jnp.int32))
    t = torch.from_numpy(p0.copy()).requires_grad_(True)
    opt = Adam(learning_rate=1e-2, weight_decay=0.1, parameters=[t])
    t.grad = torch.from_numpy(g)
    opt.step()
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(jp["p"]),
                               rtol=1e-6, atol=1e-7)


def test_unported_options_name_the_roadmap():
    """What stays unported raises, naming its queue 1 item: meshes,
    ``param_specs`` and ``shardings`` (item 8), and a row-sparse
    gradient, in the optimizer (``lazy_mode`` itself is ported: dense
    gradients take the same update) and in the global clip (item 7)."""
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    _, tm = _pair()
    opt = AdamW()
    for kw in (dict(mesh=object()), dict(param_specs={}),
               dict(shardings={})):
        with pytest.raises(NotImplementedError, match="queue 1, item 8"):
            TrainStep(tm, opt, **kw)
    p = torch.zeros(4, 3, requires_grad=True)
    p.grad = torch.sparse_coo_tensor([[0, 2]], torch.ones(2, 3), (4, 3))
    with pytest.raises(NotImplementedError, match="queue 1, item 7"):
        Adam(parameters=[p], lazy_mode=True).step()
    with pytest.raises(NotImplementedError, match="queue 1, item 7"):
        ClipGradByGlobalNorm(1.0)([(p, p.grad)])


# -- the training step --------------------------------------------------------

def test_train_step_matches_jax_over_three_steps():
    """Three ``TrainStep`` updates (AdamW, lr 1e-3, multi_precision) on
    the tiny fp32 config against the JAX ``TrainStep`` on copied
    weights: each loss within 1e-5 relative; the final parameters within
    1e-4 (Adam moves each element by about lr * g / |g|, which magnifies
    fp32 ordering differences where a gradient is near zero; a tenth of
    lr bounds them)."""
    jm, tm = _pair(1)
    jstep = JTrainStep(jm, JAdamW(learning_rate=1e-3,
                                  parameters=jm.parameters(),
                                  multi_precision=True))
    step = TrainStep(tm, AdamW(learning_rate=1e-3, multi_precision=True))
    for i in range(3):
        ids, lbl = _batch(10 + i)
        batch = {"input_ids": ids, "labels": lbl}
        ref = float(_raw(jstep(batch)))
        got = float(step(batch))
        np.testing.assert_allclose(got, ref, rtol=1e-5)
    assert step.step_count == 3
    got = step.params
    for n, r in jstep.params.items():
        np.testing.assert_allclose(got[n].numpy(), np.asarray(r), atol=1e-4,
                                   rtol=1e-4, err_msg=n)
    step.sync_to_model()      # a no-op: the Layer's parameters are the step's
    assert got["lm_head.weight"].data_ptr() == \
        tm.lm_head.weight.data_ptr()


def test_guard_skips_a_nonfinite_step_and_raises_after_k():
    """A NaN-poisoned parameter: the step is skipped with parameters,
    optimizer state and step count bitwise unchanged; the second skip in
    a row raises ``NonFiniteStepError``."""
    _, tm = _pair(2)
    opt = AdamW(learning_rate=1e-3, multi_precision=True)
    step = TrainStep(tm, opt, guard_nonfinite=True, max_consecutive_skips=2)
    ids, lbl = _batch(5)
    batch = {"input_ids": ids, "labels": lbl}
    step(batch)                                   # one applied update
    with torch.no_grad():
        tm.model.norm.weight[3] = float("nan")
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    state = {k: {n: t.clone() for n, t in st.items()}
             for k, st in opt._accumulators.items()}
    loss = step(batch)
    assert not torch.isfinite(loss)
    assert step.step_count == 1 and step.skipped["nonfinite_loss"] == 1
    for n, p in tm.named_parameters():
        assert np.array_equal(p.detach().numpy(), before[n].numpy(),
                              equal_nan=True), n
        assert p.grad is None
    for k, st in opt._accumulators.items():
        for n, t in st.items():
            assert torch.equal(t, state[k][n]), n
    with pytest.raises(NonFiniteStepError, match="2 consecutive"):
        step(batch)


def test_guard_env_defaults_keep_their_names(monkeypatch):
    _, tm = _pair()
    monkeypatch.setenv("PADDLE_TPU_STEP_GUARD", "0")
    monkeypatch.setenv("PADDLE_TPU_MAX_SKIP_STEPS", "7")
    step = TrainStep(tm, AdamW())
    assert step._guard_nonfinite is False and step._max_skips == 7
    with pytest.raises(ValueError, match=">= 1"):
        TrainStep(tm, AdamW(), max_consecutive_skips=0)


def test_layer_parameters_follow_the_state_dict():
    _, tm = _pair()
    names = [n for n in tm.state_dict()]
    params = tm.parameters()
    assert isinstance(params, list)
    assert [id(p) for p in params] == \
        [id(dict(tm.named_parameters())[n]) for n in names]
    tm.loss(*map(torch.from_numpy, _batch(1))).backward()
    assert all(p.grad is not None for p in params)
    tm.clear_gradients()
    assert all(p.grad is None for p in params)
    pt.seed(0)
