"""The port's optimizer module against the JAX package on the CPU: every
LR scheduler's values, the three gradient clips, every optimizer's rule
over three updates, ``Optimizer.state_dict`` round trips, and the
multi-tensor Adam / AdamW update's plain version against the
per-parameter rule.  Inputs come from ``numpy.random.default_rng``;
everything is fp32 unless a test says otherwise, with the tolerance
stated in each test.  The multi-tensor kernels on the card are in
``test_torch_cuda.py``."""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu.nn as jnn
import paddle_tpu.optimizer as jopt
from paddle_tpu.optimizer import lr as jlr

import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.optimizer as topt
from paddle_tpu_torch.ops.kernels import multi_tensor as MT
from paddle_tpu_torch.optimizer import lr as tlr
from paddle_tpu_torch.optimizer.optimizer import Optimizer

STEPS = 30


def _schedulers(m):
    """``{name: scheduler}`` built from module `m` (the JAX package's
    ``optimizer.lr`` or the port's), one of each of the 16 kinds."""
    return {
        "Noam": lambda: m.NoamDecay(d_model=64, warmup_steps=5,
                                    learning_rate=2.0),
        "Exponential": lambda: m.ExponentialDecay(0.1, gamma=0.9),
        "NaturalExp": lambda: m.NaturalExpDecay(0.1, gamma=0.3),
        "InverseTime": lambda: m.InverseTimeDecay(0.1, gamma=0.5),
        "Polynomial": lambda: m.PolynomialDecay(0.1, decay_steps=7,
                                                end_lr=0.01, power=2.0,
                                                cycle=True),
        "LinearWarmup": lambda: m.LinearWarmup(
            m.CosineAnnealingDecay(0.1, T_max=12), warmup_steps=5,
            start_lr=0.0, end_lr=0.1),
        "Piecewise": lambda: m.PiecewiseDecay([4, 9, 20], [0.1, 0.05, 0.01,
                                                           0.001]),
        "CosineAnnealing": lambda: m.CosineAnnealingDecay(0.1, T_max=10,
                                                          eta_min=0.01),
        "CosineAnnealingWarmRestarts": lambda: m.CosineAnnealingWarmRestarts(
            0.1, T_0=3, T_mult=2, eta_min=0.001),
        "Step": lambda: m.StepDecay(0.1, step_size=4, gamma=0.5),
        "MultiStep": lambda: m.MultiStepDecay(0.1, milestones=[3, 8, 17],
                                              gamma=0.3),
        "Lambda": lambda: m.LambdaDecay(0.1, lambda e: 0.95 ** e),
        "Multiplicative": lambda: m.MultiplicativeDecay(0.1,
                                                        lambda e: 0.9),
        "ReduceOnPlateau": lambda: m.ReduceOnPlateau(
            0.1, factor=0.5, patience=2, cooldown=1, min_lr=0.001),
        "OneCycle": lambda: m.OneCycleLR(0.1, total_steps=25,
                                         three_phase=False),
        "Cyclic": lambda: m.CyclicLR(0.01, 0.1, step_size_up=4,
                                     step_size_down=6, mode="triangular2"),
    }


def _run(sched, name):
    """30 values of `sched`, stepping it after each (ReduceOnPlateau on a
    metric that stalls)."""
    out = []
    for i in range(STEPS):
        out.append(sched())
        if name == "ReduceOnPlateau":
            sched.step(metrics=1.0 / (1 + i) if i < 6 else 0.2)
        else:
            sched.step()
    return out, sched.state_dict()


@pytest.mark.parametrize("name", sorted(_schedulers(tlr)))
def test_scheduler_values_equal_jax(name):
    """30 values of each of the 16 schedulers: the port's copy equals
    the JAX package's float for float, and so does its state dict."""
    ref, ref_state = _run(_schedulers(jlr)[name](), name)
    got, state = _run(_schedulers(tlr)[name](), name)
    assert got == ref
    assert state == ref_state
    assert all(isinstance(v, float) and math.isfinite(v) for v in got)


def _grads(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    shapes = {"a": (6, 5), "b": (5,), "c": (3, 4, 2)}
    return {n: (rng.standard_normal(sh) * scale).astype(np.float32)
            for n, sh in shapes.items()}


@pytest.mark.parametrize("clip,scale", [
    ("global", 1.0), ("global", 0.05), ("norm", 1.0), ("value", 1.0)])
def test_clips_match_jax(clip, scale):
    """Each clip on three gradients against JAX's ``apply_pytree``
    (clipping and not clipping, by the gradients' scale): within 1e-6
    (fp32 sums of squares in another order)."""
    make = {"global": lambda m: m.ClipGradByGlobalNorm(clip_norm=1.5),
            "norm": lambda m: m.ClipGradByNorm(clip_norm=1.5),
            "value": lambda m: m.ClipGradByValue(max=0.7, min=-0.4)}[clip]
    g = _grads(1, scale)
    ref = make(jnn).apply_pytree({n: jnp.asarray(a) for n, a in g.items()})
    got = make(tnn).clip([torch.from_numpy(g[n]) for n in sorted(g)])
    for n, t in zip(sorted(g), got):
        np.testing.assert_allclose(t.numpy(), np.asarray(ref[n]), atol=1e-6,
                                   rtol=1e-6, err_msg=n)
    # the pairs form (what an eager caller passes) gives the same values
    params = [torch.zeros(1) for _ in g]
    pairs = make(tnn)(list(zip(params, [torch.from_numpy(g[n])
                                        for n in sorted(g)])))
    for (_, a), b in zip(pairs, got):
        assert torch.equal(a, b)


def test_global_clip_rounds_a_bf16_gradient_to_bf16():
    """A bf16 gradient is scaled in fp32 and cast back to bf16, as the
    reference casts it: bf16 out, within one bf16 rounding of JAX's (the
    two fp32 scales may differ in their last bit)."""
    import ml_dtypes
    g = {n: a.astype(ml_dtypes.bfloat16) for n, a in _grads(2).items()}
    ref = jnn.ClipGradByGlobalNorm(0.5).apply_pytree(
        {n: jnp.asarray(a) for n, a in g.items()})
    got = tnn.ClipGradByGlobalNorm(0.5).clip(
        [torch.from_numpy(g[n].view(np.int16)).view(torch.bfloat16)
         for n in sorted(g)])
    for n, t in zip(sorted(g), got):
        assert t.dtype == torch.bfloat16
        np.testing.assert_allclose(t.float().numpy(),
                                   np.asarray(ref[n]).astype(np.float32),
                                   rtol=2 ** -8, atol=0, err_msg=n)


# name, constructor keyword arguments (both packages take the same)
OPTIMIZERS = [
    ("SGD", dict(weight_decay=0.01)),
    ("Momentum", dict(momentum=0.9)),
    ("Momentum", dict(momentum=0.8, use_nesterov=True, weight_decay=0.02)),
    ("Adam", dict(weight_decay=0.05)),
    ("Adam", dict(lazy_mode=True)),
    ("AdamW", dict(weight_decay=0.1,
                   apply_decay_param_fun=lambda n: "b" not in n)),
    ("AdamW", dict(weight_decay=0.1, lr_ratio=lambda p: 0.5)),
    ("Adagrad", dict(initial_accumulator_value=0.1)),
    ("RMSProp", dict(momentum=0.5)),
    ("RMSProp", dict(centered=True)),
    ("Adadelta", dict()),
    ("Adamax", dict(weight_decay=0.01)),
    ("Lamb", dict(exclude_from_weight_decay_fn=lambda n: "b" in n)),
]


@pytest.mark.parametrize("name,kw", OPTIMIZERS,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(OPTIMIZERS)])
def test_optimizer_three_steps_match_jax(name, kw):
    """Three updates of each optimizer from fixed gradients, against the
    JAX optimizer's ``apply_gradients`` at an int32 count and an fp32 lr
    (as its TrainStep calls it), and the port's optimizer driven as its
    TrainStep drives it: parameters and every state tensor within 2e-6.
    Parameters are named as the JAX pytree path names them (``['a']``),
    so a name filter sees the same string on both sides."""
    rng = np.random.default_rng(3)
    p0 = {n: rng.standard_normal(a.shape).astype(np.float32)
          for n, a in _grads(0).items()}
    grads = [_grads(10 + i, 0.5) for i in range(3)]
    lr = 0.01
    jo = getattr(jopt, name)(learning_rate=lr, **kw)
    jp = {n: jnp.asarray(a) for n, a in p0.items()}
    js = jo.init_state_pytree(jp)
    for i, g in enumerate(grads):
        jp, js = jo.apply_gradients(jp, {n: jnp.asarray(a)
                                         for n, a in g.items()}, js,
                                    jnp.asarray(i + 1, jnp.int32),
                                    lr=jnp.asarray(lr, jnp.float32))
    names = sorted(p0)
    tp = [torch.from_numpy(p0[n].copy()) for n in names]
    to = getattr(topt, name)(learning_rate=lr, **kw)
    for i, g in enumerate(grads):
        to._apply_gradients([f"['{n}']" for n in names], tp,
                            [torch.from_numpy(g[n]) for n in names],
                            torch.tensor(i + 1, dtype=torch.int32),
                            torch.tensor(lr))
    for t, n in zip(tp, names):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(jp[n]),
                                   atol=2e-6, rtol=0, err_msg=n)
        st = to._accumulators[id(t)]
        assert set(st) == set(js[n])
        for k, v in st.items():
            np.testing.assert_allclose(v.float().numpy(),
                                       np.asarray(js[n][k]), atol=2e-6,
                                       rtol=0, err_msg=f"{n}.{k}")


def test_scheduler_and_set_lr():
    """A scheduler drives ``get_lr``; ``set_lr`` then raises, as in the
    reference."""
    sched = tlr.StepDecay(0.1, step_size=2, gamma=0.5)
    opt = topt.AdamW(learning_rate=sched)
    seen = []
    for _ in range(5):
        seen.append(opt.get_lr())
        sched.step()
    assert seen == [0.1, 0.1, 0.05, 0.05, 0.025]
    with pytest.raises(RuntimeError, match="scheduler"):
        opt.set_lr(0.3)


def test_optimizer_state_dict_round_trips():
    """Two AdamW updates of bf16 parameters with fp32 masters under a
    scheduler and a global clip; the state dict (keys ``global_step``,
    ``LR_Scheduler``, ``accumulators`` by parameter name with moment1,
    moment2 and _master as numpy) loaded into a fresh optimizer over
    copies of the parameters; one more update of each: bitwise equal."""
    rng = np.random.default_rng(5)

    def params():
        return [torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
                .to(torch.bfloat16).requires_grad_(True)
                for sh in ((4, 6), (6,))]

    def opt(ps):
        return topt.AdamW(
            learning_rate=tlr.LinearWarmup(
                tlr.CosineAnnealingDecay(0.01, T_max=8), warmup_steps=2,
                start_lr=0.0, end_lr=0.01),
            parameters=ps, multi_precision=True,
            grad_clip=tnn.ClipGradByGlobalNorm(0.5))

    pa = params()
    oa = opt(pa)
    grads = [[torch.from_numpy(rng.standard_normal(tuple(p.shape))
                               .astype(np.float32)).to(torch.bfloat16)
              for p in pa] for _ in range(3)]

    def update(o, ps, g):
        for p, gg in zip(ps, g):
            p.grad = gg.clone()
        o.step()
        o._lr_scheduler.step()

    for g in grads[:2]:
        update(oa, pa, g)
    state = oa.state_dict()
    assert state["global_step"] == 2 and "LR_Scheduler" in state
    assert sorted(state["accumulators"]) == ["param_0", "param_1"]
    assert sorted(state["accumulators"]["param_0"]) == \
        ["_master", "moment1", "moment2"]
    assert all(isinstance(v, np.ndarray)
               for v in state["accumulators"]["param_1"].values())
    pb = [p.detach().clone().requires_grad_(True) for p in pa]
    ob = opt(pb)
    ob.set_state_dict(state)
    update(oa, pa, grads[2])
    update(ob, pb, grads[2])
    for a, b in zip(pa, pb):
        assert torch.equal(a, b)
    for a, b in zip(pa, pb):
        for k in ("moment1", "moment2", "_master"):
            assert torch.equal(oa._accumulators[id(a)][k],
                               ob._accumulators[id(b)][k])


def _mixed(seed):
    """Five parameters of mixed kinds: fp32; bf16 with an fp32 master;
    bf16 without one (its gradient bf16, or fp32 as accumulation gives
    it); and an empty one."""
    rng = np.random.default_rng(seed)

    def t(sh, dt):
        return torch.from_numpy(rng.standard_normal(sh).astype(
            np.float32)).to(dt)
    params = [t((7, 9), torch.float32), t((70001,), torch.bfloat16),
              t((3, 5), torch.bfloat16), t((4, 4), torch.bfloat16),
              t((0,), torch.float32)]
    grads = [t(tuple(p.shape), dt) for p, dt in zip(
        params, (torch.float32, torch.bfloat16, torch.bfloat16,
                 torch.float32, torch.float32))]
    masters = [None, params[1].float(), None, None, None]
    return params, grads, masters


@pytest.mark.parametrize("decoupled", [False, True])
@pytest.mark.parametrize("keep", [None, True, False])
def test_multi_tensor_adam_plain_version_matches_the_per_parameter_rule(
        decoupled, keep):
    """``multi_tensor_adam`` on CPU tensors (the plain version, what the
    kernel is held against) against the optimizers' per-parameter path
    (clip, fp32 cast, L2 decay, master, rule, in place; the one the
    other rules take) with Adam's rule as its ``_update``, on the same
    mixed set, over two updates with a clip scale, per-parameter decay
    and the keep flag: bitwise equal; with keep False nothing changes."""
    base = topt.AdamW if decoupled else topt.Adam

    class cls(base):
        def _update(self, p, g, s, lr, step):
            bc1 = MT.bias_correction(self._beta1, step, p.device)
            bc2 = MT.bias_correction(self._beta2, step, p.device)
            w, m, v = MT.adam_rule(
                p.float(), g.float(), s["moment1"], s["moment2"], lr, bc1,
                bc2, self._beta1, self._beta2, self._eps,
                self._decoupled_wd(self._current_param_name))
            return w, {"moment1": m, "moment2": v}

    pa, ga, ma = _mixed(7)
    pb = [p.clone() for p in pa]
    opt = cls(learning_rate=0.01, weight_decay=0.05, multi_precision=False)
    names = [f"p{i}" for i in range(len(pa))]
    for n, p, m in zip(names, pb, ma):
        st = opt._state_of(p, n)
        if m is not None:
            st["_master"] = m.clone()
    moments = [(torch.zeros(p.shape), torch.zeros(p.shape)) for p in pa]
    scale = torch.tensor(0.7)
    keep_t = None if keep is None else torch.tensor(keep)
    for step in (1, 2):
        MT.multi_tensor_adam(
            pa, ga, [m for m, _ in moments], [v for _, v in moments], ma,
            lr=torch.tensor(0.01), step=torch.tensor(step, dtype=torch.int32),
            weight_decays=[0.05] * 5, decoupled=decoupled, scale=scale,
            keep=keep_t)
        Optimizer._update_all(opt, names, pb, ga, torch.tensor(0.01),
                              torch.tensor(step, dtype=torch.int32), scale,
                              keep_t)
    p0, _, _ = _mixed(7)
    for i, (a, b) in enumerate(zip(pa, pb)):
        assert torch.equal(a, b), i
        st = opt._accumulators[id(b)]
        assert torch.equal(moments[i][0], st["moment1"])
        assert torch.equal(moments[i][1], st["moment2"])
        if ma[i] is not None:
            assert torch.equal(ma[i], st["_master"])
        assert torch.equal(a, p0[i]) == (keep is False) or a.numel() == 0


def test_multi_tensor_norm_plain_version():
    """The norm's plain version: sqrt of fp32 sums of squares over mixed
    bf16 / fp32 tensors, against float64 numpy within 1e-6 relative."""
    params, grads, _ = _mixed(8)
    got = MT.multi_tensor_norm(grads)
    ref = math.sqrt(sum(float((g.double() ** 2).sum()) for g in grads))
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), ref, rtol=1e-6)
