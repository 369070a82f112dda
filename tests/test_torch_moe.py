"""The PyTorch port's MoE training slice against the JAX package on the
CPU: the initializer's fans, GShard gating (ties, capacity drops), the
grouped expert FFN's plain version against the JAX kernel in interpret
mode and its reference, ``MoELayer`` in both dispatch modes with
``PADDLE_TPU_GROUPED_MOE`` on and off, the ERNIE 4.5 decoder's logits,
loss and every gradient, and three ``TrainStep`` updates.  Inputs come
from ``numpy.random.default_rng`` and weights are copied across;
everything runs in fp32 unless a test says otherwise, with the tolerance
stated in each test.  The kernel itself is held against its plain version
on the card in ``test_torch_cuda.py``."""

import math
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as pp
import paddle_tpu.distributed as jdist
from paddle_tpu.core.dispatch import unwrap
from paddle_tpu.core.functional import functional_call, params_of
from paddle_tpu.distributed import moe as JM
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.models import ErnieForCausalLM as JErnieForCausalLM
from paddle_tpu.models import ernie45_moe_config as jernie45_moe_config
from paddle_tpu.nn import initializer as JI
from paddle_tpu.ops.pallas import grouped_matmul as JGM
from paddle_tpu.optimizer import AdamW as JAdamW

import paddle_tpu_torch as pt
from paddle_tpu_torch.distributed import moe as TM
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import ErnieForCausalLM, ernie45_moe_config
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.nn import initializer as TI
from paddle_tpu_torch.ops.kernels import grouped_matmul as TGM
from paddle_tpu_torch.optimizer import AdamW

TINY = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
            moe_intermediate_size=32, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, num_experts=8,
            num_experts_per_tok=3, num_shared_experts=2,
            max_position_embeddings=128, dtype="float32")


def _np(t):
    return t.detach().numpy()


def _torch(a):
    return torch.from_numpy(np.asarray(a).copy())


# -- the initializer ----------------------------------------------------------

@pytest.mark.parametrize("shape", [(), (7,), (5, 9), (4, 6, 3),
                                   (3, 4, 5, 2)])
def test_fans_follow_the_jax_rule(shape):
    assert TI._fans(shape) == JI._fans(shape)


def test_xavier_std_of_a_stacked_expert_weight():
    """An [E, d, h] XavierNormal parameter draws with std
    sqrt(2 / (d h + E h)), the JAX package's fans; 65,536 draws put the
    sample std within 3% of it."""
    E, d, h = 16, 64, 64
    pt.seed(0)
    w = TI.XavierNormal()((E, d, h), "float32", "cpu")
    want = math.sqrt(2.0 / (d * h + E * h))
    assert abs(float(w.std()) / want - 1) < 0.03
    pt.seed(0)
    ffn = TM.ExpertFFN(E, d, h)
    assert abs(float(ffn.w1.detach().std()) / want - 1) < 0.03


# -- gating -------------------------------------------------------------------

def _gating_pair(logits, k, capacity):
    ref = JM.top_k_gating_indices(jnp.asarray(logits), k=k,
                                  capacity=capacity)
    got = TM.top_k_gating_indices(_torch(logits), k, capacity)
    return ref, got


@pytest.mark.parametrize("case", ["random", "ties", "drops"])
def test_gating_indices_match_jax(case):
    """topi, slot and keep exact; w and the aux loss within 1e-6 (fp32
    softmax and normalisation in another order).  "ties" has many equal
    logits per row (lower index first on both sides); "drops" has
    capacity factor 0.5, so a third of the assignments fall past
    capacity."""
    rng = np.random.default_rng(3)
    T, E, k = 40, 8, 3
    cf = 0.5 if case == "drops" else 1.25
    capacity = max(1, int(cf * k * T / E))
    if case == "ties":
        logits = rng.integers(0, 3, (T, E)).astype(np.float32)
    else:
        logits = rng.standard_normal((T, E)).astype(np.float32)
    (rt, rs, rw, rk, ra), (gt, gs, gw, gk, ga) = _gating_pair(logits, k,
                                                               capacity)
    np.testing.assert_array_equal(_np(gt), np.asarray(rt))
    np.testing.assert_array_equal(_np(gs), np.asarray(rs))
    np.testing.assert_array_equal(_np(gk), np.asarray(rk))
    np.testing.assert_allclose(_np(gw), np.asarray(rw), atol=1e-6)
    np.testing.assert_allclose(float(ga), float(ra), atol=1e-6)
    if case == "drops":
        assert 0 < (~_np(gk)).sum() < gk.numel()


def test_dense_gating_matches_jax():
    """``top_k_gating``'s combine and dispatch [T, E, C], built by
    scatter, against JAX's one-hot einsums: dispatch exact, combine
    within 1e-6."""
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((24, 4)).astype(np.float32)
    rc, rd, ra = JM.top_k_gating(jnp.asarray(logits), k=2, capacity=7)
    gc, gd, ga = TM.top_k_gating(_torch(logits), 2, 7)
    np.testing.assert_array_equal(_np(gd), np.asarray(rd))
    np.testing.assert_allclose(_np(gc), np.asarray(rc), atol=1e-6)
    np.testing.assert_allclose(float(ga), float(ra), atol=1e-6)


def test_bf16_slots_collide_in_jax_and_stay_distinct_in_the_port():
    """600 tokens that all choose expert 0 first, bf16 logits, capacity
    1200: JAX counts queue positions in bf16, so past 256 distinct tokens
    share a slot; the port counts in int32 and gives each its own."""
    T, E = 600, 4
    logits = np.zeros((T, E), np.float32)
    logits[:, 0] = 4.0
    jl = jnp.asarray(logits, jnp.bfloat16)
    _, rs, _, rk, _ = JM.top_k_gating_indices(jl, k=1, capacity=2 * T)
    rs = np.asarray(rs)[:, 0]
    assert np.asarray(rk).all()
    assert len(np.unique(rs)) < T                  # the reference's fault
    tl = _torch(logits).to(torch.bfloat16)
    _, gs, _, gk, _ = TM.top_k_gating_indices(tl, 1, 2 * T)
    assert bool(gk.all())
    np.testing.assert_array_equal(np.sort(_np(gs)[:, 0]), np.arange(T))


# -- the grouped expert FFN ---------------------------------------------------

def _ffn_inputs(rng, G, C, d, h, E):
    x = rng.standard_normal((G, C, d)).astype(np.float32)
    w1 = (rng.standard_normal((E, d, h)) * 0.3).astype(np.float32)
    b1 = (rng.standard_normal((E, h)) * 0.1).astype(np.float32)
    w2 = (rng.standard_normal((E, h, d)) * 0.3).astype(np.float32)
    b2 = (rng.standard_normal((E, d)) * 0.1).astype(np.float32)
    return x, w1, b1, w2, b2


@pytest.mark.parametrize("E,counts", [(4, [16, 16, 16, 16]),
                                      (4, [16, 5, 0, 9]),
                                      (2, [16, 0, 7, 3])])
def test_grouped_plain_version_matches_the_jax_kernel(E, counts):
    """G=4 groups of C=16 rows, d=8, h=24 (rep 2 where E=2), full,
    partial and zero counts: the port's plain version and its VJP against
    JAX's grouped kernel in interpret mode (forward and the gradient of
    every input) and against ``grouped_expert_ffn_reference``, both with
    the exact gelu that ``ExpertFFN`` passes; fp32
    sums of at most 24 terms in another order: 1e-5.  Rows past a count
    are exactly zero."""
    rng = np.random.default_rng(sum(counts) + E)
    G, C, d, h = 4, 16, 8, 24
    arrs = _ffn_inputs(rng, G, C, d, h, E)
    cnt = np.asarray(counts, np.int32)
    r = rng.standard_normal((G, C, d)).astype(np.float32)

    def act(v):         # ExpertFFN's F.gelu; the kernel's act=None is tanh
        return jax.nn.gelu(v, approximate=False)

    def jf(*a):
        y = JGM.grouped_expert_ffn(*a, counts=jnp.asarray(cnt), act=act)
        return jnp.sum(y * r), y

    (_, ref), rgrads = jax.value_and_grad(jf, argnums=(0, 1, 2, 3, 4),
                                          has_aux=True)(
        *map(jnp.asarray, arrs))
    ref_plain = JGM.grouped_expert_ffn_reference(
        *map(jnp.asarray, arrs), counts=jnp.asarray(cnt), act=act)
    ts = [_torch(a).requires_grad_(True) for a in arrs]
    y = TGM.GroupedExpertFFN.apply(*ts, _torch(cnt), "gelu")
    (y * _torch(r)).sum().backward()
    np.testing.assert_allclose(_np(y), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(_np(y), np.asarray(ref_plain), atol=1e-5,
                               rtol=1e-5)
    for name, t, g in zip(("x", "w1", "b1", "w2", "b2"), ts, rgrads):
        np.testing.assert_allclose(_np(t.grad), np.asarray(g), atol=1e-5,
                                   rtol=1e-5, err_msg=name)
    rows = np.arange(C)[None, :] >= cnt[:, None]
    assert not _np(y)[rows].any()


def test_grouped_wrapper_refuses_another_activation():
    rng = np.random.default_rng(0)
    arrs = [_torch(a) for a in _ffn_inputs(rng, 2, 4, 8, 8, 2)]
    assert torch.equal(TGM.grouped_expert_ffn(*arrs, act=TF.gelu),
                       TGM.grouped_expert_ffn(*arrs, act="gelu"))
    with pytest.raises(ValueError, match="exact gelu only"):
        TGM.grouped_expert_ffn(*arrs, act=TF.silu)


def test_gelu_matches_jax():
    x = np.linspace(-6, 6, 97).astype(np.float32)
    for approx in (False, True):
        np.testing.assert_allclose(
            _np(TF.gelu(_torch(x), approximate=approx)),
            np.asarray(jax.nn.gelu(jnp.asarray(x), approximate=approx)),
            atol=1e-6, rtol=1e-6)


# -- MoELayer -----------------------------------------------------------------

def _layer_pair(mode):
    pp.seed(5)
    jl = jdist.MoELayer(d_model=16, num_experts=8, d_hidden=32,
                        gate="naive", top_k=3, capacity_factor=1.25,
                        dispatch_mode=mode)
    tl = TM.MoELayer(d_model=16, num_experts=8, d_hidden=32, gate="naive",
                     top_k=3, capacity_factor=1.25, dispatch_mode=mode)
    tl.set_state_dict({k: v.numpy() for k, v in jl.state_dict().items()})
    return jl, tl


@pytest.mark.parametrize("knob", ["0", "1"])
@pytest.mark.parametrize("mode", ["einsum", "index"])
def test_moe_layer_matches_jax(monkeypatch, mode, knob):
    """B=2, S=10, d=16, 8 experts top-3 (capacity 11, some drops): the
    output, aux loss, dropped fraction and the gradient of the input and
    every parameter of ``sum(out * r) + aux`` against JAX, with its
    grouped kernel (knob 1, interpret mode) and without (knob 0, the
    dense einsum pair).  fp32: 1e-5 of each array's largest magnitude."""
    monkeypatch.setenv("PADDLE_TPU_GROUPED_MOE", knob)
    jl, tl = _layer_pair(mode)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 10, 16)).astype(np.float32)
    r = rng.standard_normal((2, 10, 16)).astype(np.float32)
    params = params_of(jl)
    stats = {}

    def jf(p, xx):
        out = unwrap(functional_call(jl, p, pp.Tensor(xx)))
        stats["aux"] = unwrap(jl.aux_loss)
        stats["dropped"] = unwrap(jl.router_stats["dropped_frac"])
        return jnp.sum(out * r) + stats["aux"], out

    (_, ref), (rgp, rgx) = jax.value_and_grad(jf, argnums=(0, 1),
                                              has_aux=True)(
        params, jnp.asarray(x))
    jf(params, jnp.asarray(x))              # concrete router statistics
    tx = _torch(x).requires_grad_(True)
    out = tl(tx)
    ((out * _torch(r)).sum() + tl.aux_loss).backward()

    def close(got, want, what):
        scale = float(np.abs(want).max()) or 1.0
        err = float(np.abs(got - want).max())
        assert err <= 1e-5 * scale, (what, err, scale)

    close(_np(out), np.asarray(ref), "out")
    np.testing.assert_allclose(float(tl.aux_loss.detach()),
                               float(stats["aux"]),
                               rtol=1e-5)
    dropped = float(tl.router_stats["dropped_frac"])
    assert dropped == pytest.approx(float(stats["dropped"]), abs=1e-7)
    assert 0 < dropped < 1
    close(_np(tx.grad), np.asarray(rgx), "x")
    got = dict(tl.named_parameters())
    assert set(got) == set(rgp)
    for n, g in rgp.items():
        close(_np(got[n].grad), np.asarray(g), n)


def test_unported_moe_options_name_the_roadmap(monkeypatch):
    for mode in ("ragged", "all_to_all", "all_to_all_index"):
        with pytest.raises(NotImplementedError, match="queue 1, item 8"):
            TM.MoELayer(16, 4, dispatch_mode=mode)
    with pytest.raises(NotImplementedError, match="queue 1, item 8"):
        TM.MoELayer(16, 4, dropless=True)
    with pytest.raises(ValueError, match="unknown dispatch_mode"):
        TM.MoELayer(16, 4, dispatch_mode="nope")
    # the moe.expert_imbalance fault point is ported: it biases every
    # token to expert 0 (tests/test_torch_compile_cache.py holds it
    # against JAX's)
    layer = TM.MoELayer(16, 4, d_hidden=8)
    from paddle_tpu_torch import robustness as trob
    trob.inject("moe.expert_imbalance", times=1)
    try:
        layer(torch.randn(1, 4, 16))
    finally:
        trob.clear_faults()
    load = layer.router_stats["load"]
    assert int(load[0]) == int(load.max())


# -- the ERNIE 4.5 decoder ----------------------------------------------------

def _model_pair(seed=0, mode="einsum"):
    pp.seed(seed)
    jm = JErnieForCausalLM(jernie45_moe_config(**TINY, dispatch_mode=mode))
    tm = ErnieForCausalLM(ernie45_moe_config(**TINY, dispatch_mode=mode),
                          device="cpu")
    tm.set_state_dict({k: v.numpy() for k, v in jm.state_dict().items()})
    return jm, tm


def _batch(seed, b=2, s=16):
    ids = np.random.default_rng(seed).integers(0, 256, (b, s + 1))
    return ids[:, :-1], ids[:, 1:]


def test_ernie_state_dict_names_and_layout_match_jax():
    jm, tm = _model_pair()
    jsd, tsd = jm.state_dict(), tm.state_dict()
    assert list(jsd) == list(tsd)
    for n, v in jsd.items():
        assert tuple(v.shape) == tuple(tsd[n].shape), n
    assert tm.model.layers[0].is_dense and not tm.model.layers[1].is_dense
    assert tuple(tsd["model.layers_1.moe.experts.w1"].shape) == (8, 64, 32)


@pytest.mark.parametrize("mode", ["einsum", "index"])
def test_ernie_logits_match_jax(mode):
    """Whole-model logits through one dense and one MoE layer, fp32:
    1e-5 of their largest magnitude."""
    jm, tm = _model_pair(1, mode)
    ids, _ = _batch(2)
    ref = np.asarray(unwrap(jm(pp.to_tensor(ids))))
    with torch.no_grad():
        got = _np(tm(_torch(ids)))
    err = float(np.abs(got - ref).max())
    assert err <= 1e-5 * float(np.abs(ref).max()), err


def test_ernie_loss_and_every_grad_match_jax():
    """``ErnieForCausalLM.loss`` (fused CE + 0.001 * aux) and the gradient
    of every parameter against ``jax.value_and_grad``: loss 1e-5
    relative, each gradient within 1e-4 of its largest magnitude (the
    tolerance of the Llama slice's test)."""
    jm, tm = _model_pair(3)
    ids, lbl = _batch(3)
    params = params_of(jm)

    def f(p):
        return unwrap(functional_call(jm, p, jnp.asarray(ids),
                                      jnp.asarray(lbl), method="loss"))

    ref, rgrads = jax.value_and_grad(f)(params)
    loss = tm.loss(_torch(ids), _torch(lbl))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(ref), rtol=1e-5)
    got = dict(tm.named_parameters())
    assert set(got) == set(rgrads)
    for n, r in rgrads.items():
        r = np.asarray(r)
        scale = float(np.abs(r).max())
        err = float(np.abs(_np(got[n].grad) - r).max())
        assert err <= 1e-4 * scale + 1e-8, (n, err, scale)


def test_train_step_matches_jax_over_three_steps():
    """Three ``TrainStep`` updates (AdamW, lr 1e-3, multi_precision) of
    the tiny ERNIE config against the JAX ``TrainStep`` on copied
    weights: each loss within 1e-5 relative, the final parameters within
    1e-4 (the tolerances of the Llama slice's test).  The 3-D expert
    weights are in the grad norm and the guard like every other
    parameter."""
    jm, tm = _model_pair(4)
    jstep = JTrainStep(jm, JAdamW(learning_rate=1e-3,
                                  parameters=jm.parameters(),
                                  multi_precision=True))
    step = TrainStep(tm, AdamW(learning_rate=1e-3, multi_precision=True))
    for i in range(3):
        ids, lbl = _batch(20 + i)
        batch = {"input_ids": ids, "labels": lbl}
        ref = float(unwrap(jstep(batch)))
        got = float(step(batch))
        np.testing.assert_allclose(got, ref, rtol=1e-5)
    assert step.step_count == 3 and not any(step.skipped.values())
    names = [n for n, _ in step._named]
    assert "model.layers_1.moe.experts.w1" in names
    got = step.params
    for n, r in jstep.params.items():
        np.testing.assert_allclose(_np(got[n]), np.asarray(r), atol=1e-4,
                                   rtol=1e-4, err_msg=n)


def test_moe_modules_import_no_jax():
    code = (
        "import sys\n"
        "import paddle_tpu_torch.distributed.moe\n"
        "import paddle_tpu_torch.models.moe_llm\n"
        "import paddle_tpu_torch.models.ernie\n"
        "import paddle_tpu_torch.ops.kernels.grouped_matmul\n"
        "bad = [m for m in sys.modules if m in ('jax', 'paddle_tpu') or\n"
        "       m.startswith(('jax.', 'jaxlib', 'paddle_tpu.'))]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
