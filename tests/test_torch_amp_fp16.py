"""AMP float16 in the port against the JAX package, on the CPU.

The fp16 plain versions of the kernels that AMP's float16 reaches on a
training step (flash forward and backward, RMSNorm+QKV in both variants,
the SwiGLU MLP, fused_ffn) against the JAX package's Pallas kernels in
interpret mode, on the same fp16 inputs; the plain multi-tensor update
with fp16 parameters and fp32 masters against JAX's AdamW
``multi_precision`` rule, bitwise; one O1 and one O2 float16 step of a
2-layer Llama (hidden 256, head_dim 128, s=128, JAX's fused route)
against JAX's, weights carried across as float16 / float32 numpy arrays;
and a step whose scaled loss overflows, which both skip.

Tolerances: an fp16 output rounds once (2^-11 relative), and the two
packages sum in other orders and round P and dS at other points, so the
kernels' outputs agree within 2e-3 of the larger of the value and the
output's largest magnitude."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import paddle_tpu as jp
from paddle_tpu import amp as jamp
from paddle_tpu.models import LlamaConfig as JLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JLlamaForCausalLM
from paddle_tpu.ops.pallas import flash_attention as JFA
from paddle_tpu.ops.pallas import fused_block as JFB

import paddle_tpu_torch as tp
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.ops.kernels import _build
from paddle_tpu_torch.ops.kernels import flash_attention as FA
from paddle_tpu_torch.ops.kernels import fused_block as FB
from paddle_tpu_torch.ops.kernels import multi_tensor as MT
from paddle_tpu_torch.optimizer import AdamW as TAdamW

H = np.float16
REL = 2e-3
LLAMA = dict(vocab_size=512, hidden_size=256, intermediate_size=512,
             num_hidden_layers=2, num_attention_heads=2,
             num_key_value_heads=1, max_position_embeddings=256)


@pytest.fixture(autouse=True)
def _cpu_default():
    tp.set_device("cpu")
    yield
    from paddle_tpu_torch.core import state
    state.set_default_device("cuda")


def _both(rng, shape, scale=1.0):
    a = (rng.standard_normal(shape) * scale).astype(H)
    return jnp.asarray(a), torch.from_numpy(a.copy())


def _close(got, ref):
    """Within REL of the value or of the output's largest magnitude."""
    r = np.asarray(ref, np.float32)
    assert got.dtype == torch.float16 and tuple(got.shape) == r.shape
    np.testing.assert_allclose(got.float().numpy(), r, rtol=REL,
                               atol=REL * float(np.abs(r).max()))


def _bhsd(t):
    return jnp.swapaxes(t, 1, 2)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_fwd_float16_matches_pallas(causal):
    rng = np.random.default_rng(1 + causal)
    b, s, h, hk, d = 1, 128, 4, 2, 128
    (jq, tq), (jk, tk), (jv, tv) = (_both(rng, (b, s, n, d))
                                    for n in (h, hk, hk))
    ref, ref_lse = JFA._fwd_pallas(_bhsd(jq), _bhsd(jk), _bhsd(jv),
                                   scale=d ** -0.5, causal=causal,
                                   block_q=128, block_k=128, interpret=True)
    out, lse = FA.flash_attention_fwd(tq, tk, tv, causal)
    _close(out, _bhsd(ref))
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_float16_matches_pallas(causal):
    """dq, dk, dv through the port's autograd Function against jax.vjp of
    the JAX flash attention with its Pallas dq / dkv kernels."""
    rng = np.random.default_rng(3 + causal)
    b, s, h, hk, d = 1, 128, 4, 2, 128
    (jq, tq), (jk, tk), (jv, tv), (jg, tg) = (
        _both(rng, (b, s, n, d)) for n in (h, hk, hk, h))
    _, vjp = jax.vjp(lambda q, k, v: JFA.flash_attention(
        q, k, v, causal=causal, interpret=True, pallas_bwd=True), jq, jk, jv)
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    FA.flash_attention(*leaves, causal=causal).backward(tg)
    for t, r in zip(leaves, vjp(jg)):
        _close(t.grad, r)


@pytest.mark.parametrize("residuals", [False, True])
def test_qkv_float16_matches_pallas(residuals):
    rng = np.random.default_rng(5 + residuals)
    T, d, dq, dkv = 32, 256, 256, 128
    jx, tx = _both(rng, (T, d))
    jn, tn = _both(rng, (d,))
    ws = [_both(rng, (d, n), 0.05) for n in (dq, dkv, dkv)]
    if residuals:     # the training variant: _qkv_pallas's residuals
        ref = JFB._qkv_pallas(jx, jn, *(w[0] for w in ws), eps=1e-5,
                              block_t=16, block_o=128, interpret=True,
                              residuals=True)
    else:
        ref = JFB.fused_rmsnorm_qkv(jx, jn, *(w[0] for w in ws),
                                    epsilon=1e-5, use_pallas=True,
                                    interpret=True)
    got = FB.fused_rmsnorm_qkv(tx, tn, *(w[1] for w in ws), 1e-5,
                               residuals=residuals)
    assert len(got) == len(ref) == (5 if residuals else 3)
    for g, r in zip(got[:4], ref[:4]):
        _close(g, r)
    if residuals:
        np.testing.assert_allclose(got[4].numpy(),
                                   np.asarray(ref[4]).reshape(T, 1),
                                   rtol=1e-5)


def test_mlp_float16_matches_pallas():
    rng = np.random.default_rng(7)
    T, d, f = 32, 256, 512
    jx, tx = _both(rng, (T, d))
    (jg, tg), (ju, tu) = (_both(rng, (d, f), d ** -0.5) for _ in range(2))
    jd, td = _both(rng, (f, d), f ** -0.5)
    ref = JFB.fused_mlp(jx, jg, ju, jd, use_pallas=True, interpret=True)
    _close(FB.fused_mlp(tx, tg, tu, td), ref)


@pytest.mark.parametrize("act", ["relu", "gelu", "silu"])
def test_ffn_float16_matches_pallas(act):
    rng = np.random.default_rng(8 + len(act))
    T, d, f = 32, 256, 512
    jx, tx = _both(rng, (T, d))
    j1, t1 = _both(rng, (d, f), d ** -0.5)
    j2, t2 = _both(rng, (f, d), f ** -0.5)
    jb1, tb1 = _both(rng, (f,), 0.1)
    jb2, tb2 = _both(rng, (d,), 0.1)
    ref = JFB.fused_ffn(jx, j1, j2, jb1, jb2, act, use_pallas=True,
                        interpret=True)
    _close(FB.fused_ffn(tx, t1, t2, tb1, tb2, act), ref)


def test_float16_routes_and_the_waiting_entry():
    """fp16 takes the wgmma designs past 16 rows (split-K below, where
    the card raises); a kernel without fp16 names ROADMAP.md's item 11,
    narrowed to serving; flash takes fp16 at head_dim 128 only."""
    assert FB.gemm_path(17, torch.float16) == "wgmma"
    assert FB.qkv_path(8192, torch.float16, True) == "wgmma"
    assert FB.gemm_path(16, torch.float16) == "splitk"
    assert FA.KERNEL_HEAD_DIMS[torch.float16] == (128,)
    assert _build.FP16_CODES[torch.float16] == _build.FLOAT16_CODE
    assert torch.float16 not in _build.DTYPE_CODES
    err = _build.dtype_error("paged_decode_attention", torch.float16)
    assert isinstance(err, TypeError)
    assert "queue 1, item 11" in str(err) and "serving" in str(err)


def test_multi_tensor_adam_float16_masters_match_jax_adamw_bitwise():
    """The plain multi-tensor AdamW with fp16 parameters, fp16 gradients
    and fp32 masters (``multi_precision``) against JAX's
    ``_update_with_master`` on the same arrays, lr and update count as
    device scalars (the traced step's form), two updates: masters,
    moments and the fp16 parameters bitwise equal.  (A third update is
    not compared: XLA's CPU pow gives 1 - 0.999^3 one fp32 ulp away from
    the correctly rounded value that torch's pow and the kernel's powf
    give.)"""
    rng = np.random.default_rng(9)
    shapes = [(7, 9), (70001,), (3, 5)]
    p16 = [rng.standard_normal(s).astype(H) for s in shapes]
    g16 = [[(rng.standard_normal(s) * 0.01).astype(H) for s in shapes]
           for _ in range(2)]
    lin = jp.nn.Linear(2, 2)
    jopt = jp.optimizer.AdamW(learning_rate=1e-3, weight_decay=0.01,
                              parameters=lin.parameters(),
                              multi_precision=True)
    jst = [{"moment1": jnp.zeros(s, jnp.float32),
            "moment2": jnp.zeros(s, jnp.float32)} for s in shapes]
    jps = [jnp.asarray(a) for a in p16]
    tps = [torch.from_numpy(a.copy()) for a in p16]
    tm, tv = ([torch.zeros(s) for s in shapes] for _ in range(2))
    tms = [p.float() for p in tps]
    for step in (1, 2):
        for i in range(len(shapes)):
            jopt._current_param_name = f"p{i}"
            new, jst[i] = jopt._update_with_master(
                jps[i], jnp.asarray(g16[step - 1][i]), jst[i],
                jnp.float32(1e-3), jnp.int32(step))
            jps[i] = new.astype(jnp.float16)
        MT.multi_tensor_adam(
            tps, [torch.from_numpy(g) for g in g16[step - 1]], tm, tv, tms,
            lr=torch.tensor(1e-3), step=torch.tensor(step, dtype=torch.int32),
            weight_decays=[0.01] * len(shapes), decoupled=True,
            multi_precision=True)
    for i in range(len(shapes)):
        np.testing.assert_array_equal(tms[i].numpy(),
                                      np.asarray(jst[i]["_master"]))
        np.testing.assert_array_equal(tm[i].numpy(),
                                      np.asarray(jst[i]["moment1"]))
        np.testing.assert_array_equal(tv[i].numpy(),
                                      np.asarray(jst[i]["moment2"]))
        np.testing.assert_array_equal(tps[i].numpy(), np.asarray(jps[i]))
        assert tps[i].dtype == torch.float16


def _llama_pair(level, **scaler):
    """JAX's and the port's tiny Llama on the same weights (JAX's
    arrays, float32, carried by ``set_state_dict``; at O2 both decorated
    to float16 after), an AdamW each and a GradScaler each."""
    jp.seed(0)
    jm = JLlamaForCausalLM(JLlamaConfig.tiny(**LLAMA))
    tm = LlamaForCausalLM(LlamaConfig.tiny(**LLAMA), device="cpu")
    tm.set_state_dict({k: v.numpy() for k, v in jm.state_dict().items()})
    jopt = jp.optimizer.AdamW(learning_rate=1e-3, parameters=jm.parameters())
    topt = TAdamW(learning_rate=1e-3, parameters=tm.parameters())
    if level == "O2":
        jm, jopt = jamp.decorate(jm, jopt, level="O2", dtype="float16")
        tm, topt = tamp.decorate(tm, topt, level="O2", dtype="float16")
    return (jm, jopt, jamp.GradScaler(**scaler)), \
        (tm, topt, tamp.GradScaler(**scaler))


def _steps(pair, level, ids, lab):
    """One float16 step in each package: the loss, the gradients as
    scaled by the loss scale, and each scaler's found-inf flag."""
    (jm, jopt, js), (tm, topt, ts) = pair
    with jamp.auto_cast(level=level, dtype="float16"):
        jl = jm.loss(jp.to_tensor(ids.astype(np.int32)),
                     jp.to_tensor(lab.astype(np.int32)))
    js.scale(jl).backward()
    jgrads = {n: np.asarray(p.grad.numpy(), np.float32)
              for n, p in jm.named_parameters() if p.grad is not None}
    js.step(jopt)
    jopt.clear_grad()
    with tamp.auto_cast(level=level, dtype="float16"):
        tl = tm.loss(torch.from_numpy(ids), torch.from_numpy(lab))
    ts.scale(tl).backward()
    ts.step(topt)
    topt.clear_grad()
    return float(np.asarray(jl.numpy())), float(tl.detach()), jgrads


def _batch():
    rng = np.random.default_rng(5)
    return rng.integers(0, 512, (2, 128)), rng.integers(0, 512, (2, 128))


@pytest.mark.parametrize("level", ["O1", "O2"])
def test_llama_float16_step_matches_jax(level, monkeypatch):
    """One step of Paddle's recipe at ``dtype="float16"`` (O1: fp32
    weights, linear and SDPA in fp16, QKV and the MLP gray; O2: fp16
    weights, fp32 masters) on JAX's fused route: losses within 1e-3; after
    the step every parameter within 2 fp16 ulps of JAX's wherever JAX's
    gradient is at least 2e-2 of its tensor's RMS.  Adam's first step is
    lr (sign(g) + wd p) there whatever the rounding; below that the two
    packages' gradients (sums in other orders, fp16 products) decide
    m / (sqrt(v) + eps) differently (at most 0.1% of elements, measured
    0.06%), and those stay within twice the step, 2 lr (1 + wd |p|).
    Rows of the embedding that no token reads have no gradient in either
    package and stay equal."""
    monkeypatch.setenv("PADDLE_TPU_FUSED_BLOCK", "1")
    pair = _llama_pair(level)
    ids, lab = _batch()
    jl, tl, jgrads = _steps(pair, level, ids, lab)
    assert abs(tl - jl) <= 1e-3 * abs(jl)
    (jm, _, js), (tm, _, ts) = pair
    assert not js._found_inf and not ts._found_inf
    assert ts.get_loss_scaling() == js.get_loss_scaling() == 2.0 ** 15
    tsd = tm.state_dict()
    n_off = 0
    for name, v in jm.state_dict().items():
        a = np.asarray(v.numpy()).astype(np.float32)
        b = tsd[name].detach()
        assert str(b.dtype).endswith(str(np.asarray(v.numpy()).dtype))
        b = b.float().numpy()
        g = jgrads[name]
        ulp = np.spacing(np.abs(a).astype(H)).astype(np.float32)
        big = np.abs(g) >= 2e-2 * np.sqrt(np.mean(g * g))
        diff = np.abs(a - b)
        off = diff > 2 * ulp
        assert not (off & big).any(), name
        assert (diff <= 2e-3 * (1 + 0.01 * np.abs(a)) + 2 * ulp).all(), name
        n_off += int(off.sum())
    total = sum(int(np.prod(v.shape)) for v in jm.state_dict().values())
    assert n_off <= 1e-3 * total


def test_llama_float16_overflow_step_is_skipped_by_both(monkeypatch):
    """O2 at a loss scale of 2^40: the scaled fp16 backward overflows,
    both scalers find the inf, skip the step (every parameter bitwise
    unchanged) and halve the scale."""
    monkeypatch.setenv("PADDLE_TPU_FUSED_BLOCK", "1")
    pair = _llama_pair("O2", init_loss_scaling=2.0 ** 40)
    (jm, _, js), (tm, _, ts) = pair
    jbefore = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tbefore = {k: v.detach().clone() for k, v in tm.state_dict().items()}
    _steps(pair, "O2", *_batch())
    assert js._found_inf and ts._found_inf
    assert ts.get_loss_scaling() == js.get_loss_scaling() == 2.0 ** 39
    for k, v in jm.state_dict().items():
        np.testing.assert_array_equal(np.asarray(v.numpy()), jbefore[k])
    for k, v in tm.state_dict().items():
        assert torch.equal(v.detach(), tbefore[k]), k
