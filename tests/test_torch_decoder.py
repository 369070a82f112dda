"""The port's Llama decoder tier and fused residual RMSNorm against the
JAX package on the CPU: the whole-block decoder's plain version against
``fused_decoder_block`` (the Pallas kernel in interpret mode), its
block-boundary-remat gradients against ``jax.grad``, the residual
rmsnorm's plain version and custom VJP against ``_fwd_pallas`` and
``_core``, ``F.rms_norm_residual``, the tiny hd-128 Llama at
``PADDLE_TPU_FUSED_BLOCK=decoder`` (logits, three ``TrainStep`` losses,
the route counts), and a repair: ``F.rms_norm``'s ``axis``
(``LlamaForCausalLM.generate`` is held in ``test_torch_generate.py``).
Inputs come from
``numpy.random.default_rng``; weights are copied across as numpy arrays.
Each test states its tolerance.  The kernels themselves run on the card
(``test_torch_cuda.py``)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as pp
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.models import LlamaConfig as JLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JLlamaForCausalLM
from paddle_tpu.nn import functional as JF
from paddle_tpu.nn.functional.attention import rotary_freqs as jrotary
from paddle_tpu.ops.pallas import fused_block as JFB
from paddle_tpu.ops.pallas import rmsnorm as JRN
from paddle_tpu.optimizer import AdamW as JAdamW

from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.ops import kernels
from paddle_tpu_torch.ops.kernels import fused_block as FB
from paddle_tpu_torch.ops.kernels import rmsnorm as RN
from paddle_tpu_torch.optimizer import AdamW

EPS = 1e-5
WEIGHTS = ("wn1", "wq", "wk", "wv", "wo", "wn2", "wg", "wu", "wd")


def _rel(got, ref):
    ref = np.asarray(ref, np.float32)
    got = np.asarray(got, np.float32)
    return float(np.abs(got - ref).max()) / max(float(np.abs(ref).max()),
                                                1e-6)


def _block_inputs(rng, b, s, d, nh, nkvh, f, hd=128):
    """x and the block's weights as numpy fp32, the JAX test's scales."""
    dq, dkv = nh * hd, nkvh * hd
    mk = lambda *shape: (rng.standard_normal(shape) * 0.05).astype(np.float32)
    w = dict(wn1=rng.standard_normal((d,)).astype(np.float32),
             wn2=rng.standard_normal((d,)).astype(np.float32),
             wq=mk(d, dq), wk=mk(d, dkv), wv=mk(d, dkv), wo=mk(dq, d),
             wg=mk(d, f), wu=mk(d, f), wd=mk(f, d))
    return rng.standard_normal((b, s, d)).astype(np.float32), w


def _jax_block(x, w, cos, sin, nh, nkvh, use_pallas, dtype=jnp.float32):
    j = {k: jnp.asarray(v, dtype) for k, v in w.items()}
    return JFB.fused_decoder_block(
        jnp.asarray(x, dtype), j["wn1"], j["wq"], j["wk"], j["wv"], cos, sin,
        j["wo"], j["wn2"], j["wg"], j["wu"], j["wd"], num_heads=nh,
        num_kv_heads=nkvh, epsilon=EPS, use_pallas=use_pallas)


def _torch_args(x, w, cos, sin, dtype=torch.float32):
    t = {k: torch.from_numpy(v).to(dtype) for k, v in w.items()}
    return (torch.from_numpy(x).to(dtype), t["wn1"], t["wq"], t["wk"],
            t["wv"], torch.from_numpy(np.array(cos)),
            torch.from_numpy(np.array(sin)), t["wo"], t["wn2"], t["wg"],
            t["wu"], t["wd"])


# -- the whole-block decoder (row 13) -----------------------------------------

@pytest.mark.parametrize("shape", [(2, 64, 256, 2, 1, 512),
                                   (4, 16, 256, 2, 2, 512)])
def test_decoder_reference_matches_pallas(shape):
    """decoder_reference against the Pallas block in interpret mode at the
    JAX tests' shapes (GQA rep 2; MHA at s=16), fp32: sums of up to 512
    products in another order and another softmax blocking, within 2e-5
    of the output's largest magnitude (the JAX test's own limit)."""
    b, s, d, nh, nkvh, f = shape
    x, w = _block_inputs(np.random.default_rng(s), b, s, d, nh, nkvh, f)
    cos, sin = jrotary(128, 256)
    assert JFB.fused_decoder_eligible(b, s, d, nh * 128, nkvh * 128, 128, f,
                                      "float32")
    ref = _jax_block(x, w, cos, sin, nh, nkvh, True)
    got = FB.decoder_reference(*_torch_args(x, w, cos, sin), nh, nkvh, EPS)
    assert _rel(got.numpy(), ref) < 2e-5


def test_decoder_reference_matches_pallas_bf16():
    """The same in bf16 (b=2, s=64, rep 2): both round at the kernel's
    cast points, but a bf16 step flipped by another summation order
    carries through the block; within 3e-2 of the largest magnitude (the
    JAX test's bf16 limit)."""
    b, s, d, nh, nkvh, f = 2, 64, 256, 2, 1, 512
    x, w = _block_inputs(np.random.default_rng(5), b, s, d, nh, nkvh, f)
    cos, sin = jrotary(128, 256)
    ref = _jax_block(x, w, cos, sin, nh, nkvh, True, jnp.bfloat16)
    got = FB.decoder_reference(*_torch_args(x, w, cos, sin, torch.bfloat16),
                               nh, nkvh, EPS)
    assert got.dtype == torch.bfloat16
    assert _rel(got.float().numpy(), jnp.asarray(ref, jnp.float32)) < 3e-2


def test_decoder_block_gradients_match_jax():
    """FusedDecoderBlock on the CPU (forward decoder_reference, backward
    its recompute) against jax.grad of JAX's block (use_pallas=False:
    ``_decoder_bwd`` ignores it) through sum(y^2), for x, wq, wg, wn1,
    wk, wo and wd; fp32 sums in another order, within 1e-4 of each
    gradient's largest magnitude.  The RoPE tables take no gradient."""
    b, s, d, nh, nkvh, f = 2, 64, 256, 2, 1, 512
    x, w = _block_inputs(np.random.default_rng(2), b, s, d, nh, nkvh, f)
    cos, sin = jrotary(128, 256)
    names = ("x", "wq", "wg", "wn1", "wk", "wo", "wd")

    def jloss(*vals):
        ww = dict(w, **dict(zip(names[1:], vals[1:])))
        y = _jax_block(vals[0], ww, cos, sin, nh, nkvh, False)
        return jnp.sum(y.astype(jnp.float32) ** 2)

    ref = jax.grad(jloss, argnums=tuple(range(len(names))))(
        jnp.asarray(x), *(jnp.asarray(w[n]) for n in names[1:]))
    args = list(_torch_args(x, w, cos, sin))
    order = ("x",) + WEIGHTS[:4] + ("cos", "sin") + WEIGHTS[4:]
    for i, n in enumerate(order):
        if n in names:
            args[i].requires_grad_(True)
    y = TF.fused_decoder_block(*args, num_heads=nh, num_kv_heads=nkvh,
                               epsilon=EPS)
    (y.float() ** 2).sum().backward()
    for n, r in zip(names, ref):
        assert _rel(args[order.index(n)].grad.numpy(), r) < 1e-4, n
    assert args[5].grad is None and args[6].grad is None


def test_decoder_block_on_cpu_launches_nothing():
    """On the CPU the wrapper is the plain version: no launch counted."""
    x, w = _block_inputs(np.random.default_rng(3), 1, 64, 256, 2, 2, 256)
    cos, sin = jrotary(128, 256)
    n = FB.fused_decoder_block.launches
    y = FB.fused_decoder_block(*_torch_args(x, w, cos, sin), 2, 2, EPS)
    assert torch.equal(y, FB.decoder_reference(*_torch_args(x, w, cos, sin),
                                               2, 2, EPS))
    assert FB.fused_decoder_block.launches == n


def test_gate_takes_llama3_8b_width_where_jax_does_not():
    """The port keeps JAX's shape conditions and swaps the 12 MB VMEM
    budget for the Hopper kernel's needs: Llama-3-8B width (d 4096, 32/8
    heads of 128, f 14336) at b=4 passes for s 512..8192 in bf16 and fp32,
    where JAX's gate refuses it; both agree at the tests' shapes."""
    for s in (512, 2048, 8192):
        for dt in ("bfloat16", "float32"):
            assert FB.fused_decoder_eligible(4, s, 4096, 4096, 1024, 128,
                                             14336, dt)
            assert not JFB.fused_decoder_eligible(4, s, 4096, 4096, 1024,
                                                  128, 14336, dt)
    for shape in [(2, 64, 256, 256, 128, 128, 512),
                  (1, 384, 256, 512, 128, 128, 512),
                  (2, 64, 128, 128, 128, 64, 256),      # head_dim 64
                  (2, 12, 256, 256, 128, 128, 512),     # s off the quantum
                  (2, 64, 96, 128, 128, 128, 256),      # d off the lanes
                  (2, 64, 256, 384, 256, 128, 512)]:    # 3 heads over 2
        assert FB.fused_decoder_eligible(*shape, "float32") == \
            JFB.fused_decoder_eligible(*shape, "float32"), shape
    # what the Hopper kernel adds: head_dim 128 only, 64-row blocks, the
    # io dtypes, and a workspace inside the budget
    assert not FB.fused_decoder_eligible(2, 256, 256, 512, 256, 256, 512,
                                         "float32")
    assert not FB.fused_decoder_eligible(4, 16, 256, 256, 256, 128, 512,
                                         "float32")
    assert not FB.fused_decoder_eligible(2, 64, 256, 256, 128, 128, 512,
                                         "float16")
    assert not FB.fused_decoder_eligible(64, 8192, 4096, 4096, 1024, 128,
                                         14336, "bfloat16")


def test_measured_tier_raises(monkeypatch, tmp_path):
    """``measured`` no longer raises: it is a tier of its own, which
    routes per shape from the measurement ledger (an empty one gives the
    per-segment path; ``test_torch_measurement_ledger.py`` holds the
    routing against JAX's); the other knob values are as before."""
    monkeypatch.setenv("PADDLE_TPU_FUSED_BLOCK", "measured")
    monkeypatch.setenv("PADDLE_TPU_CALIBRATION_DIR", str(tmp_path))
    from paddle_tpu_torch.observability import calibration
    calibration.reset()
    assert FB.fused_block_tier() == "measured"
    FB.clear_measured_tiers()
    assert FB.measured_tier_for((2, 64, 256), "float32") == "segments"
    for knob in ("", "0", "1", "off", "on"):
        monkeypatch.setenv("PADDLE_TPU_FUSED_BLOCK", knob)
        assert FB.fused_block_tier() == "segments"
    monkeypatch.setenv("PADDLE_TPU_FUSED_BLOCK", " Decoder ")
    assert FB.fused_block_tier() == "decoder"


# -- the fused residual rmsnorm (row 10) --------------------------------------

def _norm_inputs(rng, rows=32, d=256):
    x = rng.standard_normal((rows, d)).astype(np.float32)
    r = rng.standard_normal((rows, d)).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal((d,))).astype(np.float32)
    return x, r, w


@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_rmsnorm_matches_pallas(dtype, residual):
    """y, h and inv of the plain version against ``_fwd_pallas`` in
    interpret mode and ``_ref_fwd``, with and without a residual: fp32
    within 1e-6 (another summation order of 256 squares); bf16 y and h
    within one bf16 step (2^-7 of the value), inv (fp32) within 1e-6."""
    x, r, w = _norm_inputs(np.random.default_rng(1 + residual))
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jx, jr, jw = (jnp.asarray(a, jdt) for a in (x, r, w))
    tx, tr, tw = (torch.from_numpy(a).to(tdt) for a in (x, r, w))
    got = RN.fused_rmsnorm(tx, tw, tr if residual else None, EPS)
    tol = 1e-6 if dtype == "float32" else 2 ** -7
    for ref in (JRN._fwd_pallas(jx, jr if residual else None, jw, eps=EPS,
                                block_rows=8, interpret=True),
                JRN._ref_fwd(jx, jr if residual else None, jw, EPS)):
        for name, g, e in zip(("y", "h", "inv"), got, ref):
            t = 1e-6 if name == "inv" else tol
            np.testing.assert_allclose(g.float().numpy(),
                                       np.asarray(e, np.float32), rtol=t,
                                       atol=1e-6, err_msg=name)
    assert got[0].dtype == tdt and got[1].dtype == tdt
    assert got[2].dtype == torch.float32 and got[2].shape == (32, 1)


@pytest.mark.parametrize("residual", [True, False])
def test_fused_rmsnorm_backward_matches_jax(residual):
    """FusedRMSNorm's backward against the VJP of JAX's ``_core``
    (``_bwd``) for cotangents of both y and h, fp32: dx, dres and dw
    within 1e-5.  Without a residual the placeholder (x itself in JAX)
    gets a zero cotangent, so x's gradient is not counted twice."""
    rng = np.random.default_rng(7)
    x, r, w = _norm_inputs(rng)
    gy, gh = (rng.standard_normal(x.shape).astype(np.float32)
              for _ in range(2))
    jr = jnp.asarray(r if residual else x)
    _, vjp = jax.vjp(lambda a, b_, c: JRN._core(a, b_, c, EPS, residual,
                                                False, True),
                     jnp.asarray(x), jr, jnp.asarray(w))
    ref = vjp((jnp.asarray(gy), jnp.asarray(gh)))
    tx = torch.from_numpy(x).requires_grad_(True)
    tr = torch.from_numpy(r if residual else x.copy()).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    y, h = RN.FusedRMSNorm.apply(tx, tr, tw, EPS, residual)
    torch.autograd.backward((y, h), (torch.from_numpy(gy),
                                     torch.from_numpy(gh)))
    for name, g, e in zip(("dx", "dres", "dw"), (tx.grad, tr.grad, tw.grad),
                          ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(e), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    if not residual:
        assert not tr.grad.any()


@pytest.mark.parametrize("residual", [True, False])
def test_rms_norm_residual_matches_jax(residual):
    """F.rms_norm_residual on [2, 8, 256] rows against JAX's (reference
    math on the CPU): y and h, then the gradients of x, the residual and
    the weight through sum(y^2) + sum(h), fp32 within 1e-5."""
    rng = np.random.default_rng(9)
    x, r, w = _norm_inputs(rng, rows=16)
    x, r = x.reshape(2, 8, 256), r.reshape(2, 8, 256)

    def jloss(a, b_, c):
        y, h = JRN.fused_rmsnorm(a, c, residual=b_ if residual else None,
                                 epsilon=EPS, interpret=True,
                                 use_pallas=False)
        return jnp.sum(y ** 2) + jnp.sum(h), (y, h)

    (_, (jy, jh)), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                           has_aux=True)(
        jnp.asarray(x), jnp.asarray(r), jnp.asarray(w))
    ey, eh = JF.rms_norm_residual(jnp.asarray(x), jnp.asarray(w),
                                  jnp.asarray(r) if residual else None, EPS)
    np.testing.assert_allclose(np.asarray(ey), np.asarray(jy), rtol=1e-6)
    tx, tr, tw = (torch.from_numpy(a).requires_grad_(True) for a in (x, r, w))
    y, h = TF.rms_norm_residual(tx, tw, tr if residual else None, EPS)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(jh), rtol=1e-5,
                               atol=1e-5)
    ((y ** 2).sum() + h.sum()).backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg[0]), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jg[2]), rtol=1e-5,
                               atol=1e-5)
    if residual:
        np.testing.assert_allclose(tr.grad.numpy(), np.asarray(jg[1]),
                                   rtol=1e-5, atol=1e-5)
    else:
        assert tr.grad is None
    with torch.no_grad():
        n = RN.fused_rmsnorm.launches
        y2, h2 = TF.rms_norm_residual(tx, tw, tr if residual else None, EPS)
    assert torch.equal(y2, y.detach()) and RN.fused_rmsnorm.launches == n


# -- the Llama model at the decoder tier --------------------------------------

def _decoder_cfg(**over):
    """JAX's ``_decoder_cfg`` (test_decoder_megakernel.py:162-166): hidden
    256, 2 / 1 heads of 128, FFN 512, vocab 256, 2 layers."""
    cfg = dict(hidden_size=256, intermediate_size=512,
               num_attention_heads=2, num_key_value_heads=1, vocab_size=256)
    cfg.update(over)
    return cfg


def _pair(monkeypatch, cfg, seed=0):
    monkeypatch.setenv("PADDLE_TPU_FUSED_BLOCK", "decoder")
    pp.seed(seed)
    jm = JLlamaForCausalLM(JLlamaConfig.tiny(**cfg))
    tm = LlamaForCausalLM(LlamaConfig.tiny(**cfg), device="cpu")
    tm.set_state_dict({k: v.numpy() for k, v in jm.state_dict().items()})
    return jm, tm


def test_decoder_tier_logits_match_jax(monkeypatch):
    """b=2, s=64 at the decoder tier on both sides (JAX: the Pallas block
    in interpret mode; the port: decoder_reference), fp32: two layers of
    sums in another order, within 1e-4 of the largest logit.  Every layer
    routes to the block, once a forward."""
    jm, tm = _pair(monkeypatch, _decoder_cfg())
    ids = np.random.default_rng(7).integers(0, 256, (2, 64))
    ref = np.asarray(jm(pp.to_tensor(ids.astype(np.int32))).numpy())
    kernels.reset_launch_counts()
    with torch.inference_mode():
        got = tm(torch.from_numpy(ids)).numpy()
    assert _rel(got, ref) < 1e-4
    assert FB.fused_decoder_block.routes == {"decoder": 2, "segments": 0}
    # the same weights at the default tier take the per-segment path,
    # whose norms cast before the weight multiply: other roundings, the
    # same block in fp32
    monkeypatch.delenv("PADDLE_TPU_FUSED_BLOCK")
    with torch.inference_mode():
        seg = tm(torch.from_numpy(ids)).numpy()
    assert _rel(seg, got) < 1e-4
    assert FB.fused_decoder_block.routes == {"decoder": 2, "segments": 0}


def test_decoder_tier_train_step_matches_jax(monkeypatch):
    """Three TrainStep updates (AdamW, lr 1e-3, multi_precision) at the
    decoder tier on both sides, b=2, s=64: each loss within 1e-5
    relative (the training slice's limit), falling.  The forward routes
    both layers to the block each step; the backward recomputes them."""
    jm, tm = _pair(monkeypatch, _decoder_cfg(), seed=1)
    jstep = JTrainStep(jm, JAdamW(learning_rate=1e-3,
                                  parameters=jm.parameters(),
                                  multi_precision=True))
    step = TrainStep(tm, AdamW(learning_rate=1e-3, multi_precision=True))
    ids = np.random.default_rng(8).integers(0, 256, (2, 65))
    batch = {"input_ids": ids[:, :-1], "labels": ids[:, 1:]}
    kernels.reset_launch_counts()
    losses = []
    for _ in range(3):
        out = jstep(batch)
        ref = float(np.asarray(getattr(out, "_data", out)))
        got = float(step(batch))
        np.testing.assert_allclose(got, ref, rtol=1e-5)
        losses.append(got)
    assert losses[-1] < losses[0]
    assert FB.fused_decoder_block.routes == {"decoder": 6, "segments": 0}


def test_head_dim_64_routes_to_segments(monkeypatch):
    """JAX's ``_segment_cfg`` (head_dim 64): the gate refuses it, so the
    decoder tier gives exactly the default tier's logits."""
    cfg = dict(hidden_size=128, intermediate_size=256,
               num_attention_heads=2, num_key_value_heads=2, vocab_size=256)
    _, tm = _pair(monkeypatch, cfg)
    ids = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (2, 64)))
    kernels.reset_launch_counts()
    with torch.inference_mode():
        got = tm(ids)
        monkeypatch.delenv("PADDLE_TPU_FUSED_BLOCK")
        ref = tm(ids)
    assert torch.equal(got, ref)
    assert FB.fused_decoder_block.routes == {"decoder": 0, "segments": 2}


def test_cached_and_masked_calls_stand_aside(monkeypatch):
    """Only the cache-free, mask-free, offset-0 form reaches the tier: a
    masked call and a call at an offset route nothing (the masked causal
    call agrees with the tier's within 1e-4, fp32)."""
    _, tm = _pair(monkeypatch, _decoder_cfg())
    ids = torch.from_numpy(np.random.default_rng(4).integers(0, 256, (1, 64)))
    mask = torch.ones((1, 1, 64, 64), dtype=torch.bool).tril()
    kernels.reset_launch_counts()
    with torch.inference_mode():
        masked = tm(ids, attn_mask=mask)
        tm(ids, position_offset=3)
        assert FB.fused_decoder_block.routes == {"decoder": 0,
                                                 "segments": 0}
        tier = tm(ids)
    assert FB.fused_decoder_block.routes == {"decoder": 2, "segments": 0}
    assert _rel(masked.numpy(), tier.numpy()) < 1e-4


# -- repairs ------------------------------------------------------------------

@pytest.mark.parametrize("axis", [-1, 1, 0])
def test_rms_norm_axis_matches_jax(axis):
    """F.rms_norm over ``axis`` of [4, 6, 8] fp32 with a [8] weight that
    broadcasts over the trailing axis, against JAX's: within 1e-6."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((4, 6, 8)).astype(np.float32)
    w = rng.standard_normal((8,)).astype(np.float32)
    ref = np.asarray(JF.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6,
                                 axis=axis))
    got = TF.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6,
                      axis=axis)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)
