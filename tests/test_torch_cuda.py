"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here needs an NVIDIA GPU with sm_90 and nvcc: on a
machine without one they skip.  Run on the card with

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(``--noconftest``: the suite's conftest sets JAX up, which this file
does not use).  Inputs come from numpy with a fixed seed; tolerances
are stated per dtype: the kernels sum in another order than cuBLAS
(fp32) and round activations to bf16 at the same points as the plain
versions (bf16)."""

import ctypes

import numpy as np
import pytest
import torch

from paddle_tpu_torch.inference.kv_cache import _quantize_kv
from paddle_tpu_torch.ops.kernels import _build
from paddle_tpu_torch.ops.kernels import cross_entropy as CE
from paddle_tpu_torch.ops.kernels import flash_attention as FA
from paddle_tpu_torch.ops.kernels import fused_block as FB
from paddle_tpu_torch.ops.kernels import grouped_matmul as GM
from paddle_tpu_torch.ops.kernels import paged_attention as PA
from paddle_tpu_torch.ops.kernels import quant_matmul as QM
from paddle_tpu_torch.ops.kernels import rmsnorm as RN
from paddle_tpu_torch.ops.kernels import splitk as SK
from paddle_tpu_torch.quantization.serving import quantize_linear_weight

pytestmark = pytest.mark.cuda

# (atol, rtol) per dtype: fp32 differs by summation order only; bf16
# outputs carry one bf16 rounding (2^-8 relative) plus order effects
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (3e-2, 3e-2),
       torch.float16: (2e-3, 2e-3)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    if torch.cuda.get_device_capability() < (9, 0):
        pytest.skip("the kernels are built for sm_90a (Hopper)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture
def fp32_products():
    """FLAGS_default_matmul_precision=float32 for the test: the chunked
    CE's products exact fp32 on the card, as on the CPU side of a
    card-against-CPU comparison (the TF32 default is held against
    float32 by test_chunked_ce_default_precision_against_float32)."""
    from paddle_tpu_torch import flags
    saved = flags.get("default_matmul_precision")
    flags.set_flags({"default_matmul_precision": "float32"})
    yield
    flags.set_flags({"default_matmul_precision": saved})


def _t(rng, shape, dtype, dev, scale=1.0):
    return torch.as_tensor(rng.standard_normal(shape) * scale,
                           dtype=torch.float32).to(dev, dtype)


def _close(got, ref, dtype):
    atol, rtol = TOL[dtype]
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               ref.float().cpu().numpy(), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,d,dq,dkv", [(1, 128, 128, 64), (8, 256, 256, 64),
                                        (37, 128, 192, 128),
                                        (100, 256, 256, 64),
                                        (256, 512, 512, 128)])
def test_rmsnorm_qkv_matches_plain(dev, dtype, T, d, dq, dkv):
    rng = np.random.default_rng(T * 7 + d)
    x = _t(rng, (T, d), dtype, dev)
    wn = _t(rng, (d,), dtype, dev, 0.5) + 1.0
    wq = _t(rng, (d, dq), dtype, dev, d ** -0.5)
    wk = _t(rng, (d, dkv), dtype, dev, d ** -0.5)
    wv = _t(rng, (d, dkv), dtype, dev, d ** -0.5)
    n0 = FB.fused_rmsnorm_qkv.launches
    got = FB.fused_rmsnorm_qkv(x, wn, wq, wk, wv, 1e-5)
    ref = FB.qkv_reference(x, wn, wq, wk, wv, 1e-5)
    assert FB.fused_rmsnorm_qkv.launches == n0 + 1
    for g, r in zip(got, ref):
        _close(g, r, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,d,f", [(1, 128, 256), (8, 256, 512),
                                   (37, 128, 192), (200, 256, 512)])
def test_mlp_matches_plain(dev, dtype, T, d, f):
    rng = np.random.default_rng(T * 11 + f)
    x = _t(rng, (T, d), dtype, dev)
    wg = _t(rng, (d, f), dtype, dev, d ** -0.5)
    wu = _t(rng, (d, f), dtype, dev, d ** -0.5)
    wd = _t(rng, (f, d), dtype, dev, f ** -0.5)
    n0 = FB.fused_mlp.launches
    got = FB.fused_mlp(x, wg, wu, wd)
    assert FB.fused_mlp.launches == n0 + 1
    _close(got, FB.mlp_reference(x, wg, wu, wd), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,kvh,hd,bs", [(4, 2, 32, 4), (32, 8, 128, 16),
                                         (8, 8, 64, 16), (16, 2, 256, 8),
                                         (8, 8, 64, 256)])
def test_paged_decode_matches_plain(dev, dtype, h, kvh, hd, bs):
    rng = np.random.default_rng(h * 3 + hd)
    B, nb, mb = 5, 40, 12
    q = _t(rng, (B, h, hd), dtype, dev)
    kp = _t(rng, (nb, bs, kvh, hd), dtype, dev)
    vp = _t(rng, (nb, bs, kvh, hd), dtype, dev)
    bt = torch.as_tensor(rng.integers(1, nb, (B, mb)), dtype=torch.int32,
                         device=dev)
    bt[0] = 0                      # an inactive row: scratch block, length 1
    lengths = torch.as_tensor([1, 1, bs, mb * bs - 3, mb * bs],
                              dtype=torch.int32, device=dev)
    n0 = PA.paged_decode_attention.launches
    got = PA.paged_decode_attention(q, kp, vp, bt, lengths)
    assert PA.paged_decode_attention.launches == n0 + 1
    _close(got, PA.paged_decode_reference(q, kp, vp, bt, lengths), dtype)


# -- the quantized serving slice's kernels ------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("T,K,N", [(1, 128, 256), (3, 256, 192),
                                   (8, 512, 1024), (17, 128, 320),
                                   (256, 512, 512)])
def test_quant_matmul_matches_plain(dev, dtype, mode, T, K, N):
    rng = np.random.default_rng(T * 13 + N)
    x = _t(rng, (T, K), dtype, dev)
    qw, scale = quantize_linear_weight(
        _t(rng, (K, N), torch.float32, dev, K ** -0.5), mode)
    n0 = (QM.quant_matmul.launches, QM.quant_matmul.launches_by_mode[mode])
    got = QM.quant_matmul(x, qw, scale, mode=mode)
    assert (QM.quant_matmul.launches,
            QM.quant_matmul.launches_by_mode[mode]) == (n0[0] + 1, n0[1] + 1)
    assert got.dtype == dtype and got.shape == (T, N)
    _close(got, QM.quant_matmul_reference(x, qw, scale), dtype)


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_quant_matmul_leading_dims(dev, mode):
    rng = np.random.default_rng(3)
    x = _t(rng, (2, 5, 256), torch.bfloat16, dev)
    qw, scale = quantize_linear_weight(
        _t(rng, (256, 128), torch.float32, dev, 0.0625), mode)
    got = QM.quant_matmul(x, qw, scale, mode=mode)
    assert got.shape == (2, 5, 128)
    flat = QM.quant_matmul(x.reshape(10, 256), qw, scale, mode=mode)
    torch.cuda.synchronize()
    assert torch.equal(got.reshape(10, 128), flat)
    _close(got, QM.quant_matmul_reference(x, qw, scale), torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,kvh,hd,bs", [(4, 2, 32, 4), (32, 8, 128, 16),
                                         (8, 8, 64, 16), (16, 2, 256, 8),
                                         (8, 8, 64, 256)])
def test_int8_paged_decode_matches_plain(dev, dtype, h, kvh, hd, bs):
    rng = np.random.default_rng(h * 5 + hd)
    B, nb, mb = 5, 40, 12
    q = _t(rng, (B, h, hd), dtype, dev)
    kp, ks = _quantize_kv(_t(rng, (nb, bs, kvh, hd), dtype, dev))
    vp, vs = _quantize_kv(_t(rng, (nb, bs, kvh, hd), dtype, dev))
    bt = torch.as_tensor(rng.integers(1, nb, (B, mb)), dtype=torch.int32,
                         device=dev)
    bt[0] = 0                      # an inactive row: scratch block, length 1
    lengths = torch.as_tensor([1, 1, bs, mb * bs - 3, mb * bs],
                              dtype=torch.int32, device=dev)
    n0 = (PA.paged_decode_attention.launches,
          PA.paged_decode_attention_int8.launches)
    got = PA.paged_decode_attention(q, kp, vp, bt, lengths, k_scale=ks,
                                    v_scale=vs)
    assert (PA.paged_decode_attention.launches,
            PA.paged_decode_attention_int8.launches) == (n0[0], n0[1] + 1)
    _close(got, PA.paged_decode_reference(q, kp, vp, bt, lengths,
                                          k_scale=ks, v_scale=vs), dtype)


def test_quant_wrappers_refuse_what_the_kernels_do_not_take(dev):
    qw = torch.zeros((64, 96), dtype=torch.int8, device=dev)
    with pytest.raises(ValueError, match="multiples of 64"):
        QM.quant_matmul(torch.zeros((4, 64), device=dev), qw,
                        torch.ones(96, device=dev))
    qw = torch.zeros((64, 64), dtype=torch.int8, device=dev)
    with pytest.raises(TypeError, match="dtype"):
        QM.quant_matmul(torch.zeros((4, 64), device=dev).half(), qw,
                        torch.ones(64, device=dev))
    with pytest.raises(TypeError, match="scale"):
        QM.quant_matmul(torch.zeros((4, 64), device=dev), qw,
                        torch.ones(64, device=dev, dtype=torch.bfloat16))
    q = torch.zeros((2, 4, 32), device=dev)
    pool = torch.zeros((3, 4, 2, 32), device=dev)
    bt = torch.zeros((2, 2), dtype=torch.int32, device=dev)
    sc = torch.ones((3, 4, 2), device=dev)
    with pytest.raises(TypeError, match="int8"):
        PA.paged_decode_attention(q, pool, pool, bt,
                                  torch.ones(2, dtype=torch.int32,
                                             device=dev),
                                  k_scale=sc, v_scale=sc)


def test_quant_engine_on_the_card_matches_the_cpu_engine(dev):
    """int8 weights and int8 pools at a small width (every projection
    converted, head_dim 32), fp32 on the card against the same model on
    the CPU: greedy tokens agree, both quant kernels launched and the
    fused fp kernels did not."""
    from paddle_tpu_torch import seed
    from paddle_tpu_torch.inference import ContinuousBatchingEngine
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.ops import kernels
    cfg = LlamaConfig.tiny(hidden_size=128, intermediate_size=256,
                           num_attention_heads=4, num_key_value_heads=2)
    seed(0)
    cpu = LlamaForCausalLM(cfg, device="cpu")
    gpu = LlamaForCausalLM(cfg, device=dev)
    gpu.set_state_dict(cpu.state_dict())
    kw = dict(slots=2, max_len=64, prefill_buckets=(16, 32),
              kv_block_size=4, prefill_chunk=8, quant_weights="int8",
              quant_kv="int8", paged_kv=True)
    prompts = [np.random.default_rng(i).integers(0, 256, n)
               for i, n in enumerate((5, 17, 11))]
    outs = []
    kernels.reset_launch_counts()
    for model in (cpu, gpu):
        with ContinuousBatchingEngine(model, **kw) as eng:
            rids = [eng.add_request(p, max_new_tokens=6) for p in prompts]
            res = eng.run()
            outs.append([res[r][1] for r in rids])
    assert outs[0] == outs[1]
    assert all(fn.launches > 0 for fn in kernels.SERVING_QUANT)
    assert FB.fused_rmsnorm_qkv.launches == FB.fused_mlp.launches == 0
    assert PA.paged_decode_attention.launches == 0


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    x = torch.zeros((4, 96), device=dev)
    w = torch.zeros((96, 64), device=dev)
    with pytest.raises(ValueError, match="multiple of 64"):
        FB.fused_rmsnorm_qkv(x, torch.ones(96, device=dev), w, w, w)
    with pytest.raises(TypeError, match="dtype"):
        FB.fused_mlp(x.half(), w.half(), w.half(), w.t().contiguous().half())
    q = torch.zeros((2, 6, 32), device=dev)
    pool = torch.zeros((3, 4, 2, 32), device=dev)
    bt = torch.zeros((2, 2), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="kv_heads"):
        PA.paged_decode_attention(q, pool, pool, bt,
                                  torch.ones(2, dtype=torch.int32,
                                             device=dev))


def test_engine_on_the_card_matches_the_cpu_engine(dev):
    """The whole paged path at a small width on the card (all three
    kernels) against the same fp32 weights on the CPU (plain versions):
    greedy tokens agree and every kernel launched."""
    from paddle_tpu_torch import seed
    from paddle_tpu_torch.inference import ContinuousBatchingEngine
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.ops import kernels
    cfg = LlamaConfig.tiny(hidden_size=128, intermediate_size=256,
                           num_attention_heads=4, num_key_value_heads=2)
    seed(0)
    cpu = LlamaForCausalLM(cfg, device="cpu")
    gpu = LlamaForCausalLM(cfg, device=dev)
    gpu.set_state_dict({k: v.numpy() for k, v in cpu.state_dict().items()})
    kw = dict(slots=2, max_len=64, prefill_buckets=(16, 32),
              kv_block_size=4, prefill_chunk=8, paged_kv=True)
    prompts = [np.random.default_rng(i).integers(0, 256, n)
               for i, n in enumerate((5, 17, 11))]
    outs = []
    kernels.reset_launch_counts()
    for model in (cpu, gpu):
        eng = ContinuousBatchingEngine(model, **kw)
        rids = [eng.add_request(p, max_new_tokens=6) for p in prompts]
        res = eng.run()
        outs.append([res[r][1] for r in rids])
    assert outs[0] == outs[1]
    assert all(fn.launches > 0 for fn in kernels.SERVING)


# -- the training slice's kernels ---------------------------------------------

FLASH_SHAPES = [(1, 128, 4, 4), (2, 256, 12, 4), (1, 192, 8, 2)]
# the backward's edges besides: a last 64-row tile of the bf16 kernels'
# 128-row tiles with one kv head for 4 query heads, and MHA (hk = h)
FLASH_BWD_EDGES = [(1, 320, 4, 1), (2, 192, 8, 8)]


def _flash_inputs(rng, b, s, h, hk, dtype, dev):
    d = 128
    return (_t(rng, (b, s, h, d), dtype, dev), _t(rng, (b, s, hk, d), dtype,
                                                  dev),
            _t(rng, (b, s, hk, d), dtype, dev), _t(rng, (b, s, h, d), dtype,
                                                   dev))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,s,h,hk", FLASH_SHAPES)
def test_flash_fwd_matches_plain(dev, dtype, causal, b, s, h, hk):
    rng = np.random.default_rng(b * s + h)
    q, k, v, _ = _flash_inputs(rng, b, s, h, hk, dtype, dev)
    n0 = FA.flash_attention_fwd.launches
    out, lse = FA.flash_attention_fwd(q, k, v, causal)
    assert FA.flash_attention_fwd.launches == n0 + 1
    ref, ref_lse = FA.flash_fwd_reference(q, k, v, causal)
    _close(out, ref, dtype)
    # lse: fp32 statistics of the same rounded inputs, sums in another order
    _close(lse, ref_lse, torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,s,h,hk", FLASH_SHAPES + FLASH_BWD_EDGES)
def test_flash_bwd_matches_plain(dev, dtype, causal, b, s, h, hk):
    rng = np.random.default_rng(b * s + h + 1)
    q, k, v, g = _flash_inputs(rng, b, s, h, hk, dtype, dev)
    out, lse = FA.flash_fwd_reference(q, k, v, causal)
    delta = FA.flash_delta(out, g)
    n0 = (FA.flash_attention_bwd_dq.launches,
          FA.flash_attention_bwd_dkv.launches)
    dq = FA.flash_attention_bwd_dq(q, k, v, g, lse, delta, causal)
    dk, dv = FA.flash_attention_bwd_dkv(q, k, v, g, lse, delta, causal)
    assert (FA.flash_attention_bwd_dq.launches,
            FA.flash_attention_bwd_dkv.launches) == (n0[0] + 1, n0[1] + 1)
    for got, ref in zip((dq, dk, dv), FA.flash_bwd_reference(
            q, k, v, g, lse, delta, causal)):
        _close(got, ref, dtype)


def test_flash_function_backward_runs_the_kernels(dev):
    rng = np.random.default_rng(5)
    q, k, v, g = _flash_inputs(rng, 1, 128, 4, 2, torch.float32, dev)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    FA.flash_attention(*leaves, causal=True).backward(g)
    out, lse = FA.flash_fwd_reference(q, k, v, True)
    ref = FA.flash_bwd_reference(q, k, v, g, lse, FA.flash_delta(out, g),
                                 True)
    for t, r in zip(leaves, ref):
        _close(t.grad, r, torch.float32)


def test_sdpa_routes_eligible_cuda_shapes_to_flash(dev):
    from paddle_tpu_torch.nn import functional as F
    rng = np.random.default_rng(6)
    q, k, v, _ = _flash_inputs(rng, 1, 128, 4, 2, torch.float32, dev)
    n0 = FA.flash_attention_fwd.launches
    got = F.scaled_dot_product_attention(q, k, v, is_causal=True)
    assert FA.flash_attention_fwd.launches == n0 + 1
    _close(got, FA.flash_fwd_reference(q, k, v, True)[0], torch.float32)
    F.scaled_dot_product_attention(q[:, :64], k[:, :64], v[:, :64],
                                   is_causal=True)       # seq 64: reference
    assert FA.flash_attention_fwd.launches == n0 + 1


@pytest.mark.parametrize("hd", [32, 64])
def test_sdpa_pads_small_head_dims_to_flash_at_long_seq(dev, hd):
    """head_dim 32/64 at seq >= 1024 is zero-padded to 128, run through
    flash with the true head_dim's scale, and sliced back (exact)."""
    from paddle_tpu_torch.nn import functional as F
    rng = np.random.default_rng(hd)
    q = _t(rng, (1, 1024, 4, hd), torch.float32, dev)
    k = _t(rng, (1, 1024, 2, hd), torch.float32, dev)
    v = _t(rng, (1, 1024, 2, hd), torch.float32, dev)
    n0 = FA.flash_attention_fwd.launches
    got = F.scaled_dot_product_attention(q, k, v, is_causal=True)
    assert FA.flash_attention_fwd.launches == n0 + 1
    assert got.shape == q.shape
    _close(got, FA.flash_fwd_reference(q, k, v, True)[0], torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,d,dq,dkv", [(37, 128, 192, 128),
                                        (256, 512, 512, 128)])
def test_rmsnorm_qkv_train_variant_matches_plain(dev, dtype, T, d, dq, dkv):
    rng = np.random.default_rng(T + d)
    x = _t(rng, (T, d), dtype, dev)
    wn = _t(rng, (d,), dtype, dev, 0.5) + 1.0
    wq = _t(rng, (d, dq), dtype, dev, d ** -0.5)
    wk = _t(rng, (d, dkv), dtype, dev, d ** -0.5)
    wv = _t(rng, (d, dkv), dtype, dev, d ** -0.5)
    got = FB.fused_rmsnorm_qkv(x, wn, wq, wk, wv, 1e-5, residuals=True)
    ref = FB.qkv_reference(x, wn, wq, wk, wv, 1e-5, residuals=True)
    for g, r in zip(got[:4], ref[:4]):
        _close(g, r, dtype)
    _close(got[4], ref[4], torch.float32)


def test_train_step_on_the_card_matches_the_cpu_port(dev, fp32_products):
    """A tiny flash-eligible config (head_dim 128, seq 128) in fp32: the
    loss and every parameter's gradient through the card's kernels
    (flash fwd/bwd, QKV train variant, MLP) against the CPU port's plain
    path, then one TrainStep on each: the updated parameters agree."""
    from paddle_tpu_torch import seed
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.optimizer import AdamW
    cfg = LlamaConfig.tiny(hidden_size=256, intermediate_size=512,
                           num_attention_heads=2, num_key_value_heads=1,
                           max_position_embeddings=256)
    seed(0)
    cpu = LlamaForCausalLM(cfg, device="cpu")
    gpu = LlamaForCausalLM(cfg, device=dev)
    gpu.set_state_dict({k: v.numpy() for k, v in cpu.state_dict().items()})
    ids = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 129))
    batch = {"input_ids": ids[:, :-1], "labels": ids[:, 1:]}
    kernels.reset_launch_counts()
    losses, grads = [], []
    for model in (cpu, gpu):
        t = {k: torch.as_tensor(v).to(model.device) for k, v in batch.items()}
        loss = model.loss(t["input_ids"], t["labels"])
        loss.backward()
        losses.append(float(loss.detach()))
        grads.append({n: p.grad.cpu() for n, p in model.named_parameters()})
        model.clear_gradients()
    assert all(fn.launches > 0 for fn in kernels.TRAINING)
    assert abs(losses[0] - losses[1]) <= 1e-5 * abs(losses[0])
    for n, ref in grads[0].items():
        # fp32 sums in another order: 1e-4 of the largest magnitude
        scale = float(ref.abs().max())
        err = float((grads[1][n] - ref).abs().max())
        assert err <= 1e-4 * scale + 1e-7, (n, err, scale)
    for model in (cpu, gpu):
        TrainStep(model, AdamW(learning_rate=1e-3))(batch)
    # Adam's first update is lr * g / (|g| + eps) per element: where a
    # gradient is near eps the two sum orders can move an element by up
    # to lr; elsewhere they agree to fp32 rounding.  0.1 lr bounds both.
    for (n, a), b in zip(cpu.state_dict().items(),
                         gpu.state_dict().values()):
        np.testing.assert_allclose(b.cpu().numpy(), a.numpy(), atol=1e-4,
                                   rtol=1e-4, err_msg=n)


def test_train_step_at_the_default_precision_against_float32(dev):
    """The small model of the test above (fp32), whole, on the card at
    the flag's default (the chunked CE's products in TF32, every other
    product as the process sets it): loss and every parameter's gradient
    within CE_TF32_TOL of the same step at float32, the training kernels
    launched, and the process's TF32 setting unchanged."""
    from paddle_tpu_torch import flags, seed
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.ops import kernels
    cfg = LlamaConfig.tiny(hidden_size=256, intermediate_size=512,
                           num_attention_heads=2, num_key_value_heads=1,
                           max_position_embeddings=256)
    seed(0)
    gpu = LlamaForCausalLM(cfg, device=dev)
    ids = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 129)), device=dev)
    saved = flags.get("default_matmul_precision")
    kernels.reset_launch_counts()
    out = {}
    try:
        for mode in ("float32", "default"):
            flags.set_flags({"default_matmul_precision": mode})
            loss = gpu.loss(ids[:, :-1], ids[:, 1:])
            loss.backward()
            assert torch.backends.cuda.matmul.allow_tf32 is False
            out[mode] = (float(loss.detach()),
                         {n: p.grad.clone() for n, p in
                          gpu.named_parameters()})
            gpu.clear_gradients()
    finally:
        flags.set_flags({"default_matmul_precision": saved})
    assert all(fn.launches > 0 for fn in kernels.TRAINING)
    (l32, g32), (ltf, gtf) = out["float32"], out["default"]
    tol = CE_TF32_TOL[torch.float32]
    assert abs(ltf - l32) <= tol["loss_rel"] * abs(l32), (ltf, l32)
    for n, ref in g32.items():
        assert torch.isfinite(gtf[n]).all(), n
        err, scale = float((gtf[n] - ref).abs().max()), float(
            ref.abs().max())
        assert err <= tol["grad_of_max"] * scale, (n, err, scale)


# -- the MoE training slice: the grouped expert FFN ---------------------------

def _grouped_inputs(rng, G, E, C, d, h, dtype, dev):
    x = _t(rng, (G, C, d), dtype, dev)
    w1 = _t(rng, (E, d, h), dtype, dev, d ** -0.5)
    b1 = _t(rng, (E, h), dtype, dev, 0.1)
    w2 = _t(rng, (E, h, d), dtype, dev, h ** -0.5)
    b2 = _t(rng, (E, d), dtype, dev, 0.1)
    return x, w1, b1, w2, b2


def _grouped_counts(G, C):
    """Per group: 0, C, a partial count, C - 1, repeating."""
    pattern = [0, C, C // 2 + 3, C - 1]
    return torch.tensor([pattern[g % 4] for g in range(G)],
                        dtype=torch.int32)


# (G, E, C, d, h): full 64-row tiles; C = 100, the last tile partial; rep 2
GROUPED_SHAPES = [(4, 4, 64, 128, 64), (4, 4, 100, 128, 192),
                  (8, 4, 96, 64, 128)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,E,C,d,h", GROUPED_SHAPES)
def test_grouped_ffn_matches_plain(dev, dtype, G, E, C, d, h):
    """Counts 0, C, partial and C - 1 in turn: the kernel pair against
    its plain version; rows past each count exactly zero; one launch."""
    rng = np.random.default_rng(G * 13 + C)
    args = _grouped_inputs(rng, G, E, C, d, h, dtype, dev)
    counts = _grouped_counts(G, C).to(dev)
    n0 = GM.grouped_expert_ffn.launches
    got = GM.grouped_expert_ffn(*args, counts=counts)
    assert GM.grouped_expert_ffn.launches == n0 + 1
    _close(got, GM.grouped_expert_ffn_reference(*args, counts=counts), dtype)
    rows = torch.arange(C, device=dev)[None, :] >= counts[:, None].long()
    assert not got[rows].any()
    full = GM.grouped_expert_ffn(*args)            # counts None: every row
    _close(full, GM.grouped_expert_ffn_reference(*args), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_ffn_gradients_on_the_card(dev, dtype):
    """``GroupedExpertFFN`` on the card (kernel forward, the masked
    product chain backward) against the same Function on the CPU (plain
    forward and backward) on the same inputs: output and the gradient of
    x and every weight."""
    G, E, C, d, h = 8, 4, 100, 128, 64
    rng = np.random.default_rng(5)
    args = _grouped_inputs(rng, G, E, C, d, h, dtype, dev)
    counts = _grouped_counts(G, C)
    r = _t(rng, (G, C, d), dtype, dev)
    outs, grads = [], []
    for where in (dev, torch.device("cpu")):
        ts = [a.detach().to(where).requires_grad_(True) for a in args]
        y = GM.GroupedExpertFFN.apply(*ts, counts.to(where), "gelu")
        (y.float() * r.to(where).float()).sum().backward()
        outs.append(y.detach().cpu())
        grads.append([t.grad.cpu() for t in ts])
    _close(outs[0], outs[1], dtype)
    for g, ref in zip(grads[0], grads[1]):
        _close(g, ref, dtype)


def test_grouped_ffn_refuses_what_the_kernel_does_not_take(dev):
    rng = np.random.default_rng(9)
    x, w1, b1, w2, b2 = _grouped_inputs(rng, 2, 2, 64, 128, 64,
                                        torch.bfloat16, dev)
    with pytest.raises(TypeError, match="w1"):
        GM.grouped_expert_ffn(x, w1.float(), b1, w2, b2)
    with pytest.raises(ValueError, match="contiguous"):
        GM.grouped_expert_ffn(x.transpose(1, 2).contiguous().transpose(1, 2),
                              w1, b1, w2, b2)
    with pytest.raises(ValueError, match="multiple of 64"):
        GM.grouped_expert_ffn(x[..., :96].contiguous(), w1[:, :96].contiguous(),
                              b1, w2[..., :96].contiguous(),
                              b2[:, :96].contiguous())
    with pytest.raises(ValueError, match="counts is on"):
        GM.grouped_expert_ffn(x, w1, b1, w2, b2,
                              counts=torch.tensor([1, 2], dtype=torch.int32))
    with pytest.raises(ValueError, match="exact gelu only"):
        GM.grouped_expert_ffn(x, w1, b1, w2, b2, act="relu")


def test_moe_train_step_on_the_card_matches_the_cpu_port(dev,
                                                         fp32_products):
    """A tiny flash-eligible ERNIE-shaped config (head_dim 128, seq 128;
    one dense and one MoE layer) in fp32, einsum then index dispatch: two
    TrainStep updates on the card and on the CPU from the same weights;
    losses within 1e-5 relative, the parameters within 1e-4; the grouped
    kernel launched once a forward (one MoE layer), flash in both layers
    and the SwiGLU pair in the dense and shared MLPs."""
    from paddle_tpu_torch import seed
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import ErnieForCausalLM, ernie45_moe_config
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.optimizer import AdamW
    ids = np.random.default_rng(3).integers(0, 256, (2, 129))
    batch = {"input_ids": ids[:, :-1], "labels": ids[:, 1:]}
    for mode in ("einsum", "index"):
        cfg = ernie45_moe_config(
            vocab_size=256, hidden_size=256, intermediate_size=256,
            moe_intermediate_size=64, num_hidden_layers=2,
            num_attention_heads=2, num_key_value_heads=1, num_experts=4,
            num_experts_per_tok=2, num_shared_experts=1,
            max_position_embeddings=256, dtype="float32",
            dispatch_mode=mode)
        seed(0)
        cpu = ErnieForCausalLM(cfg, device="cpu")
        gpu = ErnieForCausalLM(cfg, device=dev)
        gpu.set_state_dict({k: v.numpy()
                            for k, v in cpu.state_dict().items()})
        steps = [TrainStep(m, AdamW(learning_rate=1e-3,
                                    multi_precision=True))
                 for m in (cpu, gpu)]
        kernels.reset_launch_counts()
        for _ in range(2):
            ref, got = (float(st(batch)) for st in steps)
            assert abs(got - ref) <= 1e-5 * abs(ref), (mode, got, ref)
        launched = {fn.__name__: fn.launches for fn in kernels.TRAINING_MOE}
        assert launched["grouped_expert_ffn"] == 2, launched
        assert launched["flash_attention_fwd"] == 4, launched
        assert launched["flash_attention_bwd_dq"] == 4, launched
        assert launched["fused_mlp"] == 4, launched
        for (n, a), b in zip(cpu.state_dict().items(),
                             gpu.state_dict().values()):
            np.testing.assert_allclose(b.cpu().numpy(), a.numpy(),
                                       atol=1e-4, rtol=1e-4, err_msg=n)


# -- the GPT slice: the fused softmax cross-entropy ---------------------------

# (T, V): a warp per row (V < 256 vectors), V = 1 and 5, the unpadded GPT-2
# vocab (rows off the 16-byte grid, a tail), a padded one
CE_SHAPES = [(1, 5), (7, 1), (3, 100), (37, 50257), (64, 1024), (5, 129)]


def _ce_inputs(rng, T, V, dtype, dev):
    x = _t(rng, (T, V), dtype, dev, 3.0)
    lbl = torch.as_tensor(rng.integers(0, V, T)).to(dev)
    if T > 2:
        lbl[1] = V                       # outside [0, V): loss = lse
        lbl[2] = -7
    if V > 4:
        x[:, 3] = -float("inf")          # a masked vocab entry: p = 0
        lbl[lbl == 3] = 4
    return x, lbl


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("T,V", CE_SHAPES)
def test_cross_entropy_kernels_match_plain(dev, dtype, T, V):
    """Loss and lse (fp32, summed in another order: 1e-4) and dx (one
    rounding to the logits' type) of each kernel against its plain
    version; one launch each."""
    rng = np.random.default_rng(T * 31 + V)
    x, lbl = _ce_inputs(rng, T, V, dtype, dev)
    n0, n1 = CE.cross_entropy_fwd.launches, CE.cross_entropy_bwd.launches
    loss, lse = CE.cross_entropy_fwd(x, lbl)
    rloss, rlse = CE.ce_fwd_reference(x, lbl)
    _close(loss, rloss, torch.float32)
    _close(lse, rlse, torch.float32)
    g = _t(rng, (T,), torch.float32, dev)
    _close(CE.cross_entropy_bwd(x, lbl, lse, g),
           CE.ce_bwd_reference(x, lbl, lse, g), dtype)
    assert CE.cross_entropy_fwd.launches == n0 + 1
    assert CE.cross_entropy_bwd.launches == n1 + 1


def test_cross_entropy_kernels_past_2_31_elements(dev):
    """T * V = 2^31 + V bf16 logits (4.3 GB): the last row starts at
    element 2^31, past a 32-bit offset.  Its loss, lse and dx against the
    plain version on that row alone."""
    T, V = 16385, 131072
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((T, V), generator=g, device=dev, dtype=torch.bfloat16)
    lbl = torch.randint(0, V, (T,), generator=g, device=dev)
    loss, lse = CE.cross_entropy_fwd(x, lbl)
    rloss, rlse = CE.ce_fwd_reference(x[-2:], lbl[-2:])
    _close(loss[-2:], rloss, torch.float32)
    _close(lse[-2:], rlse, torch.float32)
    cot = torch.ones(T, device=dev)
    dx = CE.cross_entropy_bwd(x, lbl, lse, cot)
    _close(dx[-2:], CE.ce_bwd_reference(x[-2:], lbl[-2:], lse[-2:],
                                        cot[-2:]), torch.bfloat16)
    del x, dx
    torch.cuda.empty_cache()


def test_cross_entropy_kernels_on_a_row_of_neg_inf(dev):
    """A row that is -inf throughout: lse -inf, the loss NaN for a label
    in range and -inf for one outside, as the plain version gives."""
    x = torch.zeros(3, 300, device=dev)
    x[1] = -float("inf")
    x[2] = -float("inf")
    lbl = torch.tensor([0, 5, 300], device=dev)
    loss, lse = CE.cross_entropy_fwd(x, lbl)
    rloss, rlse = CE.ce_fwd_reference(x, lbl)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(lse.cpu().numpy(), rlse.cpu().numpy())
    np.testing.assert_array_equal(loss.cpu().numpy(), rloss.cpu().numpy())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cross_entropy_gradients_on_the_card(dev, dtype):
    """``F.cross_entropy`` with ``ignore_index`` labels through the fused
    CE Function on the card against the same call on the CPU (plain
    versions): the mean loss within 1e-5 relative and dlogits within the
    dtype's limit; ignored rows get exactly zero gradient; one launch of
    each kernel."""
    from paddle_tpu_torch.nn import functional as TF
    rng = np.random.default_rng(8)
    x = _t(rng, (4, 33, 1000), dtype, dev, 2.0)
    lbl = torch.as_tensor(rng.integers(0, 1000, (4, 33)))
    lbl[0, :9] = -100
    n0, n1 = CE.cross_entropy_fwd.launches, CE.cross_entropy_bwd.launches
    res = []
    for where in (dev, torch.device("cpu")):
        xi = x.detach().to(where).requires_grad_(True)
        loss = TF.cross_entropy(xi, lbl.to(where))
        loss.backward()
        res.append((float(loss.detach()), xi.grad.cpu()))
    assert CE.cross_entropy_fwd.launches == n0 + 1
    assert CE.cross_entropy_bwd.launches == n1 + 1
    assert abs(res[0][0] - res[1][0]) <= 1e-5 * abs(res[1][0])
    _close(res[0][1], res[1][1], dtype)
    assert not res[0][1][0, :9].any()


# -- the nn.Transformer slice: the act + bias feed-forward --------------------

FFN_SHAPES = [(1, 64, 128), (37, 128, 192), (300, 512, 2048)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ["relu", "gelu", "silu"])
@pytest.mark.parametrize("T,d,f", FFN_SHAPES)
def test_fused_ffn_matches_plain(dev, dtype, act, T, d, f):
    """The kernel pair against ``ffn_reference`` with biases (and with
    none, which the wrapper makes zeros); one launch per call."""
    rng = np.random.default_rng(T + d + f)
    x = _t(rng, (T, d), dtype, dev)
    w1 = _t(rng, (d, f), dtype, dev, d ** -0.5)
    w2 = _t(rng, (f, d), dtype, dev, f ** -0.5)
    b1 = _t(rng, (f,), dtype, dev, 0.5)
    b2 = _t(rng, (d,), dtype, dev, 0.5)
    n0 = FB.fused_ffn.launches
    _close(FB.fused_ffn(x, w1, w2, b1, b2, act),
           FB.ffn_reference(x, w1, b1, w2, b2, act), dtype)
    zeros = torch.zeros(f, dtype=dtype, device=dev)
    _close(FB.fused_ffn(x, w1, w2, activation=act),
           FB.ffn_reference(x, w1, zeros, w2, zeros[:d], act), dtype)
    assert FB.fused_ffn.launches == n0 + 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_ffn_gradients_on_the_card(dev, dtype):
    """``FusedFFN`` through ``F.fused_ffn`` on the card (kernel forward,
    product backward) against the same call on the CPU (plain forward)
    on the same inputs: the output and the gradient of x, both weights
    and both biases."""
    from paddle_tpu_torch.nn import functional as TF
    rng = np.random.default_rng(12)
    T, d, f = 70, 128, 256
    args = [_t(rng, s, dtype, dev, sc) for s, sc in
            (((T, d), 1.0), ((d, f), d ** -0.5), ((f, d), f ** -0.5),
             ((f,), 0.5), ((d,), 0.5))]
    r = _t(rng, (T, d), dtype, dev)
    outs, grads = [], []
    for where in (dev, torch.device("cpu")):
        ts = [a.detach().to(where).requires_grad_(True) for a in args]
        y = TF.fused_ffn(*ts, activation="gelu")
        (y.float() * r.to(where).float()).sum().backward()
        outs.append(y.detach().cpu())
        grads.append([t.grad.cpu() for t in ts])
    _close(outs[0], outs[1], dtype)
    for g, ref in zip(grads[0], grads[1]):
        _close(g, ref, dtype)


def test_ce_and_ffn_wrappers_refuse_what_the_kernels_do_not_take(dev):
    x = torch.zeros(4, 128, device=dev)
    w = torch.zeros(128, 128, device=dev)
    with pytest.raises(ValueError, match="multiple of 64"):
        FB.fused_ffn(x[:, :96].contiguous(), w[:96, :96].contiguous(),
                     w[:96, :96].contiguous())
    with pytest.raises(TypeError, match="w1"):
        FB.fused_ffn(x, w.bfloat16(), w)
    with pytest.raises(ValueError, match="contiguous"):
        CE.cross_entropy_fwd(x.t(), torch.zeros(128, dtype=torch.long,
                                                device=dev))
    with pytest.raises(ValueError, match="labels is on"):
        CE.cross_entropy_fwd(x, torch.zeros(4, dtype=torch.long))
    with pytest.raises(TypeError, match="float64"):
        CE.cross_entropy_fwd(x.double(), torch.zeros(4, dtype=torch.long,
                                                     device=dev))


@pytest.mark.parametrize("failure", ["build", "launch"])
def test_ce_and_ffn_wrappers_raise_when_the_library_fails(dev, monkeypatch,
                                                          failure):
    """With the library loader patched to fail (or to hand back a library
    whose every launch reports a CUDA error), the CE and FFN wrappers
    raise on CUDA tensors and count no launch: nothing carries on in
    plain PyTorch."""
    class Refusing:
        def __getattr__(self, name):
            if name == "ptt_error_string":
                return lambda code: b"invalid argument"
            return lambda *args: 1          # cudaErrorInvalidValue

    def loader(name):
        if failure == "build":
            raise RuntimeError("nvcc failed: patched")
        return Refusing()

    monkeypatch.setattr(_build, "library", loader)
    x = torch.zeros(4, 128, device=dev)
    lbl = torch.zeros(4, dtype=torch.long, device=dev)
    w = torch.zeros(128, 128, device=dev)
    n = (CE.cross_entropy_fwd.launches, CE.cross_entropy_bwd.launches,
         FB.fused_ffn.launches)
    match = "patched" if failure == "build" else "CUDA error 1"
    with pytest.raises(RuntimeError, match=match):
        CE.cross_entropy_fwd(x, lbl)
    with pytest.raises(RuntimeError, match=match):
        CE.cross_entropy_bwd(x, lbl, torch.zeros(4, device=dev),
                             torch.ones(4, device=dev))
    with pytest.raises(RuntimeError, match=match):
        FB.fused_ffn(x, w, w)
    assert n == (CE.cross_entropy_fwd.launches,
                 CE.cross_entropy_bwd.launches, FB.fused_ffn.launches)


def test_sdpa_with_active_dropout_skips_flash(dev):
    """An eligible flash shape with dropout in training takes the plain
    path (no flash launch); in eval the same call launches flash."""
    from paddle_tpu_torch.nn import functional as TF
    rng = np.random.default_rng(13)
    q = _t(rng, (1, 128, 2, 128), torch.bfloat16, dev)
    n0 = FA.flash_attention_fwd.launches
    TF.scaled_dot_product_attention(q, q, q, is_causal=True, dropout_p=0.1,
                                    training=True)
    assert FA.flash_attention_fwd.launches == n0
    TF.scaled_dot_product_attention(q, q, q, is_causal=True, dropout_p=0.1,
                                    training=False)
    assert FA.flash_attention_fwd.launches == n0 + 1


def test_gpt_train_step_on_the_card_matches_the_cpu_port(dev):
    """A tiny GPT whose attention takes flash through the head_dim-64 pad
    (2 heads of 64, seq 1024), fp32: three TrainStep updates on the card
    and on the CPU from the same weights; losses within 1e-5 relative and
    the parameters within 1e-4 (the key bias excepted: its gradient is
    zero up to rounding, so Adam steps it by up to lr either way); the CE
    kernels once a step each, flash in both layers."""
    from paddle_tpu_torch import seed
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.optimizer import AdamW
    cfg = GPTConfig.tiny(hidden_size=128, num_attention_heads=2,
                         max_position_embeddings=1024)
    seed(0)
    cpu = GPTForCausalLM(cfg, device="cpu")
    gpu = GPTForCausalLM(cfg, device=dev)
    gpu.set_state_dict({k: v.numpy() for k, v in cpu.state_dict().items()})
    ids = np.random.default_rng(4).integers(0, cfg.vocab_size, (1, 1025))
    batch = {"input_ids": ids[:, :-1], "labels": ids[:, 1:]}
    steps = [TrainStep(m, AdamW(learning_rate=1e-3, multi_precision=True))
             for m in (cpu, gpu)]
    kernels.reset_launch_counts()
    for _ in range(3):
        ref, got = (float(st(batch)) for st in steps)
        assert abs(got - ref) <= 1e-5 * abs(ref), (got, ref)
    launched = {fn.__name__: fn.launches for fn in kernels.TRAINING_GPT}
    assert launched == {"cross_entropy_fwd": 3, "cross_entropy_bwd": 3,
                        "flash_attention_fwd": 6,
                        "flash_attention_bwd_dq": 6,
                        "flash_attention_bwd_dkv": 6}, launched
    d = cfg.hidden_size
    for (n, a), b in zip(cpu.state_dict().items(),
                         gpu.state_dict().values()):
        a, b = a.numpy(), b.cpu().numpy()
        if n.endswith("qkv_proj.bias"):
            np.testing.assert_allclose(b[d:2 * d], a[d:2 * d], atol=3e-3)
            a, b = np.delete(a, np.s_[d:2 * d]), np.delete(b, np.s_[d:2 * d])
        np.testing.assert_allclose(b, a, atol=1e-4, rtol=1e-4, err_msg=n)


def test_transformer_on_the_card_matches_the_cpu_port(dev):
    """A 2 + 2-layer Transformer (d_model 128, FFN 256, relu) in eval,
    fp32, with the causal target mask: the card (fused FFN kernel in all
    four layers) against the CPU port on the same weights, 1e-4."""
    from paddle_tpu_torch.nn import Transformer
    from paddle_tpu_torch import seed
    seed(1)
    kw = dict(d_model=128, nhead=4, num_encoder_layers=2,
              num_decoder_layers=2, dim_feedforward=256)
    cpu = Transformer(**kw, device="cpu").eval()
    gpu = Transformer(**kw, device=dev).eval()
    gpu.set_state_dict({k: v.numpy() for k, v in cpu.state_dict().items()})
    rng = np.random.default_rng(14)
    src = torch.as_tensor(rng.standard_normal((3, 40, 128)),
                          dtype=torch.float32)
    tgt = torch.as_tensor(rng.standard_normal((3, 24, 128)),
                          dtype=torch.float32)
    mask = Transformer.generate_square_subsequent_mask(24)
    n0 = FB.fused_ffn.launches
    with torch.inference_mode():
        got = gpu(src.to(dev), tgt.to(dev), tgt_mask=mask.to(dev))
        ref = cpu(src, tgt, tgt_mask=mask)
    assert FB.fused_ffn.launches == n0 + 4
    _close(got, ref, torch.float32)


# -- the decoder tier: the whole-block kernel and the residual rmsnorm --------

def _rel_err(got, ref):
    torch.cuda.synchronize()
    g, r = got.float(), ref.float()
    assert torch.isfinite(g).all()
    return float((g - r).abs().max()) / max(float(r.abs().max()), 1e-6)


def _decoder_args(rng, b, s, d, nh, nkvh, f, dtype, dev):
    from paddle_tpu_torch.nn.functional import rotary_freqs
    hd = 128
    dq, dkv = nh * hd, nkvh * hd
    w = lambda i, o: _t(rng, (i, o), dtype, dev, i ** -0.5)
    cos, sin = rotary_freqs(hd, s + 64, base=500000.0, device=dev)
    return (_t(rng, (b, s, d), dtype, dev),
            _t(rng, (d,), dtype, dev, 0.1) + 1.0, w(d, dq), w(d, dkv),
            w(d, dkv), cos, sin, w(dq, d),
            _t(rng, (d,), dtype, dev, 0.1) + 1.0, w(d, f), w(d, f), w(f, d),
            nh, nkvh, 1e-5)


# (b, s, d, heads, kv heads, f): GQA rep 1, rep 4, and b=1 at an s that is
# a multiple of 128 but not of 256
DECODER_SHAPES = [(2, 128, 256, 2, 2, 512), (2, 256, 512, 4, 1, 768),
                  (1, 384, 256, 2, 1, 256)]
# the block against its plain version, as a share of the output's largest
# magnitude: fp32 products in another order (1e-4); in bf16 both round at
# the same cast points, and a bf16 step flipped by another summation order
# carries through the block (3e-2, the JAX test's bf16 limit)
DECODER_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,d,nh,nkvh,f", DECODER_SHAPES)
def test_decoder_block_matches_plain(dev, dtype, b, s, d, nh, nkvh, f):
    args = _decoder_args(np.random.default_rng(s + nh), b, s, d, nh, nkvh,
                         f, dtype, dev)
    assert FB.fused_decoder_eligible(b, s, d, nh * 128, nkvh * 128, 128, f,
                                     dtype)
    n0 = FB.fused_decoder_block.launches
    got = FB.fused_decoder_block(*args)
    assert FB.fused_decoder_block.launches == n0 + 1
    assert got.dtype == dtype and got.shape == (b, s, d)
    assert _rel_err(got, FB.decoder_reference(*args)) < DECODER_TOL[dtype]


def test_decoder_block_backward_matches_the_plain_remat(dev):
    """fp32, rep 2: F.fused_decoder_block's gradients (the block kernel
    forward, then the recompute through the QKV training variant, flash,
    the rmsnorm kernel and the MLP pair) against autograd of the plain
    version on the card, within 1e-4 of each gradient's largest
    magnitude; one launch of each kernel."""
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops import kernels
    args = _decoder_args(np.random.default_rng(3), 2, 128, 256, 2, 1, 512,
                         torch.float32, dev)
    g = _t(np.random.default_rng(4), (2, 128, 256), torch.float32, dev)
    grads = []
    kernels.reset_launch_counts()
    for fn in (F.fused_decoder_block, FB.decoder_reference):
        leaves = [a.detach().clone().requires_grad_(i not in (5, 6))
                  if torch.is_tensor(a) else a for i, a in enumerate(args)]
        fn(*leaves).backward(g)
        grads.append([t.grad for t in leaves[:12] if torch.is_tensor(t)
                      and t.grad is not None])
    assert {fn.__name__: fn.launches for fn in kernels.DECODER_TRAINING} \
        == dict.fromkeys((fn.__name__ for fn in kernels.DECODER_TRAINING), 1)
    assert len(grads[0]) == len(grads[1]) == 10
    for got, ref in zip(*grads):
        assert _rel_err(got, ref) < 1e-4


def test_decoder_block_at_an_ineligible_shape_takes_the_segments(dev):
    """head_dim 64: no block launch; the per-segment kernels compute the
    same block (fp32, 1e-4 of the largest magnitude)."""
    from paddle_tpu_torch.nn.functional import rotary_freqs
    rng = np.random.default_rng(8)
    b, s, d, nh, f = 2, 128, 256, 4, 512
    args = list(_decoder_args(rng, b, s, d, 2, 2, f, torch.float32, dev))
    args[5], args[6] = rotary_freqs(64, s, device=dev)
    args[12:14] = [nh, nh]
    n0 = (FB.fused_decoder_block.launches, FB.fused_rmsnorm_qkv.launches)
    got = FB.fused_decoder_block(*args)
    assert FB.fused_decoder_block.launches == n0[0]
    assert FB.fused_rmsnorm_qkv.launches == n0[1] + 1
    assert _rel_err(got, FB.decoder_reference(*args)) < 1e-4


def test_decoder_tier_train_step_on_the_card_matches_the_cpu_port(
        dev, monkeypatch, fp32_products):
    """The tiny hd-128 config (2 layers, s=128) at the decoder tier, fp32:
    the loss and every gradient on the card (block kernel forward, remat
    through the per-segment kernels) against the CPU port's plain path,
    loss within 1e-5 relative and each gradient within 1e-4 of its
    largest magnitude; two block launches."""
    from paddle_tpu_torch import seed
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.ops import kernels
    monkeypatch.setenv("PADDLE_TPU_FUSED_BLOCK", "decoder")
    cfg = LlamaConfig.tiny(hidden_size=256, intermediate_size=512,
                           num_attention_heads=2, num_key_value_heads=1,
                           max_position_embeddings=256)
    seed(0)
    cpu = LlamaForCausalLM(cfg, device="cpu")
    gpu = LlamaForCausalLM(cfg, device=dev)
    gpu.set_state_dict({k: v.numpy() for k, v in cpu.state_dict().items()})
    ids = torch.as_tensor(np.random.default_rng(1).integers(0, 256,
                                                            (2, 129)))
    kernels.reset_launch_counts()
    losses, grads = [], []
    for model in (cpu, gpu):
        loss = model.loss(ids[:, :-1].to(model.device),
                          ids[:, 1:].to(model.device))
        loss.backward()
        losses.append(float(loss.detach()))
        grads.append({n: p.grad.cpu() for n, p in model.named_parameters()})
    assert FB.fused_decoder_block.launches == 2
    assert FB.fused_decoder_block.routes == {"decoder": 4, "segments": 0}
    assert abs(losses[0] - losses[1]) <= 1e-5 * abs(losses[0])
    for n, ref in grads[0].items():
        assert _rel_err(grads[1][n], ref) < 1e-4, n


# (rows, d): ragged rows at the step's width, an odd d, a d whose bf16
# rows are off the 16-byte grid, a tiny row
NORM_SHAPES = [(37, 4096), (5, 1001), (16, 100), (3, 8)]


@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,d", NORM_SHAPES)
def test_rmsnorm_matches_plain(dev, dtype, residual, rows, d):
    """y, h and inv against rmsnorm_reference: h is the same fp32 sum
    rounded once (equal); inv an fp32 sum of d squares in another order
    (1e-5); y in fp32 within 1e-5, in bf16 within one bf16 step (2^-7
    of the value: inv's last bits may flip a rounding)."""
    rng = np.random.default_rng(rows * d)
    x = _t(rng, (rows, d), dtype, dev)
    r = _t(rng, (rows, d), dtype, dev) if residual else None
    w = _t(rng, (d,), dtype, dev, 0.1) + 1.0
    n0 = RN.fused_rmsnorm.launches
    y, h, inv = RN.fused_rmsnorm(x, w, r, 1e-5)
    assert RN.fused_rmsnorm.launches == n0 + 1
    ry, rh, rinv = RN.rmsnorm_reference(x, w, r, 1e-5)
    torch.cuda.synchronize()
    assert torch.equal(h, rh)
    np.testing.assert_allclose(inv.cpu().numpy(), rinv.cpu().numpy(),
                               rtol=1e-5)
    tol = 1e-5 if dtype == torch.float32 else 2 ** -7
    np.testing.assert_allclose(y.float().cpu().numpy(),
                               ry.float().cpu().numpy(), rtol=tol, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_off_the_16_byte_grid(dev, dtype):
    """Operands that start one element past a 16-byte boundary take the
    element-wise path: the same results."""
    rng = np.random.default_rng(21)
    rows, d = 9, 256
    buf = torch.zeros(2 * rows * d + 2, dtype=dtype, device=dev)
    x = buf[1:1 + rows * d].view(rows, d)
    r = buf[2 + rows * d:].view(rows, d)
    x.copy_(_t(rng, (rows, d), dtype, dev))
    r.copy_(_t(rng, (rows, d), dtype, dev))
    w = _t(rng, (d,), dtype, dev, 0.1) + 1.0
    assert x.data_ptr() % 16 and r.data_ptr() % 16
    y, h, inv = RN.fused_rmsnorm(x, w, r, 1e-5)
    ry, rh, _ = RN.rmsnorm_reference(x, w, r, 1e-5)
    torch.cuda.synchronize()
    assert torch.equal(h, rh)
    tol = 1e-5 if dtype == torch.float32 else 2 ** -7
    np.testing.assert_allclose(y.float().cpu().numpy(),
                               ry.float().cpu().numpy(), rtol=tol, atol=1e-6)


def test_rms_norm_residual_gradients_on_the_card(dev):
    """F.rms_norm_residual forward and backward on the card against the
    CPU port (the same custom VJP over the plain version), fp32, 1e-5."""
    from paddle_tpu_torch.nn import functional as F
    rng = np.random.default_rng(22)
    host = [torch.as_tensor(rng.standard_normal(s), dtype=torch.float32)
            for s in ((4, 33, 512), (4, 33, 512), (512,))]
    gy, gh = (torch.as_tensor(rng.standard_normal((4, 33, 512)),
                              dtype=torch.float32) for _ in range(2))
    out = []
    for where in ("cpu", dev):
        leaves = [t.clone().to(where).requires_grad_(True) for t in host]
        y, h = F.rms_norm_residual(leaves[0], leaves[2], leaves[1], 1e-5)
        torch.autograd.backward((y, h), (gy.to(where), gh.to(where)))
        out.append([y.detach().cpu(), h.detach().cpu()] +
                   [t.grad.cpu() for t in leaves])
    for got, ref in zip(out[1], out[0]):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("failure", ["build", "launch"])
def test_decoder_and_rmsnorm_wrappers_raise_when_the_library_fails(
        dev, monkeypatch, failure):
    """A failed build, or a launch (the cooperative one included) that
    reports a CUDA error, raises on CUDA tensors and counts no launch."""
    class Refusing:
        def __getattr__(self, name):
            if name == "ptt_error_string":
                return lambda code: b"too many blocks in cooperative launch"
            return lambda *args: 720   # cudaErrorCooperativeLaunchTooLarge

    def loader(name):
        if failure == "build":
            raise RuntimeError("nvcc failed: patched")
        return Refusing()

    monkeypatch.setattr(_build, "library", loader)
    args = _decoder_args(np.random.default_rng(9), 1, 128, 256, 2, 1, 256,
                         torch.bfloat16, dev)
    n = (FB.fused_decoder_block.launches, RN.fused_rmsnorm.launches)
    match = "patched" if failure == "build" else "CUDA error 720"
    with pytest.raises(RuntimeError, match=match):
        FB.fused_decoder_block(*args)
    with pytest.raises(RuntimeError, match=match):
        RN.fused_rmsnorm(args[0], args[1])
    assert n == (FB.fused_decoder_block.launches, RN.fused_rmsnorm.launches)


# -- the Hopper redesigns: wgmma / TMA flash forward and QKV GEMM -------------

# (mode, n) of hopper.cuh's descriptor check: B K-major (flash's K rows;
# n = 64 is every flash score tile, forward and backward: S, dP, S^T,
# dP^T), MN-major (the weights, flash's V), MN-major with A from registers
# (flash's P V and the backward's dS K, P^T dO and dS^T Q)
WGMMA_CASES = [(0, 64), (0, 128), (0, 256), (1, 128), (1, 256), (2, 128)]


@pytest.mark.parametrize("mode,n", WGMMA_CASES)
def test_wgmma_descriptors_match_matmul(dev, mode, n):
    """One 64 x n x 64 wgmma tile through TMA's 128-byte swizzle and the
    header's descriptors against torch.matmul in fp32: exact products of
    bf16 values, summed in fp32 in another order (1e-5 of |C| ~ 8)."""
    rng = np.random.default_rng(mode * 7 + n)
    a = _t(rng, (64, 64), torch.bfloat16, dev)
    b = _t(rng, (64, n), torch.bfloat16, dev)
    bt = b.t().contiguous() if mode == 0 else b
    c = torch.empty((64, n), dtype=torch.float32, device=dev)
    lib = _build.library("fused_block")
    _build.check(lib, lib.ptt_wgmma_check(mode, a.data_ptr(), bt.data_ptr(),
                                          c.data_ptr(), n,
                                          _build.stream_of(a)),
                 "ptt_wgmma_check")
    torch.cuda.synchronize()
    np.testing.assert_allclose(c.cpu().numpy(),
                               (a.float() @ b.float()).cpu().numpy(),
                               atol=1e-4, rtol=1e-5)


# the bf16 flash rows' limits (chip_smoke.py FLASH_TOL): one bf16 step of
# the output, plus the P roundings that another running max moves
FLASH_FWD_TOL = (4e-3, 2 ** -7)
FLASH_BWD_TOL = {"dq": (4e-3, 2 ** -7), "dkv": (8e-3, 2 ** -7)}


def _close_tol(got, ref, tol):
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               ref.float().cpu().numpy(), atol=tol[0],
                               rtol=tol[1])


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [64, 128, 192, 2048])
@pytest.mark.parametrize("hk", [8, 32])
def test_flash_fwd_hopper_matches_plain(dev, causal, s, hk):
    """The bf16 forward (wgmma, TMA, 128-row tiles; s = 64 and 192 end in
    a 64-row tile) at 32 query heads against flash_fwd_reference: out
    within FLASH_FWD_TOL, lse (fp32 statistics of the same inputs, exp2
    in place of exp) within 1e-4; one launch a call."""
    rng = np.random.default_rng(s + hk + causal)
    q, k, v, _ = _flash_inputs(rng, 1, s, 32, hk, torch.bfloat16, dev)
    n0 = FA.flash_attention_fwd.launches
    out, lse = FA.flash_attention_fwd(q, k, v, causal)
    assert FA.flash_attention_fwd.launches == n0 + 1
    ref, ref_lse = FA.flash_fwd_reference(q, k, v, causal)
    _close_tol(out, ref, FLASH_FWD_TOL)
    _close(lse, ref_lse, torch.float32)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_hopper_lse_feeds_the_backward(dev, causal):
    """The new forward's out and lse through the unchanged dq and dk/dv
    kernels, against flash_bwd_reference from the plain forward's: the
    backward recomputes P from lse, so a wrong lse convention shows
    here."""
    rng = np.random.default_rng(41 + causal)
    q, k, v, g = _flash_inputs(rng, 2, 320, 8, 2, torch.bfloat16, dev)
    out, lse = FA.flash_attention_fwd(q, k, v, causal)
    delta = FA.flash_delta(out, g)
    dq = FA.flash_attention_bwd_dq(q, k, v, g, lse, delta, causal)
    dk, dv = FA.flash_attention_bwd_dkv(q, k, v, g, lse, delta, causal)
    ref_out, ref_lse = FA.flash_fwd_reference(q, k, v, causal)
    rdq, rdk, rdv = FA.flash_bwd_reference(
        q, k, v, g, ref_lse, FA.flash_delta(ref_out, g), causal)
    _close_tol(dq, rdq, FLASH_BWD_TOL["dq"])
    _close_tol(dk, rdk, FLASH_BWD_TOL["dkv"])
    _close_tol(dv, rdv, FLASH_BWD_TOL["dkv"])


# (b, s, h, hk) of the bf16 backward (flash_dq_hopper, flash_dkv_hopper):
# one 64-row tile, the edges, and the Llama step's heads
FLASH_BWD_HOPPER_SHAPES = [(1, 64, 4, 1)] + FLASH_BWD_EDGES + \
    [(1, 2048, 32, 8)]


def _flash_bwd_check(q, k, v, g, causal, scale=None, tol=FLASH_BWD_TOL):
    """dq and dk/dv from the plain forward's out and lse, one launch
    each, within `tol` (FLASH_BWD_TOL) of flash_bwd_reference."""
    out, lse = FA.flash_fwd_reference(q, k, v, causal, scale)
    delta = FA.flash_delta(out, g)
    n0 = (FA.flash_attention_bwd_dq.launches,
          FA.flash_attention_bwd_dkv.launches)
    dq = FA.flash_attention_bwd_dq(q, k, v, g, lse, delta, causal, scale)
    dk, dv = FA.flash_attention_bwd_dkv(q, k, v, g, lse, delta, causal,
                                        scale)
    assert (FA.flash_attention_bwd_dq.launches,
            FA.flash_attention_bwd_dkv.launches) == (n0[0] + 1, n0[1] + 1)
    rdq, rdk, rdv = FA.flash_bwd_reference(q, k, v, g, lse, delta, causal,
                                           scale)
    _close_tol(dq, rdq, tol["dq"])
    _close_tol(dk, rdk, tol["dkv"])
    _close_tol(dv, rdv, tol["dkv"])
    return dq, dk, dv


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,s,h,hk", FLASH_BWD_HOPPER_SHAPES)
def test_flash_bwd_hopper_matches_plain(dev, causal, b, s, h, hk):
    """The bf16 dq and dk/dv kernels (wgmma, TMA, 128-row tiles) at
    their edge shapes against flash_bwd_reference, which rounds P and dS
    to bf16 where the kernels do: within FLASH_BWD_TOL."""
    rng = np.random.default_rng(s + 3 * h + hk + causal)
    _flash_bwd_check(*_flash_inputs(rng, b, s, h, hk, torch.bfloat16, dev),
                     causal)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_hopper_takes_a_scale(dev, causal):
    """A scale other than head_dim ** -0.5 (0.3: a peakier softmax)
    reaches both P recomputes and dS.  The limit's atol grows with the
    scale: dS carries it, and a dS whose fp32 value the kernel's exp2 and
    the plain exp put on two sides of a bf16 rounding moves an output by
    about |dS| 2^-8 |k|."""
    rng = np.random.default_rng(77 + causal)
    grow = 0.3 / 128 ** -0.5
    tol = {k: (a * grow, r) for k, (a, r) in FLASH_BWD_TOL.items()}
    _flash_bwd_check(*_flash_inputs(rng, 1, 320, 8, 2, torch.bfloat16, dev),
                     causal, scale=0.3, tol=tol)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_hopper_gpt_padded_shape(dev, causal):
    """GPT's attention through the head_dim pad (b2 s1024 h16 hk16):
    head_dim 64 zero-padded to 128, scale 64 ** -0.5, dO zero in the pad,
    as F.scaled_dot_product_attention hands them over.  The pad's columns
    of dq, dk and dv come out exactly zero."""
    rng = np.random.default_rng(1024 + causal)
    ts = _flash_inputs(rng, 2, 1024, 16, 16, torch.bfloat16, dev)
    for t in ts:
        t[..., 64:] = 0
    grads = _flash_bwd_check(*ts, causal, scale=64 ** -0.5)
    for t in grads:
        assert not bool(t[..., 64:].any())


def test_flash_dkv_hopper_is_deterministic(dev):
    """dk/dv sum each GQA group inside one block, in one order, without
    atomics: two launches on the same inputs are bitwise equal (and dq's
    too, at the Llama step's heads)."""
    rng = np.random.default_rng(99)
    q, k, v, g = _flash_inputs(rng, 2, 2048, 32, 8, torch.bfloat16, dev)
    out, lse = FA.flash_fwd_reference(q, k, v, True)
    delta = FA.flash_delta(out, g)
    runs = [(FA.flash_attention_bwd_dq(q, k, v, g, lse, delta, True),
             *FA.flash_attention_bwd_dkv(q, k, v, g, lse, delta, True))
            for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("residuals", [True, False])
@pytest.mark.parametrize("T", [17, 64, 150, 256, 8192])
@pytest.mark.parametrize("d,dq,dkv", [(256, 192, 64), (4096, 4096, 1024)])
def test_rmsnorm_qkv_hopper_matches_plain(dev, residuals, T, d, dq, dkv):
    """bf16 at T > 16: the row pass and the wgmma GEMM (128 x 256 or
    64 x 128 tiles; 192 / 64 leave a part's last tile partial) against
    qkv_reference: q, k, v within the bf16 limit; xn within one bf16 step
    and inv within 1e-6 (the same fp32 sums in another order); one launch
    counted a call."""
    rng = np.random.default_rng(T + d + residuals)
    x = _t(rng, (T, d), torch.bfloat16, dev)
    wn = _t(rng, (d,), torch.bfloat16, dev, 0.5) + 1.0
    wq = _t(rng, (d, dq), torch.bfloat16, dev, d ** -0.5)
    wk = _t(rng, (d, dkv), torch.bfloat16, dev, d ** -0.5)
    wv = _t(rng, (d, dkv), torch.bfloat16, dev, d ** -0.5)
    n0 = FB.fused_rmsnorm_qkv.launches
    got = FB.fused_rmsnorm_qkv(x, wn, wq, wk, wv, 1e-5, residuals=residuals)
    assert FB.fused_rmsnorm_qkv.launches == n0 + 1
    ref = FB.qkv_reference(x, wn, wq, wk, wv, 1e-5, residuals=residuals)
    assert len(got) == len(ref)
    for g, r in zip(got[:3], ref[:3]):
        _close(g, r, torch.bfloat16)
    if residuals:
        _close_tol(got[3], ref[3], (0.0, 2 ** -7))
        _close_tol(got[4], ref[4], (0.0, 1e-6))


def test_hopper_kernels_raise_on_a_refused_launch(dev):
    """The C entries refuse what their kernels do not take, and the
    wrappers' check raises it: bf16 QKV at T > 16 without somewhere for
    the row pass to write xn, and flash (forward, dq, dk/dv) at head_dim
    64."""
    x = torch.zeros((32, 128), dtype=torch.bfloat16, device=dev)
    w = torch.zeros((128, 128), dtype=torch.bfloat16, device=dev)
    lib = _build.library("fused_block")
    err = lib.ptt_rmsnorm_qkv(1, x.data_ptr(), w[0].data_ptr(),
                              w.data_ptr(), w.data_ptr(), w.data_ptr(),
                              x.data_ptr(), x.data_ptr(), x.data_ptr(), None,
                              None, None, None, 32, 128, 128, 128, 1e-5,
                              _build.stream_of(x),
                              ctypes.byref(ctypes.c_int()))
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        _build.check(lib, err, "fused_rmsnorm_qkv")
    q = torch.zeros((1, 128, 2, 64), dtype=torch.bfloat16, device=dev)
    lse = torch.zeros((1, 2, 128), device=dev)
    fl = _build.library("flash_attention")
    err = fl.ptt_flash_fwd(1, q.data_ptr(), q.data_ptr(), q.data_ptr(),
                           q.data_ptr(), lse.data_ptr(), 1, 128, 2, 2, 64,
                           0.125, 1, _build.stream_of(q))
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        _build.check(fl, err, "flash_attention_fwd")
    err = fl.ptt_flash_bwd_dq(1, q.data_ptr(), q.data_ptr(), q.data_ptr(),
                              q.data_ptr(), lse.data_ptr(), lse.data_ptr(),
                              q.data_ptr(), 1, 128, 2, 2, 64, 0.125, 1,
                              _build.stream_of(q))
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        _build.check(fl, err, "flash_attention_bwd_dq")
    err = fl.ptt_flash_bwd_dkv(1, q.data_ptr(), q.data_ptr(), q.data_ptr(),
                               q.data_ptr(), lse.data_ptr(), lse.data_ptr(),
                               q.data_ptr(), q.data_ptr(), 1, 128, 2, 2, 64,
                               0.125, 1, _build.stream_of(q))
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        _build.check(fl, err, "flash_attention_bwd_dkv")


@pytest.mark.parametrize("failure", ["build", "launch"])
def test_flash_and_qkv_wrappers_raise_when_the_library_fails(
        dev, monkeypatch, failure):
    """A failed build, or a launch that reports a CUDA error, raises from
    the bf16 flash forward, dq and dk/dv and the bf16 QKV path at T > 16,
    and counts no launch."""
    class Refusing:
        def __getattr__(self, name):
            if name == "ptt_error_string":
                return lambda code: b"invalid argument"
            return lambda *args: 1          # cudaErrorInvalidValue

    def loader(name):
        if failure == "build":
            raise RuntimeError("nvcc failed: patched")
        return Refusing()

    monkeypatch.setattr(_build, "library", loader)
    rng = np.random.default_rng(12)
    q, k, v, g = _flash_inputs(rng, 1, 128, 4, 2, torch.bfloat16, dev)
    lse = torch.zeros((1, 4, 128), device=dev)
    x = _t(rng, (64, 128), torch.bfloat16, dev)
    w = _t(rng, (128, 128), torch.bfloat16, dev)
    wrappers = (FA.flash_attention_fwd, FA.flash_attention_bwd_dq,
                FA.flash_attention_bwd_dkv, FB.fused_rmsnorm_qkv)
    n = [fn.launches for fn in wrappers]
    match = "patched" if failure == "build" else "CUDA error 1"
    with pytest.raises(RuntimeError, match=match):
        FA.flash_attention_fwd(q, k, v, True)
    with pytest.raises(RuntimeError, match=match):
        FA.flash_attention_bwd_dq(q, k, v, g, lse, lse, True)
    with pytest.raises(RuntimeError, match=match):
        FA.flash_attention_bwd_dkv(q, k, v, g, lse, lse, True)
    with pytest.raises(RuntimeError, match=match):
        FB.fused_rmsnorm_qkv(x, w[0].contiguous(), w, w, w)
    assert n == [fn.launches for fn in wrappers]


# -- the Hopper redesigns: quant matmul split-K / wgmma, MLP and FFN GEMMs -----

# the quant matmul's bf16 limit (chip_smoke.py QUANT_MM_TOL): codes
# up-convert exactly, so kernel and plain version differ by the fp32
# summation order and one bf16 rounding
QUANT_MM_TOL = (2e-3, 2 ** -7)


@pytest.mark.parametrize("mode,n", [(3, 128), (3, 256), (4, 128), (4, 256)])
def test_wgmma_converted_8bit_b_matches_matmul(dev, mode, n):
    """The check's B tile converted by the threads from int8 (mode 3) or
    e4m3 (mode 4) bytes into TMA's swizzled MN-major layout (the quant
    matmul's prefill GEMM), behind the proxy fence, against torch.matmul
    of the up-converted values: products exact, fp32 sums in another
    order."""
    rng = np.random.default_rng(mode * 11 + n)
    a = _t(rng, (64, 64), torch.bfloat16, dev)
    if mode == 3:
        b = torch.as_tensor(rng.integers(-128, 128, (64, n)),
                            dtype=torch.int8).to(dev)
    else:
        b = _t(rng, (64, n), torch.float32, dev, 40.0).to(
            torch.float8_e4m3fn)
        b[0, :8] = torch.tensor([0.0, -0.0, 2 ** -9, -2 ** -7, 448.0,
                                 -448.0, 0.875 * 2 ** -6, 1.0])
    c = torch.empty((64, n), dtype=torch.float32, device=dev)
    lib = _build.library("fused_block")
    _build.check(lib, lib.ptt_wgmma_check(mode, a.data_ptr(), b.data_ptr(),
                                          c.data_ptr(), n,
                                          _build.stream_of(a)),
                 "ptt_wgmma_check")
    torch.cuda.synchronize()
    ref = a.float() @ b.float()
    np.testing.assert_allclose(c.cpu().numpy(), ref.cpu().numpy(),
                               atol=1e-4 * float(ref.abs().max()), rtol=1e-5)


# (T, K, N): the split-K classes (T <= 8 and <= 16; one 64-deep slice;
# splits capped by their slices; a partial 128-column tile; the decode
# step's k/v and down shapes) and the wgmma classes (a one-row-past-16
# chunk in the 64-row tile, one row past it in a 128-row tile, a partial
# last row tile, a partial column tile, the 256 x 128 tile with both
# partial, the 128 x 256 tile)
QUANT_HOPPER_SHAPES = [(1, 64, 64), (8, 64, 320), (16, 256, 192),
                       (8, 4096, 1024), (3, 14336, 4096), (12, 2048, 4160),
                       (17, 128, 320), (65, 256, 320), (150, 4096, 1024),
                       (256, 512, 192), (150, 256, 8640), (2048, 512, 8192)]


@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("T,K,N", QUANT_HOPPER_SHAPES)
def test_quant_matmul_hopper_matches_plain(dev, mode, T, K, N):
    """bf16: split-K at T <= 16, wgmma past 16, against
    quant_matmul_reference within QUANT_MM_TOL; the launch counted under
    its path."""
    rng = np.random.default_rng(T + K + 7 * N)
    x = _t(rng, (T, K), torch.bfloat16, dev)
    qw, scale = quantize_linear_weight(
        _t(rng, (K, N), torch.float32, dev, K ** -0.5), mode)
    path = QM.kernel_path(T, torch.bfloat16)
    assert path == ("splitk" if T <= 16 else "wgmma")
    n0 = dict(QM.quant_matmul.launches_by_path)
    got = QM.quant_matmul(x, qw, scale, mode=mode)
    n0[path] += 1
    assert QM.quant_matmul.launches_by_path == n0
    _close_tol(got, QM.quant_matmul_reference(x, qw, scale), QUANT_MM_TOL)


def test_quant_matmul_splitk_is_deterministic(dev):
    """The split partials are summed by the last block of each column
    tile in split order: two calls on the same inputs are bitwise equal,
    at several splits (q/o: 9, gate/up: 3, lm_head: 2)."""
    rng = np.random.default_rng(5)
    for K, N in ((4096, 4096), (4096, 14336), (4096, 128256)):
        x = _t(rng, (8, K), torch.bfloat16, dev)
        qw, scale = quantize_linear_weight(
            _t(rng, (K, N), torch.float32, dev, K ** -0.5), "int8")
        a = QM.quant_matmul(x, qw, scale)
        b = QM.quant_matmul(x, qw, scale)
        torch.cuda.synchronize()
        assert torch.equal(a, b)


def test_quant_splits_agree_with_the_model(dev):
    """The C entry's split count is the wrapper's model of the rule
    (splitk_splits at the card's SM count), and 0 where no workspace is
    taken (fp32, T > 16)."""
    lib = _build.library("quant_matmul")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for K, N in ((64, 64), (4096, 1024), (4096, 4096), (4096, 14336),
                 (14336, 4096), (4096, 128256), (2048, 4160)):
        assert lib.ptt_quant_splits(1, 8, K, N) == \
            SK.splitk_splits(K, N, sms), (K, N)
    assert lib.ptt_quant_splits(1, 17, 4096, 4096) == 0
    assert lib.ptt_quant_splits(0, 8, 4096, 4096) == 0


# (T, d, f): f = 320 and 1408 leave a partial last column tile in every
# tile width; T = 150 a partial last row tile; 8192 x 2048 x 1408 takes
# the 128 x 256 (gate/up 128 x 128 x 2) tiles in both launches
MLP_HOPPER_SHAPES = [(17, 256, 320), (150, 128, 192), (256, 512, 1408),
                     (8192, 2048, 1408)]


@pytest.mark.parametrize("T,d,f", MLP_HOPPER_SHAPES)
def test_mlp_hopper_matches_plain(dev, T, d, f):
    """bf16 at T > 16: gate/up (two B operands a slot) and the down
    product on the wgmma ring against mlp_reference; one launch counted
    a call, under ``wgmma``."""
    rng = np.random.default_rng(T + d + f)
    x = _t(rng, (T, d), torch.bfloat16, dev)
    wg = _t(rng, (d, f), torch.bfloat16, dev, d ** -0.5)
    wu = _t(rng, (d, f), torch.bfloat16, dev, d ** -0.5)
    wd = _t(rng, (f, d), torch.bfloat16, dev, f ** -0.5)
    n0 = dict(FB.fused_mlp.launches_by_path)
    got = FB.fused_mlp(x, wg, wu, wd)
    n0["wgmma"] += 1
    assert FB.fused_mlp.launches_by_path == n0
    _close(got, FB.mlp_reference(x, wg, wu, wd), torch.bfloat16)


@pytest.mark.parametrize("act", ["relu", "gelu", "silu"])
@pytest.mark.parametrize("T,d,f", MLP_HOPPER_SHAPES)
def test_fused_ffn_hopper_matches_plain(dev, act, T, d, f):
    """bf16 at T > 16: fused_ffn's up (bias and activation in the
    epilogue) and down (its bias) on the wgmma ring against
    ffn_reference; under ``wgmma``, and split-K below 17 rows."""
    rng = np.random.default_rng(T + d + f + len(act))
    x = _t(rng, (T, d), torch.bfloat16, dev)
    w1 = _t(rng, (d, f), torch.bfloat16, dev, d ** -0.5)
    w2 = _t(rng, (f, d), torch.bfloat16, dev, f ** -0.5)
    b1 = _t(rng, (f,), torch.bfloat16, dev, 0.5)
    b2 = _t(rng, (d,), torch.bfloat16, dev, 0.5)
    n0 = dict(FB.fused_ffn.launches_by_path)
    _close(FB.fused_ffn(x, w1, w2, b1, b2, act),
           FB.ffn_reference(x, w1, b1, w2, b2, act), torch.bfloat16)
    _close(FB.fused_ffn(x[:16], w1, w2, b1, b2, act),
           FB.ffn_reference(x[:16], w1, b1, w2, b2, act), torch.bfloat16)
    n0["wgmma"] += 1
    n0["splitk"] += 1
    assert FB.fused_ffn.launches_by_path == n0


# -- the block and the grouped FFN on the wgmma / TMA ring (bf16) -------------

# (b, s, d, heads, kv heads, f): DECODER_SHAPES, s = 64 (one q tile half
# past s, T under a 128-row tile) and dkv = 128 at GQA rep 4 (a 256-column
# tile half past k and v; f = 384 a partial 256-column down tile)
DECODER_HOPPER_SHAPES = DECODER_SHAPES + [(1, 64, 256, 2, 1, 256),
                                          (2, 128, 256, 4, 1, 384)]


@pytest.mark.parametrize("b,s,d,nh,nkvh,f", DECODER_HOPPER_SHAPES)
def test_decoder_block_hopper_matches_plain(dev, b, s, d, nh, nkvh, f):
    """bf16: the block on the ring, RoPE in the QKV epilogue and the
    wgmma flash forward, within DECODER_TOL of decoder_reference; three
    calls in a row bitwise equal (a workspace row read by TMA before its
    writer's stores were visible would differ now and then); each counted
    under ``wgmma``."""
    args = _decoder_args(np.random.default_rng(s + nh + f), b, s, d, nh,
                         nkvh, f, torch.bfloat16, dev)
    n0 = dict(FB.fused_decoder_block.launches_by_path)
    outs = [FB.fused_decoder_block(*args) for _ in range(3)]
    n0["wgmma"] += 3
    assert FB.fused_decoder_block.launches_by_path == n0
    for o in outs[1:]:
        assert torch.equal(o, outs[0])
    assert _rel_err(outs[0], FB.decoder_reference(*args)) < \
        DECODER_TOL[torch.bfloat16]


def test_decoder_block_fp32_keeps_the_first_design(dev):
    """fp32 launches the first design, counted under ``tile``."""
    args = _decoder_args(np.random.default_rng(2), 1, 128, 256, 2, 1, 256,
                         torch.float32, dev)
    n0 = dict(FB.fused_decoder_block.launches_by_path)
    got = FB.fused_decoder_block(*args)
    n0["tile"] += 1
    assert FB.fused_decoder_block.launches_by_path == n0
    assert _rel_err(got, FB.decoder_reference(*args)) < \
        DECODER_TOL[torch.float32]


# (G, E, C, d, h): GROUPED_SHAPES and C = 960 (a partial last 128-row tile)
# at rep 2
GROUPED_HOPPER_SHAPES = GROUPED_SHAPES + [(4, 2, 960, 128, 192)]


@pytest.mark.parametrize("G,E,C,d,h", GROUPED_HOPPER_SHAPES)
def test_grouped_ffn_hopper_matches_plain(dev, G, E, C, d, h):
    """bf16 on the ring, counts 0, C, partial and C - 1, a NaN in every
    unrouted row of x: the routed rows within TOL of the plain version
    on x without the NaN, rows past the counts exactly zero, every row
    finite; one launch under ``wgmma``, and fp32 under ``tile``."""
    rng = np.random.default_rng(G + C + d + h)
    x, w1, b1, w2, b2 = _grouped_inputs(rng, G, E, C, d, h, torch.bfloat16,
                                        dev)
    counts = _grouped_counts(G, C).to(dev)
    past = torch.arange(C, device=dev)[None, :] >= counts[:, None].long()
    xn = x.clone()
    xn[past] = float("nan")
    n0 = dict(GM.grouped_expert_ffn.launches_by_path)
    got = GM.grouped_expert_ffn(xn, w1, b1, w2, b2, counts=counts)
    n0["wgmma"] += 1
    assert GM.grouped_expert_ffn.launches_by_path == n0
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert not got[past].any()
    _close(got, GM.grouped_expert_ffn_reference(x, w1, b1, w2, b2,
                                                counts=counts),
           torch.bfloat16)
    GM.grouped_expert_ffn(*(t.float() for t in (x, w1, b1, w2, b2)),
                          counts=counts)
    n0["tile"] += 1
    assert GM.grouped_expert_ffn.launches_by_path == n0


# -- paged decode split across the sequence, QKV split-K, the CE in TF32 ------

# chip_smoke.py PAGED_TOL: one bf16 step of the output, and an absolute
# floor for the p that a split's running max rounds otherwise
PAGED_TOL = (4e-3, 2 ** -7)
# the serving shape: B = 8, 32 / 8 heads, head_dim 128, blocks of 16, a
# table of 64 blocks (8 splits of 128 tokens); lengths 1, one block, a
# split less one, a split, a split plus one, the whole table, an inactive
# row (table row 0, length 1) and a row in between
PAGED_LENGTHS = [1, 16, 127, 128, 129, 1024, 1, 700]


def _serve_paged(rng, dtype, dev, quant):
    B, h, kvh, hd, bs, mb = 8, 32, 8, 128, 16, 64
    nb = 1 + B * mb
    q = _t(rng, (B, h, hd), dtype, dev)
    kp = _t(rng, (nb, bs, kvh, hd), dtype, dev)
    vp = _t(rng, (nb, bs, kvh, hd), dtype, dev)
    scales = ()
    if quant:
        kp, ks = _quantize_kv(kp)
        vp, vs = _quantize_kv(vp)
        scales = (ks, vs)
    bt = torch.as_tensor(rng.permutation(nb - 1).reshape(B, mb) + 1,
                         dtype=torch.int32, device=dev)
    bt[6] = 0
    lengths = torch.as_tensor(PAGED_LENGTHS, dtype=torch.int32, device=dev)
    return q, kp, vp, bt, lengths, scales


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_decode_split_matches_plain(dev, dtype, quant):
    """fp and int8 pools at the serving shape, over lengths on both sides
    of a split: within TOL (fp32) or PAGED_TOL (bf16) of the plain
    version; two calls bitwise equal; each launch under ``split``."""
    q, kp, vp, bt, lengths, scales = _serve_paged(
        np.random.default_rng(11 + quant), dtype, dev, quant)
    fn = PA.paged_decode_attention_int8 if quant else \
        PA.paged_decode_attention
    n0 = dict(fn.launches_by_path)
    a = fn(q, kp, vp, bt, lengths, *scales)
    b = fn(q, kp, vp, bt, lengths, *scales)
    n0["split"] += 2
    assert fn.launches_by_path == n0
    assert PA.paged_splits(bt.shape[1], kp.shape[1]) == 8
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    ref = PA.paged_decode_reference(q, kp, vp, bt, lengths,
                                    k_scale=scales[0] if quant else None,
                                    v_scale=scales[1] if quant else None)
    if dtype == torch.bfloat16:
        _close_tol(a, ref, PAGED_TOL)
    else:
        _close(a, ref, dtype)


def test_paged_decode_splits_agree_with_the_model(dev):
    """The C entry's split count, which sizes the wrapper's workspace, is
    the tests' model of it (paged_splits), and a table that fits one
    split takes the ``direct`` design."""
    lib = _build.library("paged_attention")
    for mb, bs in ((1, 16), (8, 16), (9, 16), (64, 16), (12, 256), (7, 12)):
        assert lib.ptt_paged_splits(mb, bs) == PA.paged_splits(mb, bs)
    rng = np.random.default_rng(2)
    q = _t(rng, (2, 8, 64), torch.bfloat16, dev)
    kp = _t(rng, (9, 16, 2, 64), torch.bfloat16, dev)
    bt = torch.as_tensor([[1, 2], [3, 4]], dtype=torch.int32, device=dev)
    n0 = dict(PA.paged_decode_attention.launches_by_path)
    PA.paged_decode_attention(q, kp, kp, bt, torch.as_tensor(
        [5, 32], dtype=torch.int32, device=dev))
    n0["direct"] += 1
    assert PA.paged_decode_attention.launches_by_path == n0


# QKV split-K against qkv_reference: one bf16 step of the output (2^-7 of
# its value) plus an absolute floor for outputs near 0
QKV_SPLITK_TOL = (2e-3, 2 ** -7)


@pytest.mark.parametrize("T", [1, 8, 16])
def test_rmsnorm_qkv_splitk_matches_plain(dev, T):
    """bf16 at Llama-3-8B width (d 4096, dq 4096, dkv 1024; 6 splits on
    an H100): within QKV_SPLITK_TOL of qkv_reference, two calls bitwise
    equal, each under ``splitk``; the training variant and fp32 at the
    same T still launch the tile."""
    rng = np.random.default_rng(T + 5)
    d, dq, dkv = 4096, 4096, 1024
    x = _t(rng, (T, d), torch.bfloat16, dev)
    wn = _t(rng, (d,), torch.bfloat16, dev, 0.1) + 1.0
    w = [_t(rng, (d, n), torch.bfloat16, dev, (2 / (d + dq)) ** 0.5)
         for n in (dq, dkv, dkv)]
    n0 = dict(FB.fused_rmsnorm_qkv.launches_by_path)
    a = FB.fused_rmsnorm_qkv(x, wn, *w, 1e-5)
    b = FB.fused_rmsnorm_qkv(x, wn, *w, 1e-5)
    n0["splitk"] += 2
    assert FB.fused_rmsnorm_qkv.launches_by_path == n0
    torch.cuda.synchronize()
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    for g, r in zip(a, FB.qkv_reference(x, wn, *w, 1e-5)):
        _close_tol(g, r, QKV_SPLITK_TOL)
    FB.fused_rmsnorm_qkv(x, wn, *w, 1e-5, residuals=True)
    FB.fused_rmsnorm_qkv(x.float(), wn.float(), *(t.float() for t in w),
                         1e-5)
    n0["tile"] += 2
    assert FB.fused_rmsnorm_qkv.launches_by_path == n0


def test_qkv_splits_agree_with_the_model(dev):
    """The C entry's split count is the wrapper's model (qkv_splits at
    the card's SM count), and 0 where no workspace is taken (the
    training variant, fp32, T > 16)."""
    lib = _build.library("fused_block")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for d, dq, dkv in ((64, 64, 64), (256, 192, 64), (4096, 4096, 1024),
                       (2560, 2560, 512)):
        assert lib.ptt_qkv_splits(1, 8, d, dq, dkv, 0) == \
            FB.qkv_splits(d, dq, dkv, sms), (d, dq, dkv)
    assert lib.ptt_qkv_splits(1, 8, 4096, 4096, 1024, 1) == 0
    assert lib.ptt_qkv_splits(0, 8, 4096, 4096, 1024, 0) == 0
    assert lib.ptt_qkv_splits(1, 17, 4096, 4096, 1024, 0) == 0


# the chunked CE at "default" (TF32 chunk products) against "float32":
# chip_smoke.py CE_TF32_TOL, by the CE's io dtype
CE_TF32_TOL = {torch.bfloat16: {"loss_rel": 4e-6, "grad_of_max": 1e-2},
               torch.float32: {"loss_rel": 4e-6, "grad_of_max": 1.5e-3}}


@pytest.mark.parametrize("tf32_outside", [False, True])
def test_chunked_ce_default_precision_against_float32(dev, tf32_outside):
    """Llama-3-8B's lm-head width (d 4096, V 128256, chunks of 8192, the
    last one short), T = 512 bf16 rows: loss and gradients at the flag's
    default within CE_TF32_TOL of float32; the process's TF32 setting is
    the same before and after each call, whatever it was."""
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.nn import functional as TF
    rng = np.random.default_rng(8)
    T, d, V = 512, 4096, 128256
    h = _t(rng, (T, d), torch.bfloat16, dev)
    w = _t(rng, (d, V), torch.bfloat16, dev, 0.02)
    lbl = torch.as_tensor(rng.integers(0, V, T), device=dev)
    saved = flags.get("default_matmul_precision")
    torch.backends.cuda.matmul.allow_tf32 = tf32_outside
    out = {}
    try:
        for mode in ("float32", "default"):
            flags.set_flags({"default_matmul_precision": mode})
            hh = h.clone().requires_grad_(True)
            ww = w.clone().requires_grad_(True)
            loss = TF.fused_linear_cross_entropy(hh, ww, lbl)
            loss.backward()
            assert torch.backends.cuda.matmul.allow_tf32 == tf32_outside
            out[mode] = (float(loss.detach()), hh.grad.float(),
                         ww.grad.float())
    finally:
        flags.set_flags({"default_matmul_precision": saved})
        torch.backends.cuda.matmul.allow_tf32 = False
    (l32, *g32), (ltf, *gtf) = out["float32"], out["default"]
    tol = CE_TF32_TOL[torch.bfloat16]
    assert abs(ltf - l32) <= tol["loss_rel"] * abs(l32), (ltf, l32)
    for a, b in zip(gtf, g32):
        assert torch.isfinite(a).all()
        err, scale = float((a - b).abs().max()), float(b.abs().max())
        assert err <= tol["grad_of_max"] * scale, (err, scale)


# -- the MLP and fused_ffn at decode rows: split-K (bf16) ----------------------

# one bf16 step of the output (2^-7 of its value) plus an absolute floor
# for outputs near 0: both sides round the same fp32 sums once, h included
MLP_SPLITK_TOL = (2e-3, 2 ** -7)
# (d, f): f = 320 leaves a partial 256-column tile in gate/up (a strip
# past f streams nothing) and d = 320 one in the down product; Llama-3-8B
# width (56 x 2 and 16 x 8 blocks on an H100)
MLP_SPLITK_SHAPES = [(256, 320), (320, 192), (4096, 14336)]


@pytest.mark.parametrize("T", [1, 8, 16])
@pytest.mark.parametrize("d,f", MLP_SPLITK_SHAPES)
def test_mlp_splitk_matches_plain(dev, T, d, f):
    """bf16 at T <= 16: gate/up and the down product split-K, within
    MLP_SPLITK_TOL of mlp_reference, two calls bitwise equal, each call
    one launch under ``splitk``; fp32 at the same T keeps the tile."""
    rng = np.random.default_rng(T + d + f)
    s = (2 / (d + f)) ** 0.5
    x = _t(rng, (T, d), torch.bfloat16, dev)
    wg, wu = (_t(rng, (d, f), torch.bfloat16, dev, s) for _ in range(2))
    wd = _t(rng, (f, d), torch.bfloat16, dev, s)
    n0 = dict(FB.fused_mlp.launches_by_path)
    a = FB.fused_mlp(x, wg, wu, wd)
    b = FB.fused_mlp(x, wg, wu, wd)
    n0["splitk"] += 2
    assert FB.fused_mlp.launches_by_path == n0
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    _close_tol(a, FB.mlp_reference(x, wg, wu, wd), MLP_SPLITK_TOL)
    if d <= 320:
        xf, gf, uf, df = (t.float() for t in (x, wg, wu, wd))
        _close(FB.fused_mlp(xf, gf, uf, df), FB.mlp_reference(xf, gf, uf, df),
               torch.float32)
        n0["tile"] += 1
        assert FB.fused_mlp.launches_by_path == n0


@pytest.mark.parametrize("act", ["relu", "gelu", "silu"])
@pytest.mark.parametrize("T", [1, 8, 16])
@pytest.mark.parametrize("d,f", [(320, 192), (512, 2048)])
def test_fused_ffn_splitk_matches_plain(dev, act, T, d, f):
    """bf16 at T <= 16 with both biases: the activation on the merged
    sums of the up product, b2 on the down product's, within
    MLP_SPLITK_TOL of ffn_reference, two calls bitwise equal, under
    ``splitk``; without biases the same against zeros."""
    rng = np.random.default_rng(T + d + len(act))
    x = _t(rng, (T, d), torch.bfloat16, dev)
    w1 = _t(rng, (d, f), torch.bfloat16, dev, d ** -0.5)
    w2 = _t(rng, (f, d), torch.bfloat16, dev, f ** -0.5)
    b1 = _t(rng, (f,), torch.bfloat16, dev, 0.5)
    b2 = _t(rng, (d,), torch.bfloat16, dev, 0.5)
    n0 = dict(FB.fused_ffn.launches_by_path)
    a = FB.fused_ffn(x, w1, w2, b1, b2, act)
    b = FB.fused_ffn(x, w1, w2, b1, b2, act)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    _close_tol(a, FB.ffn_reference(x, w1, b1, w2, b2, act), MLP_SPLITK_TOL)
    zero1 = torch.zeros_like(b1)
    zero2 = torch.zeros_like(b2)
    _close_tol(FB.fused_ffn(x, w1, w2, activation=act),
               FB.ffn_reference(x, w1, zero1, w2, zero2, act),
               MLP_SPLITK_TOL)
    n0["splitk"] += 3
    assert FB.fused_ffn.launches_by_path == n0


@pytest.mark.parametrize("T,d,f", [(8, 256, 320), (16, 4096, 14336)])
def test_mlp_splits_agree_with_the_model(dev, T, d, f):
    """The C entry refuses a workspace one value smaller than
    ``mlp_workspace`` (splitk.py's mlp_splits at the card's SM count) with
    CUDA error 1 and no launch, and takes one of its size: its own split
    counts need exactly the model's workspace."""
    lib = _build.library("fused_block")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rng = np.random.default_rng(4)
    x = _t(rng, (T, d), torch.bfloat16, dev)
    wg, wu = (_t(rng, (d, f), torch.bfloat16, dev, d ** -0.5)
              for _ in range(2))
    wd = _t(rng, (f, d), torch.bfloat16, dev, f ** -0.5)
    floats, tiles = FB.mlp_workspace(T, d, f, True, sms)
    h = torch.empty((T, f), dtype=torch.bfloat16, device=dev)
    ws = torch.empty(floats, dtype=torch.float32, device=dev)
    tickets = torch.zeros(tiles, dtype=torch.int32, device=dev)
    for n, want in ((floats - 1, 1), (floats, 0)):
        y = torch.zeros((T, d), dtype=torch.bfloat16, device=dev)
        design = ctypes.c_int(-1)
        err = lib.ptt_mlp(1, 0, x.data_ptr(), wg.data_ptr(), wu.data_ptr(),
                          wd.data_ptr(), None, None, h.data_ptr(),
                          y.data_ptr(), ws.data_ptr(), n, tickets.data_ptr(),
                          T, d, f, _build.stream_of(x), ctypes.byref(design))
        assert err == want
        if want == 0:
            assert FB.GEMM_PATHS[design.value] == "splitk"
            _close_tol(y, FB.mlp_reference(x, wg, wu, wd), MLP_SPLITK_TOL)
            assert not tickets.any()


# rmsnorm's register design: a row of eight warps (d = 4096 bf16, two
# vectors a thread; fp32 four), four vectors a thread (d = 8192 bf16), one
# warp (d = 512), and past the registers (d = 16384) the two-pass design
NORM_REG_SHAPES = [(8192, 4096), (7, 8192), (9, 512), (3, 16384), (1, 64)]


@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,d", NORM_REG_SHAPES)
def test_rmsnorm_register_design(dev, dtype, residual, rows, d):
    """y within one bf16 step (1e-5 in fp32) and inv within 1e-5 of
    rmsnorm_reference; with a residual h equals the plain sum, without
    one h is x itself (its storage; nothing writes it)."""
    rng = np.random.default_rng(rows + d)
    x = _t(rng, (rows, d), dtype, dev)
    r = _t(rng, (rows, d), dtype, dev) if residual else None
    w = _t(rng, (d,), dtype, dev, 0.1) + 1.0
    keep = x.clone()
    y, h, inv = RN.fused_rmsnorm(x, w, r, 1e-5)
    ry, rh, rinv = RN.rmsnorm_reference(x, w, r, 1e-5)
    torch.cuda.synchronize()
    assert torch.equal(h, rh) and torch.equal(x, keep)
    assert (h.data_ptr() == x.data_ptr()) == (not residual)
    np.testing.assert_allclose(inv.cpu().numpy(), rinv.cpu().numpy(),
                               rtol=1e-5)
    tol = 1e-5 if dtype == torch.float32 else 2 ** -7
    np.testing.assert_allclose(y.float().cpu().numpy(),
                               ry.float().cpu().numpy(), rtol=tol, atol=1e-6)


def test_rms_norm_residual_without_a_residual_on_the_card(dev):
    """F.rms_norm_residual with no residual (h is x) forward and backward
    on the card against the CPU port, fp32, 1e-5: the gradient of x gets
    the cotangents of both y and h once."""
    from paddle_tpu_torch.nn import functional as F
    rng = np.random.default_rng(23)
    host = [torch.as_tensor(rng.standard_normal(s), dtype=torch.float32)
            for s in ((4, 33, 512), (512,))]
    gy, gh = (torch.as_tensor(rng.standard_normal((4, 33, 512)),
                              dtype=torch.float32) for _ in range(2))
    out = []
    for where in ("cpu", dev):
        leaves = [t.clone().to(where).requires_grad_(True) for t in host]
        y, h = F.rms_norm_residual(leaves[0], leaves[1], None, 1e-5)
        assert h.data_ptr() == leaves[0].data_ptr()
        torch.autograd.backward((y, h), (gy.to(where), gh.to(where)))
        out.append([y.detach().cpu(), h.detach().cpu()] +
                   [t.grad.cpu() for t in leaves])
    for got, ref in zip(out[1], out[0]):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5,
                                   atol=1e-5)


# -- the optimizer step: the multi-tensor kernels and the CUDA graph ----------

def _mixed_set(rng, dev):
    """A parameter set of every kind the update takes: fp32; bf16 with an
    fp32 master; bf16 without (its gradient bf16, or fp32 as accumulation
    gives it); one tensor spanning several 2^16-element chunks; an empty
    one.  ``(params, grads, masters)``."""
    specs = [((300, 257), torch.float32, torch.float32, False),
             (((1 << 18) + 77,), torch.bfloat16, torch.bfloat16, True),
             ((33, 65), torch.bfloat16, torch.bfloat16, False),
             ((513,), torch.bfloat16, torch.float32, False),
             ((0,), torch.float32, torch.float32, False)]
    params, grads, masters = [], [], []
    for shape, pdt, gdt, master in specs:
        p = _t(rng, shape, pdt, dev)
        params.append(p)
        grads.append(_t(rng, shape, gdt, dev, 0.1))
        masters.append(p.float() + 1e-3 if master else None)
    return params, grads, masters


def test_multi_tensor_chunk_matches_the_library(dev):
    from paddle_tpu_torch.ops.kernels import multi_tensor as MT
    assert _build.library("multi_tensor").ptt_mt_chunk() == MT.CHUNK


def test_multi_tensor_norm_matches_plain(dev):
    """The global norm over the mixed set against its plain version (fp32
    sums in another order: 1e-6 relative), one launch a call, and two
    launches bitwise equal (partials summed in a fixed order)."""
    from paddle_tpu_torch.ops.kernels import multi_tensor as MT
    _, grads, _ = _mixed_set(np.random.default_rng(31), dev)
    n0 = MT.multi_tensor_norm.launches
    got = MT.multi_tensor_norm(grads)
    again = MT.multi_tensor_norm(grads)
    assert MT.multi_tensor_norm.launches == n0 + 2
    ref = MT.norm_reference(grads)
    torch.cuda.synchronize()
    assert got.shape == () and got.dtype == torch.float32
    assert torch.equal(got, again)
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)
    assert float(MT.multi_tensor_norm(grads[-1:])) == 0.0
    nan = [g.clone() for g in grads]
    nan[2].view(-1)[5] = float("nan")
    assert not torch.isfinite(MT.multi_tensor_norm(nan))


def test_multi_tensor_digest_matches_plain_bitwise(dev, monkeypatch):
    """The digest over uneven leaves of every element size (fp32, bf16,
    fp16, int8, uint8 from bool, fp8, int32; sizes off the chunk and the
    16-byte vector, an empty leaf, a leaf not 16-byte aligned) against
    its plain version on the same card: bitwise (integer sums), one
    launch a call, at the default chunk and at a small one (the chunk
    size is the kernel's argument), and params_digest's integer equal to
    the CPU's."""
    from paddle_tpu_torch.ops.kernels import multi_tensor as MT
    from paddle_tpu_torch.robustness import recovery as rec
    g = torch.Generator(device="cpu").manual_seed(41)
    big = torch.randn(1 << 18 | 7, generator=g)
    leaves = [big.to(dev), big[:70001].to(dev, torch.bfloat16),
              torch.randn(333, generator=g).half().to(dev),
              torch.randint(-128, 128, (5000,), generator=g,
                            dtype=torch.int8).to(dev),
              (torch.rand(77, generator=g) > 0.5).to(dev).view(torch.uint8),
              torch.randn(4096, generator=g).to(dev, torch.float8_e4m3fn
                                                ).view(torch.uint8),
              torch.zeros(0, device=dev),
              torch.randint(-2 ** 31, 2 ** 31 - 1, (9999,), generator=g,
                            dtype=torch.int32).to(dev),
              big.to(dev)[1:1001]]              # 4 bytes off alignment
    n0 = MT.multi_tensor_digest.launches
    got = MT.multi_tensor_digest(leaves)
    again = MT.multi_tensor_digest(leaves)
    assert MT.multi_tensor_digest.launches == n0 + 2
    ref = MT.digest_reference(leaves)
    torch.cuda.synchronize()
    assert torch.equal(got, ref) and torch.equal(got, again)
    cpu = MT.digest_reference([t.cpu() for t in leaves])
    assert torch.equal(got.cpu(), cpu)
    tree = {"w": leaves[0], "h": leaves[1], "q": leaves[3]}
    assert rec.params_digest(tree) == rec.params_digest(
        {k: v.cpu() for k, v in tree.items()})
    monkeypatch.setattr(MT, "DIGEST_CHUNK_BYTES", 4096)
    n1 = MT.multi_tensor_digest.launches
    assert torch.equal(MT.multi_tensor_digest(leaves), ref)
    assert MT.multi_tensor_digest.launches == n1 + 1


def test_params_digest_with_host_leaves_runs_on_the_card(dev):
    """A tree of card tensors with host leaves beside them (a Python
    int, a float, a numpy array: what ``SDCSentinel.publish(...,
    extra=...)`` digests) is digested by one launch on the card, and its
    integer equals the CPU path's."""
    from paddle_tpu_torch.ops.kernels import multi_tensor as MT
    from paddle_tpu_torch.robustness import recovery as rec
    g = torch.Generator(device="cpu").manual_seed(43)
    params = {"w": torch.randn(3000, generator=g).to(dev, torch.bfloat16),
              "b": torch.randn(17, generator=g).to(dev)}
    tree = (params, {"step": 12, "lr": 0.5,
                     "ids": np.arange(5, dtype=np.int64)})
    host = ({k: v.cpu() for k, v in params.items()}, tree[1])
    n0 = MT.multi_tensor_digest.launches
    got = rec.params_digest(tree)
    assert MT.multi_tensor_digest.launches == n0 + 1
    assert got == rec.params_digest(host)


def test_load_bundle_into_an_empty_cache_runs_no_nvcc(dev, tmp_path,
                                                      monkeypatch):
    """A bundle built here, loaded into an empty cache by a process
    whose build/ is empty: the libraries come from the bundle (no nvcc
    run), the entry hits (no counted warm-up) and the program's result
    equals the first capture's."""
    from paddle_tpu_torch import compile_cache as CC
    monkeypatch.setenv("PADDLE_TPU_COMPILE_CACHE", "1")
    monkeypatch.setenv("PADDLE_TPU_COMPILE_CACHE_DIR", str(tmp_path / "a"))
    CC.reset_memory()
    _build.build_all()                 # stores every library in a/
    x = torch.randn(64, 512, device=dev, dtype=torch.bfloat16)
    w = torch.randn(512, device=dev, dtype=torch.bfloat16)
    g, info, hit = CC.aot_compile_cached(RN.fused_rmsnorm, x, w,
                                         target="norm")
    assert not hit and info.launches == {"fused_rmsnorm": 1}
    first = g()[0].clone()
    CC.bundle(str(tmp_path / "bundle"), state_dict={"x": x})
    monkeypatch.setenv("PADDLE_TPU_COMPILE_CACHE_DIR", str(tmp_path / "b"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_libs", {})
    CC.reset_memory()
    out = CC.load_bundle(str(tmp_path / "bundle"), device=dev)
    assert out["installed"] == ["norm"] and out["skipped"] == 0
    assert torch.equal(out["state_dict"]["x"], x)
    runs = _build.nvcc_runs()
    g2, info2, hit2 = CC.aot_compile_cached(RN.fused_rmsnorm, x, w,
                                            target="norm")
    assert hit2 and info2.cached and _build.nvcc_runs() == runs
    assert torch.equal(g2()[0], first)


@pytest.mark.parametrize("decoupled", [False, True])
@pytest.mark.parametrize("clip", [False, True])
@pytest.mark.parametrize("keep", [None, True, False])
def test_multi_tensor_adam_matches_plain(dev, decoupled, clip, keep):
    """One launch of the Adam / AdamW update over the mixed set, two
    updates, against its plain version on the same card (the same
    operations in the same order, fp32, the bias corrections from the
    same powf): every parameter, moment and master bitwise equal; with
    keep False nothing is written."""
    from paddle_tpu_torch.ops.kernels import multi_tensor as MT
    params, grads, masters = _mixed_set(np.random.default_rng(32), dev)
    sets = []
    for _ in range(2):
        sets.append(([p.clone() for p in params],
                     [torch.rand(p.shape, device=dev) * 0.01
                      for p in params],
                     [torch.rand(p.shape, device=dev) * 1e-4
                      for p in params],
                     [None if m is None else m.clone() for m in masters]))
    for a, b in zip(sets[0][1] + sets[0][2], sets[1][1] + sets[1][2]):
        b.copy_(a)
    first = [t.clone() for t in sets[0][0] + sets[0][1] + sets[0][2]]
    scale = torch.tensor(0.6, device=dev) if clip else None
    keep_t = None if keep is None else torch.tensor(keep, device=dev)
    n0 = MT.multi_tensor_adam.launches
    for step in (1, 2):
        for i, (ps, ms, vs, mast) in enumerate(sets):
            fn = MT.multi_tensor_adam if i == 0 else _plain_adam
            fn(ps, grads, ms, vs, mast, lr=torch.tensor(1e-2, device=dev),
               step=torch.tensor(step, dtype=torch.int32, device=dev),
               beta1=0.9, beta2=0.95, epsilon=1e-8,
               weight_decays=[0.1, 0.0, 0.05, 0.1, 0.1], decoupled=decoupled,
               multi_precision=True, scale=scale, keep=keep_t)
    assert MT.multi_tensor_adam.launches == n0 + 2
    torch.cuda.synchronize()
    kernel, plain = sets
    for a, b in zip(kernel[0] + kernel[1] + kernel[2],
                    plain[0] + plain[1] + plain[2]):
        assert torch.equal(a, b)
    for a, b in zip(kernel[3], plain[3]):
        assert (a is None and b is None) or torch.equal(a, b)
    changed = [not torch.equal(a, b) for a, b in zip(
        kernel[0] + kernel[1] + kernel[2], first) if a.numel()]
    assert not any(changed) if keep is False else all(changed)


def _plain_adam(params, grads, m, v, masters, **kw):
    """multi_tensor_adam's plain version on CUDA tensors."""
    from paddle_tpu_torch.ops.kernels import multi_tensor as MT
    wds = kw.pop("weight_decays")
    for p, g, mm, vv, ms, wd in zip(params, grads, m, v, masters, wds):
        MT.adam_reference(p, g, mm, vv, ms, weight_decay=wd, **kw)


def test_multi_tensor_kernels_refuse_what_they_do_not_take(dev):
    from paddle_tpu_torch.ops.kernels import multi_tensor as MT
    half = torch.zeros(8, dtype=torch.float16, device=dev)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        MT.multi_tensor_norm([half])
    strided = torch.zeros(8, 8, device=dev).t()
    with pytest.raises(ValueError, match="contiguous"):
        MT.multi_tensor_norm([strided])
    p = torch.zeros(8, device=dev)
    with pytest.raises(TypeError, match="masters"):
        MT.multi_tensor_adam([p], [p.clone()], [p.clone()], [p.clone()],
                             [p.clone()], lr=1e-3, step=1)


def _graph_model(dev, dtype="float32", seed_=0):
    from paddle_tpu_torch import seed
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    cfg = LlamaConfig.tiny(hidden_size=256, intermediate_size=512,
                           num_attention_heads=2, num_key_value_heads=1,
                           max_position_embeddings=256, dtype=dtype)
    seed(seed_)
    return cfg, LlamaForCausalLM(cfg, device=dev)


def _graph_step(model):
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.optimizer import lr
    sched = lr.LinearWarmup(lr.CosineAnnealingDecay(1e-3, T_max=10),
                            warmup_steps=2, start_lr=1e-4, end_lr=1e-3)
    return TrainStep(model, AdamW(learning_rate=sched, multi_precision=True,
                                  grad_clip=ClipGradByGlobalNorm(1.0)))


def _ids(cfg, seed_, b=2, s=128):
    ids = np.random.default_rng(seed_).integers(0, cfg.vocab_size,
                                                (b, s + 1))
    return {"input_ids": ids[:, :-1], "labels": ids[:, 1:]}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_step_graph_replays_the_eager_step(dev, dtype):
    """A small model's step captured as one CUDA graph and replayed three
    times against three eager steps of a copy from the same weights
    (schedule, clip, masters): the same kernels in the same order, so
    losses and parameters within fp32 rounding of each other (1e-6
    relative; in practice equal); the graph holds every kernel once a
    step, the wrappers' counters do not move under replay, and the
    skip-code read is the only host wait."""
    from paddle_tpu_torch.ops import kernels
    cfg, model = _graph_model(dev, dtype)
    _, ref_model = _graph_model(dev, dtype)
    step, ref = _graph_step(model), _graph_step(ref_model)
    info = step.compile(_ids(cfg, 0))
    assert info.graph
    want = {fn.__name__ for fn in kernels.TRAINING + kernels.MULTI_TENSOR}
    assert want <= set(info.launches)
    assert info.launches["multi_tensor_adam"] == 1
    assert info.launches["multi_tensor_norm"] == 1
    for i in range(3):
        batch = _ids(cfg, 10 + i)
        kernels.reset_launch_counts()
        got = step(batch)
        assert all(fn.launches == 0 for fn in kernels.KERNELS)
        exp = ref(batch)
        np.testing.assert_allclose(float(got), float(exp), rtol=1e-6)
    assert step.replays == 3 and step.step_count == ref.step_count == 3
    for n, p in ref.params.items():
        np.testing.assert_allclose(step.params[n].float().cpu().numpy(),
                                   p.float().cpu().numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=n)


def test_train_step_graph_skips_a_nonfinite_step(dev):
    """A NaN in a weight inside the captured graph: skip code 1, the
    skip counted, parameters, moments, masters and the device count
    bitwise as they were."""
    cfg, model = _graph_model(dev, "bfloat16")
    step = _graph_step(model)
    batch = _ids(cfg, 1)
    step.compile(batch)
    step(batch)
    with torch.no_grad():
        model.model.norm.weight[7] = float("nan")
    opt = step.optimizer
    before = [t.clone() for _, p in step._named for t in
              [p.detach()] + list(opt._accumulators[id(p)].values())]
    count = step._count.clone()
    loss = step(batch)
    assert not torch.isfinite(loss) and step.replays == 2
    assert step.skipped["nonfinite_loss"] == 1 and step.step_count == 1
    after = [t for _, p in step._named for t in
             [p.detach()] + list(opt._accumulators[id(p)].values())]
    for a, b in zip(after, before):
        assert torch.equal(a.view(torch.uint8) if a.dtype != torch.bfloat16
                           else a.view(torch.int16),
                           b.view(torch.uint8) if b.dtype != torch.bfloat16
                           else b.view(torch.int16))
    assert torch.equal(step._count, count)


def test_train_step_graph_keeps_its_workspaces(dev):
    """After compile(), an eager norm over more tensors than the step's
    grows the norm's cached workspace: the graph keeps the buffer it
    captured, so its replays write into no tensor allocated since and
    stay equal to the eager step."""
    from paddle_tpu_torch.ops.kernels import multi_tensor as MT
    cfg, model = _graph_model(dev)
    _, ref_model = _graph_model(dev)
    step, ref = _graph_step(model), _graph_step(ref_model)
    step.compile(_ids(cfg, 0))
    key = next(k for k in _build._workspaces if k[0] == "multi_tensor_norm")
    captured = _build._workspaces[key]
    assert any(t is captured for t in step._graph_tables)
    # a chunk and a tensor partial each: 8 bytes a tensor
    ones = torch.ones(captured.numel() // 8 + 1, device=dev)
    many = [ones[i:i + 1] for i in range(ones.numel())]
    assert float(MT.multi_tensor_norm(many)) == \
        pytest.approx(ones.numel() ** 0.5)
    assert _build._workspaces[key] is not captured
    # blocks of the captured buffer's size, where a freed one would land
    fill = [torch.full((captured.numel() // 4,), 7.0, device=dev)
            for _ in range(16)]
    for i in range(3):
        batch = _ids(cfg, 10 + i)
        got, exp = step(batch), ref(batch)
        np.testing.assert_allclose(float(got), float(exp), rtol=1e-6)
    assert all(bool((f == 7.0).all()) for f in fill)
    for n, p in ref.params.items():
        np.testing.assert_allclose(step.params[n].float().cpu().numpy(),
                                   p.float().cpu().numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=n)


def test_compile_raises_when_the_capture_fails(dev):
    """A loss that reads a value on the host cannot be captured: compile
    raises, and nothing runs the body eagerly in its place."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.optimizer import AdamW
    cfg, model = _graph_model(dev)

    def host_read(logits, labels):
        scale = float(logits.detach().abs().max() > 0)   # waits for the card
        return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               labels.reshape(-1)) * scale
    step = TrainStep(model, AdamW(learning_rate=1e-3), loss_fn=host_read)
    b = _ids(cfg, 2)
    with pytest.raises(RuntimeError):
        step.compile((b["input_ids"], b["labels"]))
    assert step._graph is None and step.step_count == 0


def test_device_prefetch_on_the_card(dev):
    """Batches land on the card in order, through pinned memory and a side
    stream that the consumer's stream waits on."""
    from paddle_tpu_torch.io import device_prefetch
    src = [{"ids": np.full((4, 1024), i, dtype=np.int64)} for i in range(6)]
    with device_prefetch(src, depth=2, device=dev) as it:
        out = [b["ids"].sum() for b in it]
    assert [int(x) for x in out] == [4096 * i for i in range(6)]


def _moe_model(dev, mode):
    from paddle_tpu_torch import seed
    from paddle_tpu_torch.models import ErnieForCausalLM, ernie45_moe_config
    cfg = ernie45_moe_config(
        vocab_size=256, hidden_size=256, intermediate_size=256,
        moe_intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=2, num_key_value_heads=1, num_experts=4,
        num_experts_per_tok=2, num_shared_experts=1,
        max_position_embeddings=256, dtype="bfloat16", dispatch_mode=mode)
    seed(0)
    return cfg, ErnieForCausalLM(cfg, device=dev)


@pytest.mark.parametrize("kind", ["moe_einsum", "moe_index", "decoder"])
def test_train_step_graph_captures_moe_and_the_decoder_tier(dev, kind,
                                                             monkeypatch):
    """The MoE step (both dispatch modes: the capacity comes from shapes
    alone) and the decoder tier's step (the block's cooperative launch)
    captured as one graph each: two replays against two eager steps of a
    copy from the same weights, bf16, losses within 1e-6 relative (the
    same kernels in the same order)."""
    if kind == "decoder":
        monkeypatch.setenv("PADDLE_TPU_FUSED_BLOCK", "decoder")
        make = lambda: _graph_model(dev, "bfloat16")
    else:
        make = lambda: _moe_model(dev, kind.split("_")[1])
    cfg, model = make()
    _, ref_model = make()
    step, ref = _graph_step(model), _graph_step(ref_model)
    info = step.compile(_ids(cfg, 0))
    assert info.graph and info.launches
    if kind == "decoder":
        assert info.launches["fused_decoder_block"] == 2
    else:
        assert info.launches["grouped_expert_ffn"] == 1
    for i in range(2):
        batch = _ids(cfg, 20 + i)
        got, exp = step(batch), ref(batch)
        assert torch.isfinite(got)
        np.testing.assert_allclose(float(got), float(exp), rtol=1e-6)
    assert step.replays == 2


# -- the serving engine's programs as CUDA graphs ------------------------------

GRAPH_ENGINE = dict(slots=4, max_len=256, prefill_buckets=(32, 64, 128),
                    kv_block_size=16, prefill_chunk=64)
GRAPH_PROMPTS = (5, 40, 100, 17, 70)


def _serve_graph(model, warm, prompts=GRAPH_PROMPTS, max_new=12, **kw):
    """Serve `prompts` (lengths) on a fresh engine, warmed or eager;
    returns (engine, tokens of each request)."""
    from paddle_tpu_torch.inference import ContinuousBatchingEngine
    eng = ContinuousBatchingEngine(model, **dict(GRAPH_ENGINE, **kw))
    if warm:
        eng.warm_stats = eng.aot_warmup()
    rng = np.random.default_rng(7)
    rids = [eng.add_request(rng.integers(0, 256, n), max_new_tokens=max_new)
            for n in prompts]
    out = eng.run()
    assert all(eng.request_status(r) == "ok" for r in rids)
    return eng, [out[r][1] for r in rids]


def _caches_of(eng):
    if eng.paged:
        return eng._pool.kpools + eng._pool.vpools + eng._pool.kscales + \
            eng._pool.vscales
    return [t for c in eng._caches for t in c]


@pytest.mark.parametrize("engine,K,quant", [
    ("paged", 1, {}), ("paged", 4, {}),
    ("paged", 1, {"quant_weights": "int8", "quant_kv": "int8"}),
    ("paged", 1, {"quant_weights": "fp8"}), ("slot", 1, {}),
    ("slot", 3, {})])
def test_graphed_decode_equals_eager_bitwise(dev, engine, K, quant):
    """The same bf16 weights and prompts served eagerly and after
    aot_warmup (decode replayed as a CUDA graph): the same kernels in the
    same order, so the tokens and every cache are bitwise equal; one
    replay launches each decode kernel once a layer a step, and the
    wrappers' counters do not move under replay."""
    from paddle_tpu_torch.ops import kernels
    cfg, model = _graph_model(dev, "bfloat16")
    kw = dict(quant, steps_per_sync=K, paged_kv=engine == "paged")
    eager, ref = _serve_graph(model, False, **kw)
    ref_caches = [t.clone() for t in _caches_of(eager)]
    eager.close()
    kernels.reset_launch_counts()
    warm, got = _serve_graph(model, True, **kw)
    assert got == ref
    # every block but the paged pools' scratch block 0, which the
    # warm-ups write and no query reads
    skip = 1 if engine == "paged" else 0
    for a, b in zip(_caches_of(warm), ref_caches):
        assert torch.equal(a[skip:], b[skip:])
    stats = warm.warm_stats["serving.decode"]
    assert stats["graph"] and warm._graphs["serving.decode"].replays > 0
    L = cfg.num_hidden_layers
    if engine == "paged":
        paged = "paged_decode_attention_int8" if quant.get("quant_kv") \
            else "paged_decode_attention"
        assert stats["launches"][paged] == L * K
        if not quant:
            assert stats["launches"]["fused_mlp"] == L * K
    # counted: the warm-up, the capture and the eager prefills only
    if not quant and engine == "paged":
        assert PA.paged_decode_attention.launches == 2 * L * K
        assert PA.paged_decode_attention.launches_by_path["direct"] == 0
    warm.close()
    assert not warm._graphs


def test_graphed_decode_survives_a_workspace_grown_by_a_prefill(dev):
    """A one-layer model at Llama-3-8B's hidden width, captured at 8
    decode rows (the QKV row pass's workspace is then its 64 KiB
    minimum); an eager 16-row forward after the capture (split-K at 16
    rows) grows it: the graphs keep the buffer they captured, so their
    replays write into no tensor allocated since, and the tokens equal
    the eager engine's."""
    from paddle_tpu_torch import seed
    from paddle_tpu_torch.inference import ContinuousBatchingEngine
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    cfg = LlamaConfig.tiny(hidden_size=4096, intermediate_size=1024,
                           num_attention_heads=32, num_key_value_heads=8,
                           num_hidden_layers=1, max_position_embeddings=256,
                           dtype="bfloat16")
    seed(0)
    model = LlamaForCausalLM(cfg, device=dev)
    prompts, kw = (5, 16, 9), dict(slots=8, paged_kv=True)
    _, ref = _serve_graph(model, False, prompts=prompts, **kw)
    for k in [k for k in _build._workspaces
              if k[0].startswith(("fused_rmsnorm_qkv", "fused_mlp"))]:
        del _build._workspaces[k]          # fresh, at the capture's size
    eng = ContinuousBatchingEngine(model, **dict(GRAPH_ENGINE, **kw))
    eng.aot_warmup()
    key = next(k for k in _build._workspaces
               if k[0] == "fused_rmsnorm_qkv.xn")
    captured = _build._workspaces[key]
    assert any(t is captured for t in eng._graphs["serving.decode"].held)
    with torch.inference_mode():
        model(torch.randint(0, 256, (1, 16), device=dev))
    rng = np.random.default_rng(7)
    rids = [eng.add_request(rng.integers(0, 256, n), max_new_tokens=12)
            for n in prompts]
    out = eng.run()
    assert _build._workspaces[key] is not captured       # it grew
    assert [out[r][1] for r in rids] == ref


def test_recovered_graphed_engine_matches_eager(dev, monkeypatch):
    """A warmed paged engine whose decode fails on the host after the
    graph wrote the pools: the batch retires "error", the pools are
    zeroed in place, and the same graph then serves the eager engine's
    tokens."""
    cfg, model = _graph_model(dev, "bfloat16")
    _, ref = _serve_graph(model, False, paged_kv=True)
    from paddle_tpu_torch.inference import ContinuousBatchingEngine
    eng = ContinuousBatchingEngine(model, **dict(GRAPH_ENGINE,
                                                 paged_kv=True))
    eng.aot_warmup()
    real, calls = eng._account_decode, []

    def fail_once(*args):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("injected")
        return real(*args)
    monkeypatch.setattr(eng, "_account_decode", fail_once)
    rng = np.random.default_rng(3)
    bad = [eng.add_request(rng.integers(0, 256, n), max_new_tokens=4)
           for n in (30, 8)]
    eng.run()
    assert all(eng.request_status(r) == "error" for r in bad)
    rng = np.random.default_rng(7)
    rids = [eng.add_request(rng.integers(0, 256, n), max_new_tokens=12)
            for n in GRAPH_PROMPTS]
    out = eng.run()
    assert [out[r][1] for r in rids] == ref


def test_close_drops_the_graphs_before_restoring_the_linears(dev,
                                                             monkeypatch):
    from paddle_tpu_torch.inference import serving
    from paddle_tpu_torch.quantization import QuantedLinear
    cfg, model = _graph_model(dev, "bfloat16")
    eng, _ = _serve_graph(model, True, quant_weights="int8", paged_kv=True)
    assert isinstance(model.lm_head, QuantedLinear)
    real, seen = serving.restore_from_serving, []

    def restore(m):
        seen.append(dict(eng._graphs))
        return real(m)
    monkeypatch.setattr(serving, "restore_from_serving", restore)
    eng.close()
    assert seen == [{}] and not isinstance(model.lm_head, QuantedLinear)


@pytest.mark.parametrize("engine", ["paged", "slot"])
def test_graphed_sampled_decode_equals_eager_of_one_seed(dev, engine):
    """do_sample draws from the engine's generator, registered with the
    graph: a warmed and an eager engine from one seed draw the same
    tokens."""
    cfg, model = _graph_model(dev, "bfloat16")
    kw = dict(do_sample=True, temperature=1.3, top_k=50, seed=9,
              paged_kv=engine == "paged")
    _, ref = _serve_graph(model, False, **kw)
    _, got = _serve_graph(model, True, **kw)
    assert got == ref


def test_graphed_spec_verify_equals_eager(dev):
    cfg, model = _graph_model(dev, "bfloat16")
    kw = dict(spec_decode=3, paged_kv=True)
    eager, ref = _serve_graph(model, False, **kw)
    warm, got = _serve_graph(model, True, **kw)
    assert got == ref
    assert warm.stats["spec_accepted"] == eager.stats["spec_accepted"]
    assert warm.warm_stats["serving.spec_verify"]["graph"]


@pytest.mark.parametrize("arch", ["llama", "gpt"])
def test_generate_graph_equals_an_eager_loop(dev, arch):
    """generate()'s per-token step replayed as a CUDA graph against a
    step-by-step loop over the same static-cache forward: the tokens are
    equal, the run holds a graph replayed max_new - 1 times."""
    from paddle_tpu_torch import generation as G
    from paddle_tpu_torch import seed
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    if arch == "llama":
        cfg, model = _graph_model(dev, "bfloat16")
    else:
        cfg = GPTConfig.tiny(hidden_size=256, num_attention_heads=4,
                             max_position_embeddings=256, dtype="bfloat16")
        seed(0)
        model = GPTForCausalLM(cfg, device=dev).eval()
    ids = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (3, 40)), device=dev)
    n = 10
    got = model.generate(ids, max_new_tokens=n)
    with torch.inference_mode():
        caches = G._empty_caches(model, 3, 40 + n, torch.bfloat16)
        logits, _ = model(ids, None, caches, 0)
        toks = [logits[:, -1].float().argmax(-1)]
        for i in range(n - 1):
            pos = torch.tensor(40 + i, device=dev)
            logits, _ = model(toks[-1][:, None], None, caches, pos)
            toks.append(logits[:, -1].float().argmax(-1))
    ref = torch.cat([ids, torch.stack(toks, 1)], 1).cpu().numpy()
    np.testing.assert_array_equal(got, ref)
    info = G.run_cache_info(model)[-1]
    assert info["graph"] and info["replays"] == n - 1
    # GPT's path has none of the port's kernels (cuBLAS Linears and
    # masked SDPA); Llama's QKV and MLP run in the graph
    assert bool(info["launches"]) == (arch == "llama")


# -- the serving fleet on the card ---------------------------------------------

def test_graphed_prefill_chunk_equals_eager_bitwise(dev):
    """Every chunk of every prompt replays one captured graph
    (``serving.prefill_chunk``, 64 rows: QKV and the MLP on wgmma); the
    pools after each step and the tokens equal the eager engine's
    bitwise, and a replay moves no launch counter."""
    from paddle_tpu_torch.inference import ContinuousBatchingEngine
    cfg, model = _graph_model(dev, "bfloat16")
    kw = dict(GRAPH_ENGINE, paged_kv=True)
    eager = ContinuousBatchingEngine(model, **kw)
    warm = ContinuousBatchingEngine(model, **kw)
    stats = warm.aot_warmup()["serving.prefill_chunk"]
    L = cfg.num_hidden_layers
    assert stats["graph"]
    assert stats["launches"]["fused_rmsnorm_qkv"] == L
    assert stats["launches"]["fused_mlp"] == L
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, 256, n) for n in GRAPH_PROMPTS]
    re = [eager.add_request(p, max_new_tokens=12) for p in prompts]
    rw = [warm.add_request(p, max_new_tokens=12) for p in prompts]
    before = FB.fused_mlp.launches
    while eager.pending or warm.pending:
        eager.step()
        warm.step()
        for a, b in zip(_caches_of(eager), _caches_of(warm)):
            assert torch.equal(a[1:], b[1:])
    oe, ow = eager.run(), warm.run()
    assert [oe[r][1] for r in re] == [ow[r][1] for r in rw]
    chunks = warm._graphs["serving.prefill_chunk"].replays
    assert chunks == eager.stats["prefill_chunks"] > len(prompts)
    # the eager engine's chunks and decodes launched; the replays did not
    assert FB.fused_mlp.launches - before == \
        L * (chunks + eager.stats["decode_steps"])
    eager.close(), warm.close()


def test_pad_past_the_rope_table_runs_on_the_card(dev):
    """max_len 64 = the RoPE table, chunk 24, a 50-token prompt: the
    final chunk's pads sit at positions 64..71, past the table.  They are
    clamped on the device, so the chunk runs (no device-side assert),
    eager and graphed alike, with equal tokens."""
    from paddle_tpu_torch import seed
    from paddle_tpu_torch.inference import ContinuousBatchingEngine
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    cfg = LlamaConfig.tiny(hidden_size=256, intermediate_size=512,
                           num_attention_heads=2, num_key_value_heads=1,
                           max_position_embeddings=64, dtype="bfloat16")
    seed(0)
    model = LlamaForCausalLM(cfg, device=dev)
    prompt = np.random.default_rng(5).integers(0, 256, 50)
    toks = []
    for warm in (False, True):
        eng = ContinuousBatchingEngine(
            model, slots=2, max_len=64, prefill_buckets=(32,),
            kv_block_size=8, prefill_chunk=24, paged_kv=True)
        if warm:
            eng.aot_warmup()
        r = eng.add_request(prompt, max_new_tokens=4)
        toks.append(eng.run()[r][1])
        assert eng.request_status(r) == "ok"
        torch.cuda.synchronize()
        eng.close()
    assert toks[0] == toks[1] and len(toks[0]) == 4


@pytest.mark.parametrize("quant", [None, "int8"])
def test_handoff_round_trip_is_bitwise_on_the_card(dev, quant):
    """Blocks exported from bf16 (or int8 + scales) pools on the card,
    serialized, deserialized and imported at other ids of another pool,
    export again bit for bit, scales included."""
    from paddle_tpu_torch.inference.kv_cache import (PagedKVPool,
                                                     deserialize_handoff,
                                                     serialize_handoff)
    g = torch.Generator(device=dev).manual_seed(0)
    pools = [PagedKVPool(2, 12, 16, 8, 128, torch.bfloat16, dev,
                         quant=quant) for _ in range(2)]
    for t in pools[0].kpools + pools[0].vpools:
        if quant:
            t.copy_(torch.randint(-127, 128, t.shape, generator=g,
                                  device=dev, dtype=torch.int8))
        else:
            t.copy_(torch.randn(t.shape, generator=g, device=dev))
    for t in pools[0].kscales + pools[0].vscales:
        t.copy_(torch.rand(t.shape, generator=g, device=dev))
    exp = pools[0].export_blocks([3, 7, 5])
    back = deserialize_handoff(serialize_handoff({"kv": exp}))["kv"]
    pools[1].import_blocks(back, [1, 2, 9])
    again = pools[1].export_blocks([1, 2, 9])
    parts = ("k", "v", "k_scale", "v_scale") if quant else ("k", "v")
    for part in parts:
        for a, b in zip(exp[part], again[part]):
            assert a.device.type == "cuda" and torch.equal(a, b)


def test_small_fleet_on_the_card_equals_one_engine(dev):
    """A warmed mixed fleet of two replicas and a warmed disaggregated
    one (decode at steps_per_sync=4) over one bf16 model: every request
    "ok" with the single warmed engine's greedy tokens."""
    from paddle_tpu_torch.inference import ServingRouter
    cfg, model = _graph_model(dev, "bfloat16")
    kw = dict(GRAPH_ENGINE, paged_kv=True)
    one, ref = _serve_graph(model, True, paged_kv=True)
    one.close()
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, 256, n) for n in GRAPH_PROMPTS]
    for topo in (dict(replicas=2),
                 dict(replicas=2, prefill_replicas=1,
                      decode_kwargs=dict(steps_per_sync=4))):
        router = ServingRouter(model, engine_kwargs=kw, warm_on_spawn=True,
                               **topo)
        assert all(rep.engine._graphs for rep in router._replicas.values())
        rids = [router.add_request(p, max_new_tokens=12) for p in prompts]
        out = router.run()
        assert all(router.request_status(r) == "ok" for r in rids)
        assert [out[r][1] for r in rids] == ref
        router.close()



# -- int8_weights, W8A8 and the path counters ---------------------------------

@pytest.mark.parametrize("engine", ["paged", "slot"])
def test_int8_weights_graphed_equals_eager(dev, engine):
    """int8_weights on the card: warmed and eager engines give the same
    tokens bitwise; the projections run the quant matmul, the fused QKV /
    MLP never; close() hands back the model's own layers."""
    from paddle_tpu_torch.nn.common_layers import Embedding
    from paddle_tpu_torch.ops import kernels
    cfg, model = _graph_model(dev, "bfloat16")
    kw = dict(int8_weights=True, paged_kv=engine == "paged")
    kernels.reset_launch_counts()
    eager, ref = _serve_graph(model, False, **kw)
    warm, got = _serve_graph(model, True, **kw)
    assert got == ref
    assert QM.quant_matmul.launches > 0
    assert FB.fused_rmsnorm_qkv.launches == 0 and FB.fused_mlp.launches == 0
    warm.close()
    eager.close()
    assert isinstance(model.model.embed_tokens, Embedding)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_w8a8_accumulators_on_the_card_equal_the_cpu(dev, dtype):
    """The W8A8 product's int32 accumulators (codes at a Python scale in
    x's dtype, then ``torch._int_mm``) bitwise equal to the CPU's exact
    product, at a row count below _int_mm's 17 (padded) and above."""
    from paddle_tpu_torch.quantization import int8_linear_accumulate
    rng = np.random.default_rng(3)
    w = torch.from_numpy(rng.integers(-128, 128, (512, 384)).astype(np.int8))
    for rows in (5, 40):
        x = torch.from_numpy(rng.standard_normal((rows, 512)).astype(
            np.float32)).to(dtype)
        got = int8_linear_accumulate(x.to(dev), 0.0173, w.to(dev))
        want = int8_linear_accumulate(x, 0.0173, w)
        assert got.dtype == torch.int32
        assert torch.equal(got.cpu(), want)


def test_int8_embedding_on_the_card_equals_the_cpu(dev):
    from paddle_tpu_torch.nn.common_layers import Embedding
    from paddle_tpu_torch.quantization import Int8Embedding
    from paddle_tpu_torch.quantization.serving import quantize_weights_int8
    out = []
    for d in ("cpu", dev):
        emb = Embedding(300, 256, dtype="bfloat16", device=d)
        emb.set_state_dict({"weight": np.random.default_rng(4)
                            .standard_normal((300, 256)).astype(np.float32)})
        q, s = quantize_weights_int8(emb.weight)
        layer = Int8Embedding(emb, q, s)
        layer._orig = emb
        ids = torch.as_tensor([[1, 299, 7], [0, 5, 5]], device=d)
        out.append((q.cpu(), s.cpu(), layer(ids).cpu()))
    for a, b in zip(*out):
        assert torch.equal(a, b)


def test_path_counters_name_the_card_kernels(dev):
    """On the card the fused-block series counts ``fused`` where the CUDA
    kernels launch, the quant series ``pallas``, the paged series
    ``pallas`` for a decode step."""
    from paddle_tpu_torch.observability import default_registry
    from paddle_tpu_torch.quantization.serving import (quantize_for_serving,
                                                       restore_from_serving)

    def series():
        out = {}
        for name in ("paddle_tpu_fused_block_path_total",
                     "paddle_tpu_quant_kernel_path_total"):
            m = default_registry().get(name)
            if m is not None:
                out.update({(name,) + k: c.value() for k, c in m.series()})
        return out

    cfg, model = _graph_model(dev, "bfloat16")
    ids = torch.as_tensor(np.random.default_rng(5).integers(0, 256, (2, 24)),
                          device=dev)
    before = series()
    with torch.inference_mode():
        model(ids)
        quantize_for_serving(model, "int8")
        try:
            model(ids)
        finally:
            restore_from_serving(model)
    after = series()
    moved = {k: v - before.get(k, 0.0) for k, v in after.items()
             if v != before.get(k, 0.0)}
    fb, qk = ("paddle_tpu_fused_block_path_total",
              "paddle_tpu_quant_kernel_path_total")
    L = cfg.num_hidden_layers
    assert moved[(fb, "rmsnorm_qkv", "fused")] == L
    assert moved[(fb, "mlp", "fused")] == L
    assert moved[(fb, "rmsnorm_qkv", "reference")] == L
    assert moved[(qk, "matmul_int8", "pallas")] > 0
    assert not any(k[0] == qk and k[2] == "fallback" for k in moved)


# -- the measurement slice: device profiler, cost model, telemetry ------------

def test_device_profiler_times_captured_segments(dev):
    """Every segment of a small bf16 Llama captured as a CUDA graph and
    timed by CUDA events: none skipped, each report names the card, the
    fused segments' graphs hold their kernels, and a segment's time is
    within the span of a host-timed replay loop of the same program."""
    import time
    from paddle_tpu_torch.observability import device_profiler as DP
    cfg, model = _graph_model(dev, "bfloat16")
    segs = DP.llama_step_segments(model, _ids(cfg, 3))
    prof = DP.DeviceProfiler(device=dev)
    for s in segs:
        prof.add(s)
    res = prof.profile(reps=5)
    assert not res.skipped, res.skipped
    name = torch.cuda.get_device_name(dev)
    assert res.device == name and {r.device for r in res.segments} == {name}
    assert DP.compile_records("mlp")[-1].launches["fused_mlp"] == 1
    assert DP.compile_records("mlp")[-1].graph
    assert DP.compile_records("rmsnorm_qkv")[-1].launches[
        "fused_rmsnorm_qkv"] == 1
    mlp = next(r for r in res.segments if r.name == "mlp")
    compiled, _ = DP.aot_compile(segs[4].fn, *segs[4].args, target="mlp2")
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(20):
        compiled()
    torch.cuda.synchronize(dev)
    host = (time.perf_counter() - t0) / 20
    compiled.close()
    assert 0 < mlp.device_s <= 2 * host + 1e-4


def test_cost_count_on_the_card_charges_kernels_and_backward(dev):
    """On the card the wrappers charge at launch, the ptt ops once, and
    the backward's operators (on autograd's device thread) are counted
    too."""
    from paddle_tpu_torch.analysis import CostCounter
    from paddle_tpu_torch.ops.kernels import costs
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((256, 256), generator=g, device=dev).bfloat16()
    ws = [(torch.randn(s, generator=g, device=dev) * 0.05).bfloat16()
          .requires_grad_(True) for s in ((256, 512), (256, 512), (512, 256))]
    run = CostCounter()
    with run:
        y = FB.FusedMLP.apply(x, *ws)
        torch.autograd.grad(y.float().sum(), ws)
    assert tuple(run.by_prim["fused_mlp"][:2]) == \
        costs.mlp(x, *ws)[:2]
    assert run.by_prim["fused_mlp"][2] == 1
    assert run.by_prim["aten.mm"][2] >= 4        # the backward's products


def test_memory_monitor_reads_the_allocator(dev):
    from paddle_tpu_torch.observability import device_profiler as DP
    from paddle_tpu_torch.observability.metrics import MetricsRegistry
    mon = DP.DeviceMemoryMonitor(registry=MetricsRegistry(), device=dev)
    before, _ = mon.measure()
    keep = torch.empty((64 << 20,), dtype=torch.uint8, device=dev)
    after, blocks = mon.measure()
    assert after == torch.cuda.memory_allocated(dev)
    assert after - before >= 64 << 20 and blocks > 0
    assert any(r["shape"] == [64 << 20] for r in mon.census(top=50))
    assert mon.sample() == torch.cuda.memory_allocated(dev)
    del keep


def test_roofline_of_the_card(dev, monkeypatch):
    from paddle_tpu_torch.observability import device_profiler as DP
    monkeypatch.delenv("PADDLE_TPU_PEAK_FLOPS", raising=False)
    monkeypatch.delenv("PADDLE_TPU_HBM_BW", raising=False)
    if "h100" in torch.cuda.get_device_name(dev).lower():
        assert DP.detect_roofline(dev) == (989e12, 3.35e12)
    else:
        with pytest.raises(RuntimeError, match="no roofline"):
            DP.detect_roofline(dev)


def test_capture_leaves_the_allocator_peak(dev):
    """A capture (``aot_compile``) measures its own pool and leaves the
    allocator's process-wide peak as a caller's window set it."""
    from paddle_tpu_torch.observability import device_profiler as DP
    big = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    del big
    peak = torch.cuda.max_memory_allocated(dev)
    x = torch.randn(512, 512, device=dev)
    compiled, info = DP.aot_compile(lambda a: (a @ a).relu(), x,
                                    target="peak_kept")
    torch.testing.assert_close(compiled(), (x @ x).relu())
    assert info.stats.peak_bytes > 0
    assert torch.cuda.max_memory_allocated(dev) >= peak
    compiled.close()


def test_train_step_compile_counts_and_arms_mfu(dev):
    """``compile()`` on the card: the count (the first warm-up) holds the
    kernels' charges, the record the graph and the bytes its capture's
    pool reserved; the MFU gauge is set from a replayed step."""
    from paddle_tpu_torch.observability import default_registry
    cfg, model = _graph_model(dev, "bfloat16")
    step = _graph_step(model)
    info = step.compile(_ids(cfg, 0))
    assert info.graph and info.stats.flops > 0
    assert info.stats.peak_bytes > 0
    for k in ("fused_mlp", "fused_rmsnorm_qkv", "flash_attention_fwd",
              "multi_tensor_adam", "multi_tensor_norm"):
        assert k in info.cost.by_prim, k
    step(_ids(cfg, 1))
    mfu = default_registry().get("paddle_tpu_train_mfu").value()
    assert 0 < mfu < 1


# -- the op surface, AMP and the float16 guard (the op hook's slice) --------

def test_op_surface_on_the_card(dev):
    """chip_smoke.py's op_surface: every generated and hand-written op on
    CUDA tensors against the CPU run on the same inputs, the random ops
    repeated under seed on the card."""
    import chip_smoke
    counts = chip_smoke.op_surface(dev)
    assert counts["generated"] == 304 and counts["random"] == 15


def test_amp_o2_step_at_small_width(dev):
    """One decorate(O2) + auto_cast + GradScaler step of a Llama at head
    dim 128 on the card: bf16 QKV, MLP and flash launched, fp32 masters,
    the loss within 2e-2 of the plain bf16 model's."""
    from paddle_tpu_torch import amp, seed
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.optimizer import AdamW
    cfg = LlamaConfig.tiny(hidden_size=256, intermediate_size=512,
                           num_attention_heads=2, num_key_value_heads=1,
                           num_hidden_layers=2)
    seed(0)
    model = LlamaForCausalLM(cfg, device=dev)
    opt = AdamW(learning_rate=1e-3, parameters=model.parameters())
    model, opt = amp.decorate(model, opt, level="O2", dtype="bfloat16")
    ids = torch.randint(0, cfg.vocab_size, (2, 128), device=dev)
    with torch.no_grad():
        plain = float(model.loss(ids, ids))
    kernels.reset_launch_counts()
    scaler = amp.GradScaler()
    with amp.auto_cast(level="O2"):
        loss = model.loss(ids, ids)
    scaler.scale(loss).backward()
    scaler.step(opt)
    opt.clear_grad()
    assert abs(float(loss) - plain) / abs(plain) < 2e-2
    for fn in (kernels.fused_rmsnorm_qkv, kernels.fused_mlp,
               kernels.flash_attention_fwd, kernels.flash_attention_bwd_dq,
               kernels.flash_attention_bwd_dkv):
        assert fn.launches_by_dtype == {"bfloat16": 2}, fn.__name__
    assert all(opt._accumulators[id(p)]["_master"].dtype == torch.float32
               for p in model.parameters())


def test_grad_scaler_finds_nan_and_inf_on_the_card(dev):
    """The found-inf flag (inf-norms of the unscaled gradients) sees a
    NaN and an inf in CUDA gradients of each dtype."""
    from paddle_tpu_torch import amp
    for bad in (float("nan"), float("inf")):
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            p = torch.nn.Parameter(torch.ones(64, device=dev, dtype=dtype))
            p.grad = torch.ones_like(p)
            p.grad[7] = bad

            class Opt:
                _parameters = [p]

                def step(self):
                    raise AssertionError("a non-finite step was taken")
            s = amp.GradScaler(init_loss_scaling=4.0)
            s.step(Opt())
            assert s._found_inf and s.get_loss_scaling() == 2.0


@pytest.mark.parametrize("wrapper", ["flash", "qkv", "mlp"])
def test_float16_raises_naming_the_queue_entry(dev, wrapper):
    """float16 has no kernel yet: a CUDA tensor raises a TypeError that
    names ROADMAP.md's queue 1 entry, and never takes the plain
    version."""
    rng = np.random.default_rng(0)
    h = torch.float16
    with pytest.raises(TypeError, match="queue 1, item 11"):
        if wrapper == "flash":
            q = _t(rng, (1, 128, 2, 128), h, dev)
            FA.flash_attention(q, q, q, causal=True)
        elif wrapper == "qkv":
            x = _t(rng, (32, 128), h, dev)
            FB.fused_rmsnorm_qkv(x, _t(rng, (128,), h, dev),
                                 _t(rng, (128, 128), h, dev),
                                 _t(rng, (128, 64), h, dev),
                                 _t(rng, (128, 64), h, dev))
        else:
            x = _t(rng, (32, 128), h, dev)
            FB.fused_mlp(x, _t(rng, (128, 256), h, dev),
                         _t(rng, (128, 256), h, dev),
                         _t(rng, (256, 128), h, dev))
