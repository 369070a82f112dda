"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here needs an NVIDIA GPU with sm_90 and nvcc: on a
machine without one they skip.  Run on the card with

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(``--noconftest``: the suite's conftest sets JAX up, which this file
does not use).  Inputs come from numpy with a fixed seed; tolerances
are stated per dtype: the kernels sum in another order than cuBLAS
(fp32) and round activations to bf16 at the same points as the plain
versions (bf16)."""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.inference.kv_cache import _quantize_kv
from paddle_tpu_torch.ops.kernels import flash_attention as FA
from paddle_tpu_torch.ops.kernels import fused_block as FB
from paddle_tpu_torch.ops.kernels import grouped_matmul as GM
from paddle_tpu_torch.ops.kernels import paged_attention as PA
from paddle_tpu_torch.ops.kernels import quant_matmul as QM
from paddle_tpu_torch.quantization.serving import quantize_linear_weight

pytestmark = pytest.mark.cuda

# (atol, rtol) per dtype: fp32 differs by summation order only; bf16
# outputs carry one bf16 rounding (2^-8 relative) plus order effects
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (3e-2, 3e-2)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    if torch.cuda.get_device_capability() < (9, 0):
        pytest.skip("the kernels are built for sm_90a (Hopper)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


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
              quant_kv="int8")
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
              kv_block_size=4, prefill_chunk=8)
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
@pytest.mark.parametrize("b,s,h,hk", FLASH_SHAPES)
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


def test_train_step_on_the_card_matches_the_cpu_port(dev):
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


def test_moe_train_step_on_the_card_matches_the_cpu_port(dev):
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
