"""Quantized serving in the PyTorch port against the JAX package, on the
CPU: the quant matmul and its plain version, weight and KV quantization
bit for bit, the int8 paged-decode plain version, the serving conversion
(names, count, refcount, restore), the parity report, and a whole
converted model carried across.

Inputs come from ``numpy.random.default_rng`` and go to both packages;
quantized buffers cross as their bits (int8 as is, float8_e4m3fn through
a uint8 view).  fp32 unless a test says otherwise."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as pp
from paddle_tpu.inference import kv_cache as JKV
from paddle_tpu.models import LlamaConfig as JLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JLlamaForCausalLM
from paddle_tpu.ops.pallas import paged_attention as JPA
from paddle_tpu.ops.pallas import quant_matmul as JQM
from paddle_tpu.quantization import serving as JQS

from paddle_tpu_torch.inference import kv_cache as TKV
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.nn.layer import _from_numpy
from paddle_tpu_torch.ops.kernels import paged_attention as PA
from paddle_tpu_torch.ops.kernels import quant_matmul as QM
from paddle_tpu_torch.quantization import QuantedLinear
from paddle_tpu_torch.quantization import serving as QS

TINY = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=128)
MODES = ["int8", "fp8"]


def _torch(a):
    """A JAX array (any dtype, fp8 included) as a CPU tensor, bit for
    bit."""
    return _from_numpy(np.asarray(a))


def _bits(t):
    """The stored bytes of a tensor (int8 or float8_e4m3fn) as uint8."""
    return t.contiguous().view(torch.uint8).numpy()


def _jweights(rng, shape, spread=True):
    """fp32 weights whose channels span several magnitudes (so the
    per-channel scales differ), with one all-zero channel (the scale
    floor)."""
    w = rng.standard_normal(shape).astype(np.float32)
    if spread:
        w *= np.exp2(rng.integers(-6, 6, (1, shape[1]))).astype(np.float32)
        w[:, 3] = 0.0
    return w


# -- the quant matmul ---------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
def test_quant_matmul_matches_pallas_fp32(mode):
    """fp32 io: the port's wrapper (plain version on the CPU) against the
    Pallas kernel in interpret mode and JAX's reference: 1e-6 relative
    (fp32 sums of 128 products in another order)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((16, 128)).astype(np.float32)
    jq, js = JQS.quantize_linear_weight(_jweights(rng, (128, 256)), mode)
    kern = JQM.quant_matmul_pallas(jnp.asarray(x), jq, js, interpret=True,
                                   autotune=False)
    ref = JQM.quant_matmul_reference(jnp.asarray(x), jq, js)
    got = QM.quant_matmul(torch.from_numpy(x), _torch(jq), _torch(js),
                          mode=mode)
    assert got.dtype == torch.float32 and tuple(got.shape) == (16, 256)
    for r in (kern, ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(r), rtol=1e-6,
                                   atol=1e-6 * float(np.abs(r).max()))


@pytest.mark.parametrize("mode", MODES)
def test_quant_matmul_matches_jax_bf16_within_one_ulp(mode):
    """bf16 io: both up-convert the weight exactly, sum in fp32 and round
    once, so they differ by at most one bf16 step of the result."""
    rng = np.random.default_rng(1)
    xb = jnp.asarray(rng.standard_normal((16, 128)), jnp.bfloat16)
    jq, js = JQS.quantize_linear_weight(_jweights(rng, (128, 256)), mode)
    ref = np.asarray(JQM.quant_matmul_reference(xb, jq, js), np.float32)
    got = QM.quant_matmul(_torch(xb), _torch(jq), _torch(js), mode=mode)
    assert got.dtype == torch.bfloat16
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)
    assert np.all(np.abs(got.float().numpy() - ref) <= ulp)


@pytest.mark.parametrize("mode", MODES)
def test_quant_matmul_leading_dims(mode):
    """``[2, 8, K]`` activations against JAX's routing ``quant_matmul``
    (its fallback on the CPU) and against the port on the flat rows."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 8, 128)).astype(np.float32)
    jq, js = JQS.quantize_linear_weight(_jweights(rng, (128, 256)), mode)
    ref = np.asarray(JQM.quant_matmul(jnp.asarray(x), jq, js, mode=mode))
    got = QM.quant_matmul(torch.from_numpy(x), _torch(jq), _torch(js),
                          mode=mode)
    assert tuple(got.shape) == (2, 8, 256)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6,
                               atol=1e-6 * float(np.abs(ref).max()))
    flat = QM.quant_matmul(torch.from_numpy(x.reshape(16, 128)),
                           _torch(jq), _torch(js), mode=mode)
    assert torch.equal(got.reshape(16, 256), flat)


def test_weight_dtypes_and_mode_check():
    assert QM.weight_dtype("int8") == torch.int8
    assert QM.weight_dtype("fp8") == torch.float8_e4m3fn
    assert QM.QUANT_WEIGHT_DTYPES == JQM.QUANT_WEIGHT_DTYPES
    with pytest.raises(ValueError, match="int8|fp8"):
        QM.weight_dtype("int4")
    qw = torch.zeros((64, 64), dtype=torch.int8)
    with pytest.raises(TypeError, match="fp8"):
        QM.quant_matmul(torch.zeros(2, 64), qw, torch.ones(64), mode="fp8")


def test_quant_matmul_on_the_cpu_is_not_a_launch():
    from paddle_tpu_torch.ops import kernels
    before = (QM.quant_matmul.launches, dict(QM.quant_matmul.launches_by_mode),
              PA.paged_decode_attention_int8.launches)
    QM.quant_matmul(torch.randn(4, 64), torch.ones((64, 64), dtype=torch.int8),
                    torch.ones(64))
    assert (QM.quant_matmul.launches, QM.quant_matmul.launches_by_mode,
            PA.paged_decode_attention_int8.launches) == before
    kernels.reset_launch_counts()
    assert QM.quant_matmul.launches == 0 and \
        set(QM.quant_matmul.launches_by_mode.values()) == {0}
    assert QM.quant_matmul in kernels.KERNELS and \
        PA.paged_decode_attention_int8 in kernels.SERVING_QUANT


# -- quantization, bit for bit ------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", [(128, 256), (64, 96)])
def test_quantize_linear_weight_is_bitwise_jax(mode, shape):
    rng = np.random.default_rng(shape[1])
    w = _jweights(rng, shape)
    jq, js = JQS.quantize_linear_weight(jnp.asarray(w), mode)
    tq, ts = QS.quantize_linear_weight(torch.from_numpy(w), mode)
    assert tq.dtype == QM.weight_dtype(mode) and ts.dtype == torch.float32
    np.testing.assert_array_equal(_bits(tq), np.asarray(jq).view(np.uint8))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_is_bitwise_jax(dtype):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 5, 2, 16)).astype(np.float32)
    x[0, 1, 1] = 0.0                        # a zero row: the 1e-8 floor
    x[2] *= 40.0
    jx = jnp.asarray(x, getattr(jnp, dtype))
    jq, js = JKV._quantize_kv(jx)
    tq, ts = TKV._quantize_kv(_torch(jx))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_quant_kv_mode_knob(monkeypatch):
    monkeypatch.delenv("PADDLE_TPU_QUANT_KV", raising=False)
    assert TKV.quant_kv_mode() is None
    monkeypatch.setenv("PADDLE_TPU_QUANT_KV", "int8")
    assert TKV.quant_kv_mode() == "int8"
    assert TKV.quant_kv_mode("0") is None
    monkeypatch.setenv("PADDLE_TPU_QUANT_KV", "fp4")
    with pytest.raises(ValueError, match="int8"):
        TKV.quant_kv_mode()


def test_quant_weights_mode_knob(monkeypatch):
    monkeypatch.delenv("PADDLE_TPU_QUANT_WEIGHTS", raising=False)
    assert QS.quant_weights_mode() is None
    monkeypatch.setenv("PADDLE_TPU_QUANT_WEIGHTS", "int8")
    assert QS.quant_weights_mode() == "int8"
    assert QS.quant_weights_mode("fp8") == "fp8"      # explicit wins
    assert QS.quant_weights_mode("0") is None
    monkeypatch.setenv("PADDLE_TPU_QUANT_WEIGHTS", "int4")
    with pytest.raises(ValueError, match="int8|fp8"):
        QS.quant_weights_mode()
    assert QS.QUANT_MODES == JQS.QUANT_MODES


# -- int8 paged decode --------------------------------------------------------

@pytest.mark.parametrize("B,h,kvh,hd,bs,nb,bt,lengths", [
    # tests/test_quant_serving.py's shapes
    (2, 4, 2, 16, 4, 6, [[1, 2, 0], [3, 4, 5]], [7, 11]),
    (4, 8, 2, 32, 8, 9, [[0, 0, 0], [1, 2, 3], [4, 5, 6], [7, 8, 1]],
     [1, 8, 17, 24]),
])
def test_int8_paged_decode_matches_pallas(B, h, kvh, hd, bs, nb, bt,
                                          lengths):
    """The quant plain version (through the wrapper, on the CPU) against
    ``_decode_kernel_quant`` in interpret mode: 1e-5."""
    rng = np.random.default_rng(B * hd)
    q = rng.standard_normal((B, h, hd)).astype(np.float32)
    kq, ks = JKV._quantize_kv(jnp.asarray(
        rng.standard_normal((nb, bs, kvh, hd)), jnp.float32))
    vq, vs = JKV._quantize_kv(jnp.asarray(
        rng.standard_normal((nb, bs, kvh, hd)), jnp.float32))
    bt = np.asarray(bt, np.int32)
    ln = np.asarray(lengths, np.int32)
    ref = JPA.paged_decode_attention(jnp.asarray(q), kq, vq, jnp.asarray(bt),
                                     jnp.asarray(ln), interpret=True,
                                     k_scale=ks, v_scale=vs)
    before = PA.paged_decode_attention_int8.launches
    got = PA.paged_decode_attention(
        torch.from_numpy(q), _torch(kq), _torch(vq), torch.from_numpy(bt),
        torch.from_numpy(ln), k_scale=_torch(ks), v_scale=_torch(vs))
    assert PA.paged_decode_attention_int8.launches == before
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)


def test_int8_paged_decode_needs_both_scales():
    q = torch.zeros(1, 2, 16)
    pool = torch.zeros((2, 4, 1, 16), dtype=torch.int8)
    bt = torch.zeros((1, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="k_scale and v_scale"):
        PA.paged_decode_attention(q, pool, pool, bt,
                                  torch.ones(1, dtype=torch.int32),
                                  k_scale=torch.ones(2, 4, 1))


def test_pool_copy_block_carries_scales():
    pool = TKV.PagedKVPool(2, 6, 4, 2, 8, torch.float32, "cpu",
                           quant="int8")
    assert pool.kpools[0].dtype == torch.int8 and len(pool.kscales) == 2
    g = torch.Generator().manual_seed(0)
    for p in pool.kpools + pool.vpools:
        p.copy_(torch.randint(-127, 128, p.shape, generator=g))
    for s in pool.kscales + pool.vscales:
        s.copy_(torch.rand(s.shape, generator=g))
    pool.copy_block(2, 5)
    for p in pool.kpools + pool.vpools + pool.kscales + pool.vscales:
        assert torch.equal(p[5], p[2])
    # payload int8 plus fp32 scales: 264 of the 512 bytes bf16 would take
    # per token and kv head at head_dim 128; here 8 + 4 per row
    assert pool.nbytes == 2 * 2 * 6 * 4 * 2 * (8 + 4)
    pool.reset()
    assert not any(p.any() for p in pool._all())
    with pytest.raises(ValueError, match="only int8"):
        TKV.PagedKVPool(1, 2, 4, 1, 8, torch.float32, "cpu", quant="fp8")


# -- the serving conversion ---------------------------------------------------

@pytest.fixture
def pair():
    pp.seed(0)
    jm = JLlamaForCausalLM(JLlamaConfig.tiny(**TINY))
    tm = LlamaForCausalLM(LlamaConfig.tiny(**TINY), device="cpu")
    tm.set_state_dict({k: v.numpy() for k, v in jm.state_dict().items()})
    return jm, tm


@pytest.mark.parametrize("mode", MODES)
def test_conversion_names_count_and_restore_match_jax(pair, mode):
    """The tiny config converts q, o, gate, up, down and lm_head (k and v
    hold 64x32 = 2048 < 4096 elements) in both packages, under the same
    state-dict names and shapes."""
    jm, tm = pair
    ji = JQS.quantize_for_serving(jm, mode)
    ti = QS.quantize_for_serving(tm, mode)
    assert ti == ji == {"layers": 11, "refs": 1}
    j = {k: tuple(v.shape) for k, v in jm.state_dict().items()}
    t = {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    assert t == j
    assert "model.layers_0.self_attn.q_proj._orig.weight" in t
    assert "model.layers_0.self_attn.k_proj.weight" in t
    assert isinstance(tm.lm_head, QuantedLinear)
    assert tm.lm_head.qweight.dtype == QM.weight_dtype(mode)
    np.testing.assert_array_equal(
        _bits(tm.lm_head.qweight),
        np.asarray(jm.lm_head.qweight.numpy()).view(np.uint8))
    # refcounted, and a second mode is refused while held
    assert QS.quantize_for_serving(tm, mode)["refs"] == 2
    other = "fp8" if mode == "int8" else "int8"
    with pytest.raises(ValueError, match="already quantized"):
        QS.quantize_for_serving(tm, other)
    assert QS.restore_from_serving(tm) is False
    assert QS.restore_from_serving(tm) is True
    assert QS.restore_from_serving(tm) is True           # nothing held
    JQS.restore_from_serving(jm)
    assert getattr(tm, "_serving_quant_refs") == 0
    assert "lm_head.weight" in tm.state_dict() and \
        not any("qweight" in k for k in tm.state_dict())


def test_astype_keeps_the_quantized_buffers(pair):
    """Casting a converted model casts its fp weights and leaves the
    codes and the fp32 scales alone."""
    tm = pair[1]
    QS.quantize_for_serving(tm, "fp8")
    try:
        before = _bits(tm.lm_head.qweight).copy()
        tm.astype("bfloat16")
        assert tm.lm_head.qweight.dtype == torch.float8_e4m3fn
        assert tm.lm_head.w_scale.dtype == torch.float32
        assert tm.lm_head._orig.weight.dtype == torch.bfloat16
        np.testing.assert_array_equal(_bits(tm.lm_head.qweight), before)
    finally:
        QS.restore_from_serving(tm)


def test_quantized_linear_calibration_side_raises(pair):
    """The calibration side is ported: ``QuantedLinear(act_scale=...)``
    over the serving codes equals JAX's (1e-6 of the largest output, its
    int32 product exact) and the calibration classes construct.  What
    still raises is a serving conversion without a mode."""
    from paddle_tpu.quantization import QuantedLinear as JQuantedLinear
    from paddle_tpu_torch import quantization as Q
    jm, tm = pair
    jq = JQuantedLinear(jm.lm_head, act_scale=0.1, mode="int8")
    tq = QuantedLinear(tm.lm_head, act_scale=0.1, mode="int8")
    x = np.random.default_rng(5).standard_normal((3, 64)).astype(np.float32)
    want = jq(pp.to_tensor(x)).numpy()
    got = tq(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
    assert isinstance(Q.PTQ(), Q.PTQ) and isinstance(Q.QAT(), Q.QAT)
    assert Q.AbsMaxObserver().scale() == pytest.approx(1e-8 / 127)
    assert isinstance(Q.FakeQuantLinear(tm.lm_head), Q.FakeQuantLinear)
    with pytest.raises(ValueError, match="mode=int8|fp8"):
        QS.quantize_for_serving(pair[1], None)


@pytest.mark.parametrize("mode", MODES)
def test_parity_report_matches_jax(pair, mode):
    jm, tm = pair
    ids = np.random.default_rng(11).integers(0, 256, (1, 16)).astype(np.int32)
    jr = JQS.parity_report(jm, mode, ids)
    tr = QS.parity_report(tm, mode, ids)
    assert tr["layers"] == jr["layers"] == 11
    for key in ("max_logit_err", "ref_logit_absmax", "rel_logit_err"):
        assert abs(tr[key] - jr[key]) <= 1e-5, (key, tr[key], jr[key])
    assert getattr(tm, "_serving_quant_refs") == 0


@pytest.mark.parametrize("mode", MODES)
def test_converted_model_carried_from_jax(pair, mode):
    """A JAX-converted model's state dict (int8 or fp8 qweights, fp32
    scales, the kept originals) loaded into the converted port model:
    logits within 1e-5."""
    jm, tm = pair
    JQS.quantize_for_serving(jm, mode)
    QS.quantize_for_serving(tm, mode)
    try:
        tm.model.layers_0.mlp.up_proj.qweight.zero_()    # must be reloaded
        tm.set_state_dict({k: v.numpy() for k, v in jm.state_dict().items()})
        ids = np.random.default_rng(12).integers(0, 256, (2, 9))
        ref = np.asarray(jm(pp.to_tensor(ids.astype(np.int32))).numpy())
        with torch.inference_mode():
            got = tm(torch.from_numpy(ids)).numpy()
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)
    finally:
        JQS.restore_from_serving(jm)
        QS.restore_from_serving(tm)


def test_quantized_buffers_load_bit_for_bit_only(pair):
    """An int8/fp8 buffer takes a value of its own dtype and copies its
    bits; anything else would be converted and is refused."""
    tm = pair[1]
    QS.quantize_for_serving(tm, "fp8")
    try:
        sd = {k: v.clone() for k, v in tm.state_dict().items()}
        name = "lm_head.qweight"
        sd[name] = sd[name].view(torch.uint8).numpy()
        with pytest.raises(TypeError, match="codes"):
            tm.set_state_dict(sd)
        codes = np.arange(64 * 256, dtype=np.uint8).reshape(64, 256) % 126
        sd[name] = _from_numpy(codes.view(np.uint8)).view(
            torch.float8_e4m3fn)
        tm.set_state_dict(sd)
        np.testing.assert_array_equal(_bits(tm.lm_head.qweight), codes)
    finally:
        QS.restore_from_serving(tm)
