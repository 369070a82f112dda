"""The serving engine's ``int8_weights=True`` against the JAX engine's, on
the CPU in fp32: the codes and scales of ``quantize_weights_int8`` bit
for bit, the int8 embedding bitwise equal to JAX's dequantize-then-
gather, and greedy tokens equal to the JAX engine's on the slot and the
paged engines, with chunked prefill, prefix reuse and ``spec_decode``.
The widths (hidden 256, intermediate 512, two heads of 128, vocab 512)
put every projection, the embedding and the lm_head past JAX's
``1 << 16`` threshold, so every matmul runs on int8 codes."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as pp
from paddle_tpu.inference.serving import \
    ContinuousBatchingEngine as JEngine
from paddle_tpu.inference.serving import \
    quantize_weights_int8 as jax_quantize_weights_int8
from paddle_tpu.models import LlamaConfig as JLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JLlamaForCausalLM

from paddle_tpu_torch.inference import ContinuousBatchingEngine
from paddle_tpu_torch.inference.router import ServingRouter
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.nn.common_layers import Embedding, Linear
from paddle_tpu_torch.nn.layer import _from_numpy
from paddle_tpu_torch.quantization import Int8Embedding, QuantedLinear
from paddle_tpu_torch.quantization import serving as QS

WIDE = dict(vocab_size=512, hidden_size=256, intermediate_size=512,
            num_hidden_layers=2, num_attention_heads=2,
            num_key_value_heads=2, max_position_embeddings=128)
ENGINE = dict(slots=2, max_len=64, prefill_buckets=(16, 32),
              kv_block_size=4, prefill_chunk=8, paged_kv=True)


@pytest.fixture(scope="module")
def pair():
    pp.seed(0)
    jm = JLlamaForCausalLM(JLlamaConfig.tiny(**WIDE))
    tm = LlamaForCausalLM(LlamaConfig.tiny(**WIDE), device="cpu")
    tm.set_state_dict({k: v.numpy() for k, v in jm.state_dict().items()})
    return jm, tm


def _bits(t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32) \
        if t.is_floating_point() else t


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(256, 256), (512, 128), (300, 260)])
def test_codes_and_scales_equal_jax_bitwise(shape, dtype):
    """Codes and ``[1, out]`` scales of one weight: exactly JAX's (with a
    zero column, whose scale is 0 and whose codes divide by 1e-12)."""
    rng = np.random.default_rng(sum(shape))
    w = rng.standard_normal(shape).astype(np.float32) * 0.05
    w[:, 3] = 0.0
    jw = jnp.asarray(w, dtype)
    keep, quant = jax_quantize_weights_int8({"w": jw})
    jq, js = quant["w"]
    q, s = QS.quantize_weights_int8(_from_numpy(np.asarray(jw)))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert tuple(s.shape) == (1, shape[1])
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


def test_model_conversion_matches_jax_param_dict(pair):
    """Every floating 2-D parameter of at least 1 << 16 elements is
    converted (the Linears and the embedding), with JAX's codes and
    scales; the norms are not."""
    jm, tm = pair
    params = {k: jnp.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    keep, quant = jax_quantize_weights_int8(params)
    info = QS.quantize_int8_weights(tm)
    try:
        converted = {n: m for n, m in tm.named_modules()
                     if isinstance(m, (QuantedLinear, Int8Embedding))}
        assert info["layers"] == len(converted) == len(quant)
        for name, (jq, js) in quant.items():
            m = converted[name.removesuffix(".weight")]
            np.testing.assert_array_equal(m.qweight.numpy(), np.asarray(jq))
            np.testing.assert_array_equal(
                m.w_scale.reshape(1, -1).numpy(), np.asarray(js))
        assert not any(k.endswith("norm.weight") for k in quant)
    finally:
        assert QS.restore_from_serving(tm)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_embedding_equals_dequantize_then_gather(dtype):
    """Gathering int8 rows, then ``(rows.f32 * scale).astype(dtype)``:
    bitwise JAX's ``_dequant`` followed by the gather; ``weight`` (what a
    tied lm_head reads) is the whole dequantized table."""
    from paddle_tpu.inference.serving import _dequant
    rng = np.random.default_rng(1)
    emb = Embedding(512, 128, dtype=dtype)
    w = rng.standard_normal((512, 128)).astype(np.float32)
    jw = jnp.asarray(w, dtype)
    emb.set_state_dict({"weight": _from_numpy(np.asarray(jw))})
    _, quant = jax_quantize_weights_int8({"w": jw})
    table = np.asarray(_dequant({}, quant, jnp.dtype(dtype))["w"])
    q, s = QS.quantize_weights_int8(emb.weight)
    layer = Int8Embedding(emb, q, s)
    layer._orig = emb
    ids = rng.integers(0, 512, (3, 7))
    got = layer(torch.as_tensor(ids))
    want = _from_numpy(table[ids])
    assert got.dtype == want.dtype
    assert torch.equal(_bits(got), _bits(want))
    assert torch.equal(_bits(layer.weight), _bits(_from_numpy(table)))


def _prompts(seed, lengths, prefix=None):
    rng = np.random.default_rng(seed)
    out = []
    for n in lengths:
        p = rng.integers(0, 512, (n,))
        if prefix is not None:
            p = np.concatenate([prefix, p])
        out.append(p)
    return out


_SHARED = np.random.default_rng(99).integers(0, 512, (13,))
SCENARIOS = {
    # the slot-contiguous engine (the JAX default)
    "slot": ({"paged_kv": False}, [(_prompts(1, [17, 5, 11]), 6)]),
    # one prompt across three prefill chunks of 8, slots reused
    "paged_chunked": ({}, [(_prompts(2, [17, 3, 20]), 6)]),
    # the second phase's prompts share the first's 13-token prefix
    "paged_prefix_reuse": ({}, [([_SHARED], 4),
                                (_prompts(3, [2, 7], prefix=_SHARED), 5)]),
    # n-gram speculation on prompts that repeat a span
    "paged_spec_decode": ({"spec_decode": 3},
                          [([np.tile(_prompts(4, [6])[0], 3)], 8)]),
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_greedy_tokens_match_jax_engine(pair, scenario):
    """Greedy tokens equal the JAX engine's with ``int8_weights=True``
    (exact equality; the kernel's plain version takes the scale on the
    fp32 sum, JAX before its product: fp32 rounding, no token moves)."""
    jm, tm = pair
    over, phases = SCENARIOS[scenario]
    kw = dict(ENGINE, int8_weights=True, **over)
    je = JEngine(jm, **kw)
    te = ContinuousBatchingEngine(tm, **kw)
    try:
        assert isinstance(tm.model.embed_tokens, Int8Embedding)
        for prompts, max_new in phases:
            jr = [je.add_request(p, max_new_tokens=max_new) for p in prompts]
            tr = [te.add_request(p, max_new_tokens=max_new) for p in prompts]
            jout, tout = je.run(), te.run()
            for a, b in zip(jr, tr):
                assert te.request_status(b) == "ok"
                assert list(tout[b][1]) == [int(t) for t in jout[a][1]]
    finally:
        te.close()
    assert isinstance(tm.model.embed_tokens, Embedding)


@pytest.mark.parametrize("paged", [True, False])
def test_aot_warmup_programs_equal_eager(pair, paged):
    """After aot_warmup (on the CPU the captured bodies over static
    buffers) the tokens equal the eager engine's."""
    tm = pair[1]
    kw = dict(ENGINE, int8_weights=True, paged_kv=paged)
    prompts = _prompts(5, [9, 14])
    outs = []
    for warm in (False, True):
        eng = ContinuousBatchingEngine(tm, **kw)
        try:
            if warm:
                eng.aot_warmup()
            rids = [eng.add_request(p, max_new_tokens=5) for p in prompts]
            out = eng.run()
            outs.append([list(out[r][1]) for r in rids])
        finally:
            eng.close()
    assert outs[0] == outs[1]


def test_conversion_refcounted_and_restored(pair):
    """Two engines share one conversion; the model's own layers come
    back, unchanged, after the last close.  ``quant_weights`` on a model
    held by ``int8_weights`` raises, as does asking for both."""
    tm = pair[1]
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    a = ContinuousBatchingEngine(tm, int8_weights=True, **ENGINE)
    b = ContinuousBatchingEngine(tm, int8_weights=True, **ENGINE)
    assert tm._serving_quant_refs == 2
    assert isinstance(tm.lm_head, QuantedLinear)
    with pytest.raises(ValueError, match="already quantized"):
        ContinuousBatchingEngine(tm, quant_weights="int8", **ENGINE)
    a.close()
    assert isinstance(tm.lm_head, QuantedLinear)
    b.close()
    assert type(tm.lm_head) is Linear and tm._serving_quant_refs == 0
    after = tm.state_dict()
    assert set(after) == set(before)
    assert all(torch.equal(after[k], before[k]) for k in before)
    with pytest.raises(ValueError, match="mutually exclusive"):
        ContinuousBatchingEngine(tm, int8_weights=True, quant_weights="int8",
                                 **ENGINE)


def test_router_refuses_tiers_of_other_int8_weights(pair):
    """Replicas share the model, converted in place: a fleet whose tiers
    differ in ``int8_weights`` raises, as mixed ``quant_weights`` does;
    the same ``int8_weights`` everywhere serves."""
    tm = pair[1]
    with pytest.raises(ValueError, match="int8_weights"):
        ServingRouter(tm, replicas=2, prefill_replicas=1,
                      engine_kwargs=dict(ENGINE),
                      prefill_kwargs={"int8_weights": True})
    router = ServingRouter(tm, replicas=2, engine_kwargs=dict(
        ENGINE, int8_weights=True))
    try:
        rid = router.add_request(_prompts(6, [7])[0], max_new_tokens=3)
        out = router.run()
        assert router.request_status(rid) == "ok" and len(out[rid][1]) == 3
    finally:
        router.close()
    assert type(tm.lm_head) is Linear
