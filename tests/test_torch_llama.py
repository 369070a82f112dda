"""The PyTorch port's Llama against the JAX package's, with the same
weights carried across (``Layer.set_state_dict`` from numpy), on the
CPU in fp32: state-dict names, the uncached forward, and the cached
forward over paged KV pools (chunked prefill with per-row offsets, then
decode).  Logits agree within 1e-4 (two layers of fp32 sums taken in
another order); pools within 1e-5."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as pp
from paddle_tpu.core.dispatch import unwrap
from paddle_tpu.inference.kv_cache import PagedCache as JPagedCache
from paddle_tpu.models import LlamaConfig as JLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JLlamaForCausalLM

import paddle_tpu_torch as pt
from paddle_tpu_torch.inference.kv_cache import PagedCache
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

TINY = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=128)
TOL = 1e-4


def _jax_weights(jm):
    return {k: v.numpy() for k, v in jm.state_dict().items()}


@pytest.fixture(scope="module")
def pair():
    pp.seed(0)
    jm = JLlamaForCausalLM(JLlamaConfig.tiny(**TINY))
    tm = LlamaForCausalLM(LlamaConfig.tiny(**TINY), device="cpu")
    tm.set_state_dict(_jax_weights(jm))
    return jm, tm


def test_state_dict_names_and_shapes_match(pair):
    jm, tm = pair
    j = {k: tuple(v.shape) for k, v in jm.state_dict().items()}
    t = {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    assert j == t
    assert "model.layers_0.self_attn.q_proj.weight" in t
    assert not any("rope" in k for k in t)   # non-persistable buffers


@pytest.mark.parametrize("seq", [1, 9])
def test_forward_logits_match(pair, seq):
    jm, tm = pair
    ids = np.random.default_rng(seq).integers(0, 256, (2, seq))
    ref = np.asarray(jm(pp.to_tensor(ids.astype(np.int32))).numpy())
    with torch.inference_mode():
        got = tm(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=TOL)


def test_paged_cached_forward_matches(pair):
    """Two rows at their own offsets: two prefill chunks, then decode
    steps (the decode kernel's plain version on the port's side, the
    gather path on the JAX side)."""
    jm, tm = pair
    rng = np.random.default_rng(7)
    B, bs, mb, kvh, hd = 2, 4, 8, 2, 16
    nb = 1 + B * mb
    bt = np.arange(1, nb, dtype=np.int32).reshape(B, mb)
    shape = (nb, bs, kvh, hd)
    jk = [jnp.zeros(shape) for _ in range(2)]
    jv = [jnp.zeros(shape) for _ in range(2)]
    tk = [torch.zeros(shape) for _ in range(2)]
    tv = [torch.zeros(shape) for _ in range(2)]
    steps = [(6, [0, 3]), (3, [6, 9]), (1, [9, 12]), (1, [10, 13])]
    for S, pos in steps:
        ids = rng.integers(0, 256, (B, S)).astype(np.int32)
        pos = np.asarray(pos, np.int32)
        jcc = [JPagedCache(k, v, jnp.asarray(bt)) for k, v in zip(jk, jv)]
        jl, jnew = jm(pp.to_tensor(ids), None, jcc, jnp.asarray(pos))
        jk = [unwrap(c.k) for c in jnew]
        jv = [unwrap(c.v) for c in jnew]
        tcc = [PagedCache(k, v, torch.from_numpy(bt)) for k, v in
               zip(tk, tv)]
        with torch.inference_mode():
            tl, _ = tm(torch.from_numpy(ids), None, tcc,
                       torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl.numpy()),
                                   atol=TOL, rtol=TOL)
    for a, b in zip(tk + tv, jk + jv):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("case", ["missing", "unexpected", "shape"])
def test_set_state_dict_refuses_a_mismatch(pair, case):
    jm, _ = pair
    sd = _jax_weights(jm)
    if case == "missing":
        sd.pop("lm_head.weight")
    elif case == "unexpected":
        sd["model.extra.weight"] = np.zeros(3, np.float32)
    else:
        sd["model.norm.weight"] = np.zeros(3, np.float32)
    tm = LlamaForCausalLM(LlamaConfig.tiny(**TINY), device="cpu")
    before = tm.model.norm.weight.clone()
    with pytest.raises(ValueError, match=case if case != "unexpected"
                       else "unexpected"):
        tm.set_state_dict(sd)
    assert torch.equal(tm.model.norm.weight, before)   # nothing written


def test_bf16_model_keeps_fp32_rope_and_reads_bf16_numpy():
    import ml_dtypes
    pt.seed(1)
    tm = LlamaForCausalLM(LlamaConfig.tiny(dtype="bfloat16", **TINY),
                          device="cpu")
    assert tm.lm_head.weight.dtype == torch.bfloat16
    assert tm.model.rope_cos.dtype == torch.float32
    tm.astype("float32").astype("bfloat16")
    assert tm.model.rope_cos.dtype == torch.float32
    assert tm.model.layers_1.mlp.up_proj.weight.dtype == torch.bfloat16
    sd = {k: v.float().numpy().astype(ml_dtypes.bfloat16)
          for k, v in tm.state_dict().items()}
    sd["model.norm.weight"] = np.full((64,), 0.5, ml_dtypes.bfloat16)
    tm.set_state_dict(sd)
    assert torch.all(tm.model.norm.weight == 0.5)


def test_entry_point_needs_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LlamaForCausalLM(LlamaConfig.tiny(**TINY))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pt.resolve_device("cuda")
    m = LlamaForCausalLM(LlamaConfig.tiny(**TINY), device="cpu")
    assert m.device.type == "cpu"
    assert all(p.device.type == "cpu" for p in m.parameters())


def test_seeded_init_is_reproducible():
    pt.seed(3)
    a = LlamaForCausalLM(LlamaConfig.tiny(**TINY), device="cpu")
    pt.seed(3)
    b = LlamaForCausalLM(LlamaConfig.tiny(**TINY), device="cpu")
    for (n, x), (_, y) in zip(a.state_dict().items(),
                              b.state_dict().items()):
        assert torch.equal(x, y), n
