"""``generate()`` and the static cache of the PyTorch port against the JAX
package on the CPU: ``LlamaForCausalLM.generate`` and
``GPTForCausalLM.generate`` greedy tokens equal the JAX package's (a
batch, a forced EOS with its pad, one new token, a 1-d prompt), the run
cache (reused at one shape, least recently used out), the sampler's
seed, the checks, and ``static_cache_attention`` in both branches with a
boolean and an additive mask, within 1e-5 of JAX's.  The tiny configs
are fp32 and the weights are copied from the JAX models as numpy
arrays; inputs come from ``numpy.random.default_rng``.  On the CPU the
per-token step is the graph's body on its static buffers; the captured
graph is held on the card (``test_torch_cuda.py``)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as pp
from paddle_tpu import generation as jgen
from paddle_tpu.models import GPTConfig as JGPTConfig
from paddle_tpu.models import GPTForCausalLM as JGPTForCausalLM
from paddle_tpu.models import LlamaConfig as JLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JLlamaForCausalLM

from paddle_tpu_torch import generation as tgen
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM, LlamaConfig,
                                     LlamaForCausalLM)
from paddle_tpu_torch.nn import functional as TF

TINY = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=128)


@pytest.fixture(scope="module")
def models():
    pp.seed(0)
    jl = JLlamaForCausalLM(JLlamaConfig.tiny(**TINY))
    tl = LlamaForCausalLM(LlamaConfig.tiny(**TINY), device="cpu")
    tl.set_state_dict({k: v.numpy() for k, v in jl.state_dict().items()})
    pp.seed(1)
    jg = JGPTForCausalLM(JGPTConfig.tiny())
    tg = GPTForCausalLM(GPTConfig.tiny(), device="cpu")
    tg.set_state_dict({k: v.numpy() for k, v in jg.state_dict().items()})
    return {"llama": (jl, tl), "gpt": (jg, tg)}


def _ids(seed, b, n):
    return np.random.default_rng(seed).integers(0, 256, (b, n))


# each case: prompt ids, then generate()'s keyword arguments
CASES = {
    "greedy_batch": (_ids(0, 3, 7), dict(max_new_tokens=6)),
    "one_new_token": (_ids(1, 2, 5), dict(max_new_tokens=1)),
    "one_row_1d": (_ids(2, 1, 9)[0], dict(max_new_tokens=4)),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("arch", ["llama", "gpt"])
def test_greedy_tokens_match_jax(models, arch, case):
    jm, tm = models[arch]
    ids, kw = CASES[case]
    ref = np.asarray(jm.generate(ids, **kw))
    got = tm.generate(ids, **kw)
    assert got.dtype == np.int32
    assert got.shape == ref.shape == (np.atleast_2d(ids).shape[0],
                                      np.atleast_2d(ids).shape[1]
                                      + kw["max_new_tokens"])
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("arch", ["llama", "gpt"])
def test_forced_eos_emitted_then_pad(models, arch):
    """The EOS id is row 0's second generated token (found from a plain
    run): the row emits it verbatim where it first appears and pads
    after it, as in the JAX package."""
    jm, tm = models[arch]
    ids = _ids(3, 2, 6)
    plain = tm.generate(ids, max_new_tokens=6)
    eos = int(plain[0, 7])
    kw = dict(max_new_tokens=6, eos_token_id=eos, pad_token_id=7)
    got = tm.generate(ids, **kw)
    np.testing.assert_array_equal(got, np.asarray(jm.generate(ids, **kw)))
    at = 6 + int(np.argmax(plain[0, 6:] == eos))
    assert got[0, at] == eos and (got[0, at + 1:] == 7).all()
    assert (got[0, :at] == plain[0, :at]).all()


def test_eos_as_the_first_token(models):
    jm, tm = models["llama"]
    ids = _ids(4, 2, 5)
    eos = int(tm.generate(ids, max_new_tokens=1)[1, -1])
    kw = dict(max_new_tokens=4, eos_token_id=eos, pad_token_id=0)
    got = tm.generate(ids, **kw)
    np.testing.assert_array_equal(got, np.asarray(jm.generate(ids, **kw)))
    assert got[1, 5] == eos and (got[1, 6:] == 0).all()


def test_run_cache_reused_at_one_shape_and_bounded(models, monkeypatch):
    _, tm = models["llama"]
    tgen._RUN_CACHE.pop(tm, None)
    a = tm.generate(_ids(5, 2, 6), max_new_tokens=3)
    b = tm.generate(_ids(5, 2, 6), max_new_tokens=3)
    info = tgen.run_cache_info(tm)
    assert len(info) == 1 and info[0]["calls"] == 2
    assert not info[0]["graph"] and info[0]["replays"] == 0   # the CPU
    np.testing.assert_array_equal(a, b)
    monkeypatch.setattr(tgen, "_RUN_CACHE_MAX_PER_MODEL", 2)
    tm.generate(_ids(6, 2, 7), max_new_tokens=3)
    tm.generate(_ids(5, 2, 6), max_new_tokens=3)    # back to the front
    tm.generate(_ids(7, 1, 4), max_new_tokens=3)    # evicts the 7-token run
    assert [(r["batch"], r["prompt"]) for r in tgen.run_cache_info(tm)] \
        == [(2, 6), (1, 4)]


def test_sampling_is_seeded_and_top_k_1_is_greedy(models):
    _, tm = models["llama"]
    ids = _ids(8, 2, 5)
    kw = dict(max_new_tokens=5, do_sample=True, temperature=1.5)
    a = tm.generate(ids, seed=3, **kw)
    np.testing.assert_array_equal(a, tm.generate(ids, seed=3, **kw))
    assert not np.array_equal(a, tm.generate(ids, seed=4, **kw))
    np.testing.assert_array_equal(
        tm.generate(ids, max_new_tokens=5, do_sample=True, top_k=1),
        tm.generate(ids, max_new_tokens=5))


def test_generate_restores_train_mode(models):
    _, tm = models["gpt"]
    tm.train()
    try:
        tm.generate(_ids(9, 1, 4), max_new_tokens=2)
        assert tm.training
    finally:
        tm.eval()


@pytest.mark.parametrize("kw,match", [
    (dict(max_new_tokens=0), "max_new_tokens"),
    (dict(max_new_tokens=120), "position table"),
])
def test_generate_refuses(models, kw, match):
    with pytest.raises(ValueError, match=match):
        models["llama"][1].generate(_ids(10, 1, 10), **kw)


# -- static_cache_attention, both branches ------------------------------------

def _mask(kind, shape, rng):
    if kind == "none":
        return None
    if kind == "bool":
        return rng.random(shape) > 0.3
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("mask", ["none", "bool", "additive"])
@pytest.mark.parametrize("branch", ["rows", "offset_int", "offset_0d"])
def test_static_cache_attention_matches_jax(branch, mask):
    """Per-row ``[B]`` positions at s = 1 (a row scatter) and one offset
    for every row (an int, or a 0-d tensor) at s = 3 (a slice write);
    the returned cache and the output within 1e-5 of JAX's."""
    rng = np.random.default_rng(11)
    B, T, h, kvh, hd = 3, 12, 4, 2, 8
    s = 1 if branch == "rows" else 3
    q = rng.standard_normal((B, s, h, hd)).astype(np.float32)
    k, v = (rng.standard_normal((B, s, kvh, hd)).astype(np.float32)
            for _ in range(2))
    ck, cv = (rng.standard_normal((B, T, kvh, hd)).astype(np.float32)
              for _ in range(2))
    am = _mask(mask, (B, 1, s, T), rng)
    if branch == "rows":
        jpos = jnp.asarray([0, 5, 11], jnp.int32)
        tpos = torch.tensor([0, 5, 11], dtype=torch.int32)
    else:
        jpos = 4
        tpos = 4 if branch == "offset_int" else torch.tensor(4)
    jout, jc = jgen.static_cache_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jgen.StaticCache(jnp.asarray(ck), jnp.asarray(cv)), jpos,
        None if am is None else jnp.asarray(am))
    cache = tgen.StaticCache(torch.from_numpy(ck.copy()),
                             torch.from_numpy(cv.copy()))
    tout, tc = tgen.static_cache_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        cache, tpos, None if am is None else torch.from_numpy(am))
    jraw = np.asarray(getattr(jout, "_data", jout))
    np.testing.assert_allclose(tout.numpy(), jraw, rtol=1e-5, atol=1e-5)
    for got, ref in ((tc.k, jc.k), (tc.v, jc.v)):
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(getattr(ref, "_data", ref)),
                                   rtol=1e-5, atol=1e-5)
    assert tc.k is cache.k        # written in place


def test_static_cache_refuses():
    z = torch.zeros
    cache = tgen.StaticCache(z(1, 6, 1, 4), z(1, 6, 1, 4))
    with pytest.raises(ValueError, match="seq==1"):
        tgen.static_cache_attention(z(1, 2, 1, 4), z(1, 2, 1, 4),
                                    z(1, 2, 1, 4), cache,
                                    torch.tensor([0]))
    with pytest.raises(ValueError, match="outside the static cache"):
        tgen.static_cache_attention(z(1, 2, 1, 4), z(1, 2, 1, 4),
                                    z(1, 2, 1, 4), cache, 5)


# -- RoPE at device-resident positions ---------------------------------------

def test_rope_takes_a_0d_offset_and_checks_host_tensors():
    cos, sin = TF.rotary_freqs(8, 16)
    x = torch.randn(2, 3, 2, 8, generator=torch.Generator().manual_seed(0))
    ref = TF.apply_rotary_emb(x, cos, sin, 5)
    assert torch.equal(TF.apply_rotary_emb(x, cos, sin, torch.tensor(5)),
                       ref)
    rows = TF.apply_rotary_emb(x, cos, sin, torch.tensor([5, 5]))
    assert torch.equal(rows, ref)
    for off in (torch.tensor(14), torch.tensor([0, 14]),
                torch.tensor([-1, 0])):
        with pytest.raises(ValueError, match="RoPE table overflow"):
            TF.apply_rotary_emb(x, cos, sin, off)
