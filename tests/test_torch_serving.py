"""The whole slice: the PyTorch port's paged continuous-batching engine
against the JAX package's (``paged_kv=True``) on the same tiny model,
weights and prompts, on the CPU in fp32.  Greedy tokens must be
identical, with fp weights and pools and with quantized ones
(``quant_weights``, ``quant_kv``).  Plus the engine's own contract: input
checks, the bounded queue, deadlines, the quantization knobs, and the
options outside the port so far refusing loudly."""

import numpy as np
import pytest
import torch

import paddle_tpu as pp
from paddle_tpu.inference.serving import \
    ContinuousBatchingEngine as JEngine
from paddle_tpu.models import LlamaConfig as JLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JLlamaForCausalLM

from paddle_tpu_torch.inference import (ContinuousBatchingEngine,
                                        QueueFullError)
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

TINY = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=128)
ENGINE = dict(slots=2, max_len=64, prefill_buckets=(16, 32),
              kv_block_size=4, prefill_chunk=8, paged_kv=True)


@pytest.fixture(scope="module")
def pair():
    pp.seed(0)
    jm = JLlamaForCausalLM(JLlamaConfig.tiny(**TINY))
    tm = LlamaForCausalLM(LlamaConfig.tiny(**TINY), device="cpu")
    tm.set_state_dict({k: v.numpy() for k, v in jm.state_dict().items()})
    return jm, tm


def _prompts(seed, lengths, prefix=None):
    rng = np.random.default_rng(seed)
    out = []
    for n in lengths:
        p = rng.integers(0, 256, (n,))
        if prefix is not None:
            p = np.concatenate([prefix, p])
        out.append(p)
    return out


# each scenario: engine overrides, then phases of (prompts, max_new);
# a phase runs to completion before the next is submitted
_SHARED = np.random.default_rng(99).integers(0, 256, (13,))
SCENARIOS = {
    # one prompt across three prefill chunks of 8
    "chunked_prefill": ({}, [(_prompts(1, [17]), 8)]),
    # five requests through two slots: slots are reused
    "slot_reuse": ({}, [(_prompts(2, [3, 11, 6, 20, 9]), 5)]),
    # a second phase whose prompts share the first's 13-token prefix:
    # its three full blocks come from the prefix cache
    "prefix_reuse": ({}, [([_SHARED], 4),
                          (_prompts(3, [2, 7], prefix=_SHARED), 6)]),
    # three decode steps per host interaction
    "steps_per_sync": ({"steps_per_sync": 3}, [(_prompts(4, [5, 12]), 7)]),
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_greedy_tokens_match_jax_engine(pair, scenario):
    jm, tm = pair
    over, phases = SCENARIOS[scenario]
    kw = dict(ENGINE, **over)
    je = JEngine(jm, **kw)
    te = ContinuousBatchingEngine(tm, **kw)
    reused = 0
    for prompts, max_new in phases:
        jr = [je.add_request(p, max_new_tokens=max_new) for p in prompts]
        tr = [te.add_request(p, max_new_tokens=max_new) for p in prompts]
        jout, tout = je.run(), te.run()
        for a, b in zip(jr, tr):
            assert te.request_status(b) == "ok"
            assert len(tout[b][1]) == max_new
            assert [int(t) for t in tout[b][1]] == \
                [int(t) for t in jout[a][1]]
            reused += te.request_status(b).timings["prefix_tokens_reused"]
    if scenario == "prefix_reuse":
        assert reused == 2 * 12   # 3 blocks of 4 for each later request


# quantized serving: engine options, then phases as above.  The tiny
# config converts q, o, gate, up, down and lm_head (k/v stay fp: 2048
# elements < 4096), so the decoder layers take the mixed routing
QUANT_SCENARIOS = {
    "int8_weights": ({"quant_weights": "int8"},
                     [(_prompts(5, [17, 6, 11]), 6)]),
    "fp8_weights": ({"quant_weights": "fp8"},
                    [(_prompts(6, [9, 14]), 6)]),
    "int8_kv": ({"quant_kv": "int8"}, [(_prompts(7, [17, 4, 12]), 6)]),
    "int8_both_prefix_reuse": (
        {"quant_weights": "int8", "quant_kv": "int8"},
        [([_SHARED], 4), (_prompts(3, [2, 7], prefix=_SHARED), 6)]),
}


@pytest.mark.parametrize("scenario", sorted(QUANT_SCENARIOS))
def test_quantized_greedy_tokens_match_jax_engine(pair, scenario):
    jm, tm = pair
    over, phases = QUANT_SCENARIOS[scenario]
    kw = dict(ENGINE, **over)
    je = JEngine(jm, **kw)
    te = ContinuousBatchingEngine(tm, **kw)
    try:
        assert te._num_blocks == je._num_blocks
        assert (te.quant_mode, te.kv_quant) == (je.quant_mode, je.kv_quant)
        reused = 0
        for prompts, max_new in phases:
            jr = [je.add_request(p, max_new_tokens=max_new) for p in prompts]
            tr = [te.add_request(p, max_new_tokens=max_new) for p in prompts]
            jout, tout = je.run(), te.run()
            for a, b in zip(jr, tr):
                assert te.request_status(b) == "ok"
                assert len(tout[b][1]) == max_new
                assert [int(t) for t in tout[b][1]] == \
                    [int(t) for t in jout[a][1]]
                reused += te.request_status(b).timings[
                    "prefix_tokens_reused"]
        if "prefix" in scenario:
            assert reused == 2 * 12
    finally:
        je.close()
        te.close()
    assert getattr(tm, "_serving_quant_refs", 0) == 0


@pytest.mark.parametrize("dtype,ratio", [("float32", 4), ("bfloat16", 2)])
def test_int8_pool_holds_itemsize_times_the_blocks(pair, dtype, ratio):
    """At the same payload bytes an int8 pool holds 4x the blocks of an
    fp32 pool and 2x of a bf16 one (the JAX engine's count for fp32)."""
    tm = pair[1] if dtype == "float32" else \
        LlamaForCausalLM(LlamaConfig.tiny(**TINY, dtype=dtype), device="cpu")
    base = ContinuousBatchingEngine(tm, **ENGINE)
    quant = ContinuousBatchingEngine(tm, quant_kv="int8", **ENGINE)
    assert quant._num_blocks - 1 == ratio * (base._num_blocks - 1)
    assert quant._pool.kpools[0].dtype == torch.int8
    assert quant._pool.kscales[0].shape == (quant._num_blocks, 4, 2)

    def payload(e):
        return sum(p.numel() * p.element_size() // e._num_blocks
                   * (e._num_blocks - 1)
                   for p in e._pool.kpools + e._pool.vpools)
    assert payload(quant) == payload(base)
    if dtype == "float32":
        je = JEngine(pair[0], quant_kv="int8", **ENGINE)
        assert je._num_blocks == quant._num_blocks


def test_engines_share_one_conversion_and_close_restores(pair):
    from paddle_tpu_torch.quantization import QuantedLinear
    tm = pair[1]
    a = ContinuousBatchingEngine(tm, quant_weights="int8", **ENGINE)
    b = ContinuousBatchingEngine(tm, quant_weights="int8", **ENGINE)
    assert isinstance(tm.lm_head, QuantedLinear)
    assert tm._serving_quant_refs == 2
    a.close()
    assert isinstance(tm.lm_head, QuantedLinear)
    with b:
        pass
    assert tm._serving_quant_refs == 0
    assert "lm_head.weight" in tm.state_dict()
    b.close()                                 # a second close is harmless
    assert tm._serving_quant_refs == 0


@pytest.mark.parametrize("kwargs,match", [
    ({"quant_kv": "int8", "paged_kv": False}, "paged KV"),
    ({"quant_weights": "int8", "int8_weights": True}, "mutually exclusive"),
    ({"quant_weights": "int4"}, "int8|fp8"),
    ({"quant_kv": "fp8"}, "only int8"),
])
def test_quant_options_are_validated(pair, kwargs, match):
    with pytest.raises(ValueError, match=match):
        ContinuousBatchingEngine(pair[1], **dict(ENGINE, **kwargs))
    assert getattr(pair[1], "_serving_quant_refs", 0) == 0


def test_quant_env_knobs_reach_the_engine(pair, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_QUANT_WEIGHTS", "fp8")
    monkeypatch.setenv("PADDLE_TPU_QUANT_KV", "int8")
    with ContinuousBatchingEngine(pair[1], **ENGINE) as te:
        assert (te.quant_mode, te.kv_quant) == ("fp8", "int8")
        assert pair[1].lm_head.qweight.dtype == torch.float8_e4m3fn
    assert getattr(pair[1], "_serving_quant_refs", 0) == 0


def test_empty_prompt_raises(pair):
    te = ContinuousBatchingEngine(pair[1], **ENGINE)
    with pytest.raises(ValueError, match="empty prompt"):
        te.add_request([], max_new_tokens=4)


@pytest.mark.parametrize("prompt_len,max_new", [(60, 4), (10, 54)])
def test_request_past_max_len_raises(pair, prompt_len, max_new):
    te = ContinuousBatchingEngine(pair[1], **ENGINE)
    with pytest.raises(ValueError, match="max_len"):
        te.add_request(np.ones(prompt_len, np.int32),
                       max_new_tokens=max_new)


def test_bounded_queue_rejects(pair):
    te = ContinuousBatchingEngine(pair[1], max_queue=1, **ENGINE)
    te.add_request([1, 2, 3], max_new_tokens=2)
    with pytest.raises(QueueFullError):
        te.add_request([4, 5, 6], max_new_tokens=2)


def test_deadline_retires_with_timeout(pair):
    te = ContinuousBatchingEngine(pair[1], **ENGINE)
    late = te.add_request([1, 2, 3], max_new_tokens=2, timeout_s=0.0)
    ok = te.add_request([4, 5, 6], max_new_tokens=2)
    out = te.run()
    assert te.request_status(late) == "timeout" and out[late][1] == []
    assert te.request_status(ok) == "ok" and len(out[ok][1]) == 2
    t = te.request_status(ok).timings
    assert t["ttft_s"] > 0 and t["generated"] == 2


@pytest.mark.parametrize("kwargs", [{"int8_weights": True},
                                    {"analyze": "warn"}])
def test_unported_engine_options_raise(pair, kwargs):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ContinuousBatchingEngine(pair[1], **dict(ENGINE, **kwargs))


@pytest.mark.parametrize("method", ["analyze"])
def test_unported_engine_methods_raise(pair, method):
    te = ContinuousBatchingEngine(pair[1], **ENGINE)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        getattr(te, method)(0)


def test_engine_follows_the_model_device(pair):
    te = ContinuousBatchingEngine(pair[1], **ENGINE)
    assert te._pool.kpools[0].device.type == "cpu"
    assert te._pool.kpools[0].dtype == torch.float32


# -- host bookkeeping, copied from the JAX package ---------------------------

def _bookkeeping(mod):
    """The same allocator / copy-on-write / prefix-trie story on either
    package's kv_cache module; returns every observable along the way."""
    seen = []
    alloc = mod.BlockAllocator(8)
    a = mod.SequenceBlocks(alloc, 4)
    seen += [a.ensure_capacity(10), list(a.bids), a.capacity]
    b = a.fork()
    copies = []
    seen += [b.ensure_writable(1, lambda s, d: copies.append((s, d))),
             list(b.bids), copies, b.ensure_writable(1), alloc.free_blocks]
    seen.append(a.ensure_capacity(40))          # all-or-nothing refusal
    cache = mod.PrefixCache(4, alloc)
    seen += [cache.register(np.arange(12), a.bids, limit_tokens=12),
             cache.match(np.arange(10)), cache.match(np.arange(50, 60)),
             len(cache)]
    a.release()
    b.release()
    seen += [alloc.free_blocks, cache.evict(5), alloc.free_blocks,
             alloc.used_blocks, cache.hits, cache.misses, cache.evictions]
    return seen


def test_block_bookkeeping_matches_jax():
    from paddle_tpu.inference import kv_cache as jkv
    from paddle_tpu_torch.inference import kv_cache as tkv
    assert _bookkeeping(tkv) == _bookkeeping(jkv)


@pytest.mark.parametrize("case", ["double_free", "scratch", "unallocated"])
def test_allocator_refuses_misuse(case):
    from paddle_tpu_torch.inference.kv_cache import BlockAllocator
    alloc = BlockAllocator(4)
    bid = alloc.alloc()
    with pytest.raises(RuntimeError):
        if case == "double_free":
            alloc.free(bid)
            alloc.free(bid)
        elif case == "scratch":
            alloc.free(0)
        else:
            alloc.ref(3)


def test_pool_copy_block_and_reset():
    from paddle_tpu_torch.inference.kv_cache import PagedKVPool
    pool = PagedKVPool(2, 6, 4, 2, 8, torch.float32, "cpu")
    for p in pool.kpools + pool.vpools:
        p.copy_(torch.randn(p.shape))
    pool.copy_block(2, 5)
    for p in pool.kpools + pool.vpools:
        assert torch.equal(p[5], p[2])
    assert pool.cow_copies == 1 and pool.nbytes == 4 * 6 * 4 * 2 * 8 * 4
    pool.reset()
    assert all(not p.any() for p in pool.kpools + pool.vpools)


# -- sampling ------------------------------------------------------------------

@pytest.mark.parametrize("cfg", [dict(top_k=1), dict(top_p=1e-6),
                                 dict(temperature=1e-4)])
def test_sampling_collapses_to_greedy(cfg):
    from paddle_tpu_torch.generation import GenerationConfig, _sample
    logits = torch.randn(4, 50, generator=torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    got = _sample(logits, GenerationConfig(do_sample=True, **cfg), g)
    assert torch.equal(got, torch.argmax(logits, dim=-1))


def test_sampling_is_seeded_and_follows_the_distribution():
    from paddle_tpu_torch.generation import GenerationConfig, _sample
    logits = torch.log(torch.tensor([[0.7, 0.2, 0.1]])).repeat(4000, 1)
    cfg = GenerationConfig(do_sample=True)
    a = _sample(logits, cfg, torch.Generator().manual_seed(5))
    b = _sample(logits, cfg, torch.Generator().manual_seed(5))
    assert torch.equal(a, b)
    freq = torch.bincount(a, minlength=3).float() / len(a)
    assert torch.allclose(freq, torch.tensor([0.7, 0.2, 0.1]), atol=0.03)


def test_sampled_engine_with_top_k_1_matches_jax_greedy(pair):
    jm, tm = pair
    prompts = _prompts(8, [9, 14])
    je = JEngine(jm, **ENGINE)
    te = ContinuousBatchingEngine(tm, do_sample=True, top_k=1, seed=3,
                                  **ENGINE)
    jr = [je.add_request(p, max_new_tokens=5) for p in prompts]
    tr = [te.add_request(p, max_new_tokens=5) for p in prompts]
    jout, tout = je.run(), te.run()
    for a, b in zip(jr, tr):
        assert [int(t) for t in tout[b][1]] == [int(t) for t in jout[a][1]]
