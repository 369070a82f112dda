"""The serving engine's other paths against the JAX package's on the CPU:
the slot-contiguous engine (``paged_kv=False``) against
``JEngine(paged_kv=False)``, n-gram speculative decoding against
``JEngine(paged_kv=True, spec_decode=k)`` (tokens and each request's
proposed and accepted drafts; the proposer against JAX's on constructed
histories), and ``aot_warmup``: on the CPU it binds each decode program
to static buffers without a graph, and the tokens must equal the eager
port's and JAX's, for both engines, quantized, sampled (against an eager
engine of the same seed) and after ``_recover``.  Plus the
``PADDLE_TPU_PAGED_KV`` default, the option checks and a program that
was not captured raising.  Tiny fp32 Llama, weights copied from the JAX
model; greedy tokens must be identical."""

import numpy as np
import pytest
import torch

import paddle_tpu as pp
from paddle_tpu.inference import serving as jserving
from paddle_tpu.models import LlamaConfig as JLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JLlamaForCausalLM

from paddle_tpu_torch.inference import ContinuousBatchingEngine
from paddle_tpu_torch.inference import serving as tserving
from paddle_tpu_torch.jit.static_graph import StaticGraph
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

TINY = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=128)
SLOT = dict(slots=2, max_len=64, prefill_buckets=(8, 16, 32),
            paged_kv=False)
PAGED = dict(slots=2, max_len=64, prefill_buckets=(16, 32),
             kv_block_size=4, prefill_chunk=8, paged_kv=True)


class _JEngine(jserving.ContinuousBatchingEngine):
    """The JAX engine, keeping each request's (proposed, accepted)."""

    def _finish(self, req, slot=None, status="ok"):
        self.spec_counts = getattr(self, "spec_counts", {})
        self.spec_counts[req.rid] = (req.spec_proposed, req.spec_accepted)
        return super()._finish(req, slot=slot, status=status)


@pytest.fixture(scope="module")
def pair():
    pp.seed(0)
    jm = JLlamaForCausalLM(JLlamaConfig.tiny(**TINY))
    tm = LlamaForCausalLM(LlamaConfig.tiny(**TINY), device="cpu")
    tm.set_state_dict({k: v.numpy() for k, v in jm.state_dict().items()})
    return jm, tm


_JAX_RUNS = {}


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (n,)) for n in lengths]


def _serve(eng, prompts, max_new):
    rids = [eng.add_request(p, max_new_tokens=max_new) for p in prompts]
    out = eng.run()
    return rids, [[int(t) for t in out[r][1]] for r in rids]


def _jax(jm, name, kw, prompts, max_new):
    """The JAX engine's tokens and spec counts, once a scenario."""
    if name not in _JAX_RUNS:
        je = _JEngine(jm, **kw)
        rids, toks = _serve(je, prompts, max_new)
        je.close()
        counts = getattr(je, "spec_counts", {})
        _JAX_RUNS[name] = (toks, [counts.get(r) for r in rids])
    return _JAX_RUNS[name]


# -- the slot-contiguous engine ----------------------------------------------

SLOT_SCENARIOS = {
    # five requests through two slots: slots are reused
    "slot_reuse": ({}, _prompts(2, [3, 11, 6, 20, 9]), 5),
    # prompts at a bucket's edge and one past it: exact and padded
    "bucket_padding": ({}, _prompts(3, [8, 9, 16, 17, 32]), 4),
    # three decode steps a program
    "steps_per_sync": ({"steps_per_sync": 3}, _prompts(4, [5, 12, 30]), 7),
    # weight-only quantized Linears on the slot engine
    "int8_weights": ({"quant_weights": "int8"}, _prompts(10, [7, 20]), 5),
}


@pytest.mark.parametrize("warm", ["eager", "aot_warmup"])
@pytest.mark.parametrize("scenario", sorted(SLOT_SCENARIOS))
def test_slot_engine_tokens_match_jax(pair, scenario, warm):
    jm, tm = pair
    over, prompts, max_new = SLOT_SCENARIOS[scenario]
    kw = dict(SLOT, **over)
    ref, _ = _jax(jm, "slot/" + scenario, kw, prompts, max_new)
    with ContinuousBatchingEngine(tm, **kw) as te:
        assert not te.paged
        if warm == "aot_warmup":
            stats = te.aot_warmup()
            assert set(stats) == {"serving.decode", "serving.insert",
                                  "serving.prefill[8]",
                                  "serving.prefill[16]",
                                  "serving.prefill[32]"}
            assert not any(s["graph"] for s in stats.values())  # the CPU
        rids, toks = _serve(te, prompts, max_new)
        assert toks == ref
        assert all(te.request_status(r) == "ok" for r in rids)
        assert all(len(t) == max_new for t in toks)
    assert getattr(tm, "_serving_quant_refs", 0) == 0


def test_slot_engine_refuses_a_prompt_past_the_largest_bucket(pair):
    te = ContinuousBatchingEngine(pair[1], **SLOT)
    with pytest.raises(ValueError, match="largest prefill bucket"):
        te.add_request(np.ones(33, np.int32), max_new_tokens=2)


def test_a_program_not_captured_raises(pair):
    """Warmed with the 16-token bucket only, a 20-token prompt needs
    ``serving.prefill[32]``: the step raises and the request fails, the
    engine runs on and a 12-token prompt still serves."""
    te = ContinuousBatchingEngine(pair[1], **SLOT)
    assert set(te.aot_warmup(buckets=(16,))) == {
        "serving.decode", "serving.insert", "serving.prefill[16]"}
    bad = te.add_request(np.ones(20, np.int32), max_new_tokens=2)
    good = te.add_request(np.ones(12, np.int32), max_new_tokens=2)
    te.run()
    assert te.request_status(bad) == "error"
    assert te.request_status(good) == "ok"
    with pytest.raises(RuntimeError, match="not captured"):
        te._run("serving.prefill[32]", te._prefill_slot_body,
                ids=np.zeros((1, 32), np.int64),
                true_len=np.array(20, np.int64))


# -- n-gram speculative decoding ---------------------------------------------

def _spec_prompts(tm, seed):
    """A prompt that repeats its own start after the model's greedy
    continuation of it (so the drafts find matches), and a random one."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (5,))
    cont = tm.generate(base[None], max_new_tokens=10)[0]
    return [np.concatenate([cont, base]), rng.integers(0, 256, (9,))]


@pytest.mark.parametrize("warm", ["eager", "aot_warmup"])
@pytest.mark.parametrize("seed,k", [(0, 3), (2, 3), (4, 2)])
def test_spec_decode_tokens_and_acceptance_match_jax(pair, seed, k, warm):
    jm, tm = pair
    prompts = _spec_prompts(tm, seed)
    kw = dict(PAGED, spec_decode=k)
    ref, counts = _jax(jm, f"spec/{seed}/{k}", kw, prompts, 12)
    te = ContinuousBatchingEngine(tm, **kw)
    if warm == "aot_warmup":
        assert set(te.aot_warmup()) == {"serving.decode",
                                        "serving.prefill_chunk",
                                        "serving.spec_verify"}
    rids, toks = _serve(te, prompts, 12)
    assert toks == ref
    got = [(int(te.request_status(r).timings["spec_proposed"]),
            int(te.request_status(r).timings["spec_accepted"]))
           for r in rids]
    assert got == counts
    assert sum(a for _, a in got) > 0        # some drafts were accepted
    assert te.stats["spec_accepted"] == sum(a for _, a in got)


HISTORIES = {
    "repeat_tail": [1, 2, 3, 9, 1, 2, 3, 7, 1, 2, 3],
    "constant": [5, 5, 5, 5, 5],
    "no_match": [1, 2, 3, 4],
    "one_token": [7],
    "short_cont": [4, 8, 1, 4, 8],
    "periodic": list(np.arange(20) % 6),
}


@pytest.mark.parametrize("k,max_n", [(1, 3), (3, 3), (4, 1)])
@pytest.mark.parametrize("name", sorted(HISTORIES))
def test_ngram_proposer_is_jaxs(name, k, max_n):
    h = np.asarray(HISTORIES[name], np.int32)
    ref = jserving._ngram_propose(h, k, max_n)
    got = tserving._ngram_propose(h, k, max_n)
    if ref is None:
        assert got is None
    else:
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("kwargs,match", [
    ({"spec_decode": 2, "paged_kv": False}, "paged KV"),
    ({"spec_decode": 2, "do_sample": True}, "greedy-only"),
])
def test_spec_options_are_validated(pair, kwargs, match):
    with pytest.raises(ValueError, match=match):
        ContinuousBatchingEngine(pair[1], **dict(PAGED, **kwargs))


# -- aot_warmup on the paged engine --------------------------------------------

PAGED_SCENARIOS = {
    "bf16_pools": ({}, _prompts(5, [17, 3, 9]), 6),
    "steps_per_sync": ({"steps_per_sync": 3}, _prompts(6, [5, 12]), 7),
    "int8_both": ({"quant_weights": "int8", "quant_kv": "int8"},
                  _prompts(7, [17, 4, 12]), 6),
}


@pytest.mark.parametrize("scenario", sorted(PAGED_SCENARIOS))
def test_paged_aot_warmup_matches_eager_and_jax(pair, scenario):
    jm, tm = pair
    over, prompts, max_new = PAGED_SCENARIOS[scenario]
    kw = dict(PAGED, **over)
    ref, _ = _jax(jm, "paged/" + scenario, kw, prompts, max_new)
    toks = {}
    for warm in (False, True):
        with ContinuousBatchingEngine(tm, **kw) as te:
            if warm:
                assert set(te.aot_warmup()) == {"serving.decode",
                                                "serving.prefill_chunk"}
            toks[warm] = _serve(te, prompts, max_new)[1]
        assert not te._graphs                 # close() dropped them
    assert toks[True] == toks[False] == ref
    assert getattr(tm, "_serving_quant_refs", 0) == 0


@pytest.mark.parametrize("engine", [PAGED, SLOT], ids=["paged", "slot"])
def test_sampled_warmed_engine_matches_eager_of_one_seed(pair, engine):
    prompts = _prompts(8, [9, 14, 4])
    kw = dict(engine, do_sample=True, temperature=1.3, top_k=40, seed=5)
    toks = []
    for warm in (False, True):
        te = ContinuousBatchingEngine(pair[1], **kw)
        if warm:
            te.aot_warmup()
        toks.append(_serve(te, prompts, 6)[1])
    assert toks[0] == toks[1]


@pytest.mark.parametrize("engine", [PAGED, SLOT], ids=["paged", "slot"])
def test_recovered_warmed_engine_matches_jax(pair, engine, monkeypatch):
    """A decode whose host accounting fails after the program wrote the
    caches: the batch retires "error", the caches are zeroed in place,
    and the same prompts then give JAX's tokens through the same
    programs."""
    jm, tm = pair
    prompts = _prompts(9, [6, 13])
    name = "recover/" + ("paged" if engine["paged_kv"] else "slot")
    ref, _ = _jax(jm, name, engine, prompts, 5)
    te = ContinuousBatchingEngine(tm, **engine)
    te.aot_warmup()
    graphs = dict(te._graphs)
    real = te._account_decode
    calls = []

    def fail_once(*args):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("injected")
        return real(*args)
    monkeypatch.setattr(te, "_account_decode", fail_once)
    first = [te.add_request(p, max_new_tokens=5) for p in prompts]
    te.run()
    assert [te.request_status(r) for r in first] == ["error", "error"]
    assert te._graphs == graphs
    _, toks = _serve(te, prompts, 5)
    assert toks == ref


# -- the knobs ---------------------------------------------------------------

@pytest.mark.parametrize("env", [None, "0", "1", "true"])
def test_paged_kv_none_follows_the_env_as_jax(pair, env, monkeypatch):
    if env is None:
        monkeypatch.delenv("PADDLE_TPU_PAGED_KV", raising=False)
    else:
        monkeypatch.setenv("PADDLE_TPU_PAGED_KV", env)
    kw = dict(slots=2, max_len=64, prefill_buckets=(16, 32))
    je = jserving.ContinuousBatchingEngine(pair[0], **kw)
    te = ContinuousBatchingEngine(pair[1], **kw)
    assert te.paged == je.paged == (env in ("1", "true"))


def test_cache_only_warmup_names_the_roadmap(pair):
    te = ContinuousBatchingEngine(pair[1], **PAGED)
    with pytest.raises(NotImplementedError, match="item 9"):
        te.aot_warmup(cache_only=True)


def test_static_graph_binds_its_buffers_and_refuses_other_shapes():
    g = StaticGraph(lambda x: x * 2, {"x": torch.zeros(3)}, "double")
    assert g.graph is None and g.launches == {}
    assert torch.equal(g(x=np.ones(3, np.float32)), torch.full((3,), 2.0))
    with pytest.raises(ValueError, match="captured as"):
        g(x=np.ones(4, np.float32))
    with pytest.raises(ValueError, match="captured as"):
        g(x=np.ones(3, np.float64))
    g.close()
    with pytest.raises(RuntimeError, match="closed"):
        g(x=np.ones(3, np.float32))
