"""The paged engine's fixed-width prefill chunk against the JAX
package's ``prefill_chunk`` on the CPU: the two engines stepped in lock
step over the same prompts, the pools compared after every step (every
block but the scratch block, fp32, within 2e-5 + 1e-4 * |ref|: the same
projections, attention in another library) and the tokens equal.  Cases:
a prompt whose length is a multiple of the block size and one that ends
one token into a block (the final chunk's pad rows land past the
prompt), a prompt sharing full blocks with a finished one (the pads
never touch a shared block), and a final chunk whose pads run past the
RoPE table (clamped on the device, as JAX's gather clamps).  The chunk
after ``aot_warmup`` (the captured body on static buffers) leaves the
pools bitwise equal to the eager chunk's; a chunk that was not captured
raises."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as pp
from paddle_tpu.inference.serving import \
    ContinuousBatchingEngine as JEngine
from paddle_tpu.models import LlamaConfig as JLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JLlamaForCausalLM
from paddle_tpu.nn.functional import attention as JA

from paddle_tpu_torch.inference import ContinuousBatchingEngine
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.nn.functional import attention as TA

TINY = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2)
ENGINE_KW = dict(slots=2, max_len=64, prefill_buckets=(32,),
                 paged_kv=True, kv_block_size=8, prefill_chunk=12)
ATOL, RTOL = 2e-5, 1e-4


def _pair(table):
    pp.seed(0)
    jm = JLlamaForCausalLM(JLlamaConfig.tiny(max_position_embeddings=table,
                                             **TINY))
    tm = LlamaForCausalLM(LlamaConfig.tiny(max_position_embeddings=table,
                                           **TINY), device="cpu")
    tm.set_state_dict({k: v.numpy() for k, v in jm.state_dict().items()})
    return jm, tm


@pytest.fixture(scope="module")
def pair():
    return _pair(128)


@pytest.fixture(scope="module")
def pair64():
    """RoPE table 64 = max_len: a padded final chunk runs past it."""
    return _pair(64)


def _pools_close(te, je, what):
    for name in ("kpools", "vpools"):
        for layer, (t, j) in enumerate(zip(getattr(te._pool, name),
                                           getattr(je._pool, name))):
            np.testing.assert_allclose(
                t[1:].numpy(), np.asarray(j)[1:], atol=ATOL, rtol=RTOL,
                err_msg=f"{what}: {name}[{layer}]")


def _lockstep(jm, tm, phases, **over):
    """Both engines over the same phases (a list of prompt lists, each
    run to completion), pools compared after every step; returns each
    phase's tokens from both, the port engine and the chunk steps."""
    kw = dict(ENGINE_KW, **over)
    je, te = JEngine(jm, **kw), ContinuousBatchingEngine(tm, **kw)
    toks, steps = [], 0
    for prompts in phases:
        jr = [je.add_request(p, max_new_tokens=4) for p in prompts]
        tr = [te.add_request(p, max_new_tokens=4) for p in prompts]
        while te.pending or je.pending:
            chunk = bool(te._prefilling)
            je.step()
            te.step()
            steps += chunk
            _pools_close(te, je, f"step {steps}")
        jres, tres = je.run(), te.run()
        toks.append(([[int(t) for t in tres[r][1]] for r in tr],
                     [[int(t) for t in jres[r][1]] for r in jr]))
    je.close()
    return toks, te, steps


@pytest.mark.parametrize("length", [16, 17, 24, 40],
                         ids=["blocks", "one_into_a_block", "chunks",
                              "long"])
def test_chunks_match_jax(pair, length):
    prompt = np.random.default_rng(length).integers(0, 256, (length,))
    toks, te, steps = _lockstep(*pair, [[prompt]])
    assert steps == -(-length // ENGINE_KW["prefill_chunk"])
    assert toks[0][0] == toks[0][1]
    assert te.stats["prefill_chunks"] == steps
    te.close()


def test_pads_never_touch_shared_blocks(pair):
    """A finished 16-token prompt leaves its two full blocks in the trie;
    a second prompt sharing them prefills from 16 with a padded chunk:
    the shared blocks are bitwise what they were."""
    rng = np.random.default_rng(3)
    a = rng.integers(0, 256, (16,))
    b = np.concatenate([a, rng.integers(0, 256, (5,))])
    jm, tm = pair
    te = ContinuousBatchingEngine(tm, **ENGINE_KW)
    ra = te.add_request(a, max_new_tokens=4)
    te.run()
    shared = te._prefix.match(b)[:2]
    assert len(shared) == 2
    before = [p[shared].clone() for p in te._pool.kpools + te._pool.vpools]
    rb = te.add_request(b, max_new_tokens=4)
    out = te.run()
    assert te.request_status(rb).timings["prefix_tokens_reused"] == 16
    for p, was in zip(te._pool.kpools + te._pool.vpools, before):
        assert torch.equal(p[shared], was)
    toks, _, _ = _lockstep(jm, tm, [[a], [b]])
    assert [out[rb][1]] == toks[1][1] and toks[1][0] == toks[1][1]
    assert te.request_status(ra) == "ok"


def test_pads_past_the_rope_table_clamp_as_jax(pair64):
    """max_len 64 = the RoPE table, chunk 24, a 50-token prompt: the
    final chunk holds positions 48..71, the pads from 64 on past the
    table (their K/V go to the scratch block)."""
    prompt = np.random.default_rng(5).integers(0, 256, (50,))
    toks, te, steps = _lockstep(*pair64, [[prompt]], prefill_chunk=24)
    assert steps == 3
    assert toks[0][0] == toks[0][1]
    te.close()


def test_rope_clamps_per_token_positions_as_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((1, 6, 2, 8)).astype(np.float32)
    jcos, jsin = JA.rotary_freqs(8, 16)
    tcos, tsin = TA.rotary_freqs(8, 16)
    ref = JA.apply_rotary_emb(jnp.asarray(x), jcos, jsin,
                              jnp.asarray([13], jnp.int32))
    pos = torch.tensor([[13, 14, 15, 16, 17, 18]])
    got = TA.apply_rotary_emb(torch.from_numpy(x), tcos, tsin, pos)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)
    # a [B] host offset past the table still raises
    with pytest.raises(ValueError, match="RoPE table overflow"):
        TA.apply_rotary_emb(torch.from_numpy(x), tcos, tsin,
                            torch.tensor([13]))


@pytest.mark.parametrize("over", [{}, {"quant_kv": "int8"},
                                  {"quant_weights": "int8"}],
                         ids=["fp", "int8_kv", "int8_weights"])
def test_warmed_chunk_equals_eager_bitwise(pair, over):
    tm = pair[1]
    prompts = [np.random.default_rng(7).integers(0, 256, (n,))
               for n in (17, 30, 9)]
    kw = dict(ENGINE_KW, **over)
    eager = ContinuousBatchingEngine(tm, **kw)
    warm = ContinuousBatchingEngine(tm, **kw)
    assert "serving.prefill_chunk" in warm.aot_warmup()
    re = [eager.add_request(p, max_new_tokens=5) for p in prompts]
    rw = [warm.add_request(p, max_new_tokens=5) for p in prompts]
    while eager.pending or warm.pending:
        eager.step()
        warm.step()
        for a, b in zip(eager._pool.kpools + eager._pool.kscales,
                        warm._pool.kpools + warm._pool.kscales):
            assert torch.equal(a[1:], b[1:])
    oe, ow = eager.run(), warm.run()
    assert [oe[r][1] for r in re] == [ow[r][1] for r in rw]
    assert warm._graphs["serving.prefill_chunk"].inputs["ids"].shape == \
        (1, ENGINE_KW["prefill_chunk"])
    eager.close(), warm.close()
    assert getattr(tm, "_serving_quant_refs", 0) == 0


def test_a_chunk_not_captured_raises(pair):
    te = ContinuousBatchingEngine(pair[1], **ENGINE_KW)
    te.aot_warmup()
    te._graphs.pop("serving.prefill_chunk").close()
    bad = te.add_request(np.arange(1, 10), max_new_tokens=2)
    te.run()
    assert te.request_status(bad) == "error"
    with pytest.raises(RuntimeError, match="not captured"):
        te._run("serving.prefill_chunk", te._prefill_chunk_body,
                ids=np.zeros((1, 12), np.int64),
                bt=np.zeros((1, 8), np.int32),
                start=np.zeros((1,), np.int32),
                last_idx=np.array(0, np.int64))
