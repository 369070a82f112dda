"""Llama's concatenated ``(k, v)`` cache against the JAX package's, on the
CPU in fp32 with copied weights: a prefill from empty caches (or from a
cache-free prompt's), then one-token and multi-token steps; logits and
the returned caches within 2e-5, and the steps equal to a cache-free
forward over the whole sequence."""

import numpy as np
import pytest
import torch

import paddle_tpu as pp
from paddle_tpu.models import LlamaConfig as JLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JLlamaForCausalLM

from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

TOL = 2e-5


@pytest.fixture(scope="module", params=["gqa", "mha"])
def pair(request):
    over = {"num_key_value_heads": 2 if request.param == "gqa" else 4}
    pp.seed(0)
    jm = JLlamaForCausalLM(JLlamaConfig.tiny(**over))
    tm = LlamaForCausalLM(LlamaConfig.tiny(**over), device="cpu")
    tm.set_state_dict({k: v.numpy() for k, v in jm.state_dict().items()})
    return jm, tm


def _empty(cfg, b):
    z = np.zeros((b, 0, cfg.num_key_value_heads, cfg.head_dim), np.float32)
    return z


@pytest.mark.parametrize("steps", [[7, 1, 1], [5, 3, 2]])
def test_cache_steps_match_jax(pair, steps):
    """Each step's logits and the grown caches within 2e-5 of JAX's
    (chunks of several tokens keep ``is_causal`` with the tril offset by
    sk - sq, as JAX's)."""
    jm, tm = pair
    cfg = tm.config
    b = 2
    ids = np.random.default_rng(sum(steps)).integers(
        0, cfg.vocab_size, (b, sum(steps)))
    z = _empty(cfg, b)
    jc = [(pp.to_tensor(z), pp.to_tensor(z))
          for _ in range(cfg.num_hidden_layers)]
    tc = [(torch.from_numpy(z), torch.from_numpy(z))
          for _ in range(cfg.num_hidden_layers)]
    pos = 0
    with torch.no_grad():
        for n in steps:
            x = ids[:, pos:pos + n]
            jl, jc = jm(pp.to_tensor(x.astype(np.int32)), caches=jc,
                        position_offset=pos)
            tl, tc = tm(torch.from_numpy(x), caches=tc, position_offset=pos)
            pos += n
            np.testing.assert_allclose(tl.numpy(), jl.numpy(), rtol=0,
                                       atol=TOL)
            for (jk, jv), (tk, tv) in zip(jc, tc):
                assert tuple(tk.shape) == (b, pos, cfg.num_key_value_heads,
                                           cfg.head_dim)
                np.testing.assert_allclose(tk.numpy(), jk.numpy(), rtol=0,
                                           atol=TOL)
                np.testing.assert_allclose(tv.numpy(), jv.numpy(), rtol=0,
                                           atol=TOL)


def test_cache_steps_equal_full_forward(pair):
    """Prefill then single tokens through the cache: the logits at each
    position within 2e-5 of one cache-free forward over the sequence."""
    tm = pair[1]
    cfg = tm.config
    ids = torch.as_tensor(np.random.default_rng(9).integers(
        0, cfg.vocab_size, (1, 12)))
    z = torch.from_numpy(_empty(cfg, 1))
    caches = [(z, z) for _ in range(cfg.num_hidden_layers)]
    with torch.no_grad():
        full = tm(ids)
        logits, caches = tm(ids[:, :8], caches=caches)
        got = [logits]
        for i in range(8, 12):
            logits, caches = tm(ids[:, i:i + 1], caches=caches,
                                position_offset=i)
            got.append(logits)
    torch.testing.assert_close(torch.cat(got, dim=1), full, rtol=0,
                               atol=TOL)
