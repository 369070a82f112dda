"""Text generation over static KV caches (``paddle_tpu/generation/
__init__.py``): the sampling config, the mask guard of the cached
forward signatures, the sampler, :class:`StaticCache`,
:func:`static_cache_attention` and :func:`generate`.

The JAX package compiles one prefill and a ``lax.scan`` of the
per-token step.  Here the prompt is prefilled eagerly in one pass, and
the per-token step is one :class:`~paddle_tpu_torch.jit.static_graph.
StaticGraph` over the run's own buffers (the caches, the last tokens,
the position as a 0-d device tensor, the done flags and the output
columns): on CUDA a captured graph replayed ``max_new_tokens - 1``
times, on the CPU the same body called on the same buffers.  Torch
tensors are mutable, so the caches are written in place where the JAX
package returns new ones."""

from __future__ import annotations

import itertools
import weakref
from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

__all__ = ["GenerationConfig", "StaticCache", "generate",
           "static_cache_attention", "reject_scalar_mask",
           "run_cache_info"]

_NEG = -1e30


def reject_scalar_mask(attn_mask):
    """Guard shared by the cached-decode forward signatures: a scalar
    attn_mask means the caller passed position_offset positionally where
    attn_mask sits.  Returns the mask (or None)."""
    if isinstance(attn_mask, (int, float)) or (
            torch.is_tensor(attn_mask) and attn_mask.ndim == 0):
        raise TypeError(
            "attn_mask got a scalar — position_offset must be passed by "
            "keyword (the forward signature gained attn_mask before it)")
    return attn_mask


class StaticCache(NamedTuple):
    """Pre-allocated KV buffers ``[batch, max_len, kv_heads, head_dim]``,
    written in place by :func:`static_cache_attention`."""
    k: torch.Tensor
    v: torch.Tensor


@dataclass
class GenerationConfig:
    max_new_tokens: int = 32
    do_sample: bool = False
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    eos_token_id: Optional[int] = None
    pad_token_id: int = 0
    seed: int = 0


def static_cache_attention(q, k, v, cache: StaticCache, position_offset,
                           attn_mask=None):
    """Write the step's k/v into the static buffers at
    `position_offset`, then attend over the buffer's valid causal prefix
    with a caller mask folded in (``generation/__init__.py:59-108``).

    q/k/v: ``[b, s, heads, head_dim]`` projections, RoPE applied.
    `position_offset`: a ``[B]`` integer tensor of per-row positions
    (``s == 1``: each row's k/v lands in its own row of the buffer), or
    one offset for every row, an int or a 0-d tensor (rows
    ``offset .. offset + s - 1`` are written).  An int is checked against
    the buffer; a tensor on the card is not read (the caller bounds it).
    Returns ``(out [b, s, heads, head_dim], cache)``."""
    from paddle_tpu_torch.nn.functional.attention import \
        scaled_dot_product_attention
    s = q.shape[1]
    kc, vc = cache.k, cache.v
    dev = kc.device
    max_len = kc.shape[1]
    kpos = torch.arange(max_len, device=dev)[None, None, None, :]
    if torch.is_tensor(position_offset) and position_offset.ndim == 1:
        # continuous batching: every slot decodes at its own offset
        if s != 1:
            raise ValueError("per-row position_offset requires seq==1 "
                             f"(got {s})")
        off = position_offset.to(device=dev, dtype=torch.long)
        rows = torch.arange(q.shape[0], device=dev)
        kc.index_put_((rows, off), k[:, 0].to(kc.dtype))
        vc.index_put_((rows, off), v[:, 0].to(vc.dtype))
        mask = kpos <= off[:, None, None, None]             # [B,1,1,T]
    else:
        if torch.is_tensor(position_offset):
            off = position_offset.to(device=dev, dtype=torch.long)
        else:
            off = int(position_offset)
            if off < 0 or off + s > max_len:
                raise ValueError(f"positions [{off}, {off + s}) outside "
                                 f"the static cache of {max_len}")
        idx = off + torch.arange(s, device=dev)
        kc.index_copy_(1, idx, k.to(kc.dtype))
        vc.index_copy_(1, idx, v.to(vc.dtype))
        mask = kpos <= idx[None, None, :, None]             # [1,1,s,T]
    if attn_mask is not None:
        am = reject_scalar_mask(attn_mask).to(dev)
        if am.dtype == torch.bool:
            mask = mask & am
        else:       # additive mask: fold the causal bound in
            mask = torch.where(mask, am.float(), _NEG)
    out = scaled_dot_product_attention(q, kc, vc, attn_mask=mask,
                                       is_causal=False)
    return out, cache


def _sample(logits, cfg: GenerationConfig,
            generator: Optional[torch.Generator] = None):
    """``[B, vocab]`` -> ``[B]`` next tokens: argmax, or a draw under
    temperature / top-k / nucleus from `generator`.  Torch's generator
    cannot reproduce JAX's random bits, so only the greedy path is held
    to the JAX package token for token."""
    if not cfg.do_sample:
        return torch.argmax(logits, dim=-1)
    logits = logits / max(cfg.temperature, 1e-6)
    if cfg.top_k and cfg.top_k > 0:
        k = min(cfg.top_k, logits.shape[-1])   # top_k may exceed vocab
        kth = torch.sort(logits, dim=-1).values[:, -k][:, None]
        logits = torch.where(logits < kth, _NEG, logits)
    if cfg.top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        # smallest prefix with mass >= top_p stays; its cutoff logit
        cutoff_idx = torch.sum(cum < cfg.top_p, dim=-1, keepdim=True) \
            .clamp(max=logits.shape[-1] - 1)
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx)
        logits = torch.where(logits < cutoff, _NEG, logits)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def _compute_dtype(model):
    params = list(model.parameters())
    return next((p.dtype for p in params if p.is_floating_point()),
                params[0].dtype)


def _empty_caches(model, batch, max_len, dtype, device=None):
    """One zeroed :class:`StaticCache` a layer, on the model's device."""
    cfg = model.config
    if device is None:
        device = next(iter(model.parameters())).device
    shape = (batch, max_len, cfg.num_key_value_heads, cfg.head_dim)
    return [StaticCache(torch.zeros(shape, dtype=dtype, device=device),
                        torch.zeros(shape, dtype=dtype, device=device))
            for _ in range(cfg.num_hidden_layers)]


def _addresses(model):
    """Where every weight and buffer lives: a captured graph reads these
    addresses, so a run is reused only while none of them moved (a cast,
    a move, a quantization's conversion)."""
    return tuple(t.data_ptr() for t in itertools.chain(model.parameters(),
                                                       model.buffers()))


_RUN_CACHE: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_RUN_CACHE_MAX_PER_MODEL = 16


def generate(model, input_ids, generation_config: Optional[
        GenerationConfig] = None, **kwargs):
    """Autoregressive decoding over static caches.

    input_ids: ``[batch, prompt_len]`` (numpy, a list or a tensor; one
    row may be 1-d).  Returns ``[batch, prompt_len + max_new_tokens]``
    int32 as a numpy array.  EOS is emitted verbatim (including as the
    very first sampled token), and every position after a row's EOS
    holds ``pad_token_id``.  Sampling draws from a generator seeded with
    ``seed`` at every call, so a call is repeatable.

    One run per (model, batch and prompt shape, dtype, sampling config,
    weight addresses) is kept, weakly on the model and at most 16 a model
    (least recently used first out, its graph and buffers freed)."""
    cfg = generation_config or GenerationConfig(**kwargs)
    if cfg.max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got "
                         f"{cfg.max_new_tokens}")
    dev = next(iter(model.parameters())).device
    ids = torch.as_tensor(input_ids).to(dev, torch.long)
    if ids.ndim == 1:
        ids = ids[None]
    B, L = ids.shape
    # the last position fed is L + max_new - 2; positions on the device
    # are not read there, so the table bound is checked here
    table = model.config.max_position_embeddings
    if L + cfg.max_new_tokens - 1 > table:
        raise ValueError(
            f"prompt {L} + max_new_tokens {cfg.max_new_tokens} exceeds the "
            f"model's position table (max_position_embeddings={table})")
    dtype = _compute_dtype(model)
    cfg_key = (cfg.max_new_tokens, cfg.do_sample, cfg.temperature,
               cfg.top_k, cfg.top_p, cfg.eos_token_id, cfg.pad_token_id)
    key = (B, L, str(dtype), cfg_key, _addresses(model))
    per_model = _RUN_CACHE.get(model)
    if per_model is None:
        per_model = _RUN_CACHE[model] = {}
    was_training = getattr(model, "training", False)
    if was_training:
        model.eval()          # decode is inference: dropout must be off
    try:
        with torch.inference_mode():
            run = per_model.pop(key, None)   # re-inserted below: LRU
            if run is None:
                if len(per_model) >= _RUN_CACHE_MAX_PER_MODEL:
                    per_model.pop(next(iter(per_model))).close()
                run = _Run(model, cfg, B, L, dtype, dev)
            per_model[key] = run
            return run(ids, cfg.seed)
    finally:
        if was_training:
            model.train()


def run_cache_info(model):
    """Each cached run of `model`, least recently used first: its batch,
    prompt length, whether it replays a CUDA graph, the capture's
    seconds, the kernel launches a replay makes, replays and calls."""
    out = []
    for r in _RUN_CACHE.get(model, {}).values():
        g = r.step
        out.append({"batch": r.B, "prompt": r.L,
                    "graph": g is not None and g.graph is not None,
                    "capture_s": r.info.total_s if g else 0.0,
                    "launches": dict(g.launches) if g else {},
                    "replays": g.replays if g else 0, "calls": r.calls})
    return out


class _Run:
    """The buffers and the per-token step of one generate() shape."""

    def __init__(self, model, cfg: GenerationConfig, B: int, L: int,
                 dtype, dev):
        from paddle_tpu_torch.observability.device_profiler import \
            compile_static
        # weak: the cache is keyed weakly on the model, and the run must
        # not keep it alive
        self._model = weakref.ref(model)
        self.cfg, self.B, self.L = cfg, B, L
        self.calls = 0
        n = cfg.max_new_tokens
        self.caches = _empty_caches(model, B, L + n, dtype, dev)
        self.gen = torch.Generator(device=dev)
        self.out = torch.zeros((B, n), dtype=torch.long, device=dev)
        # the warm-up before a capture runs one step from here: it
        # writes cache row L, which every call zeroes first
        state = {"tok": torch.zeros((B,), dtype=torch.long, device=dev),
                 "pos": torch.full((), L, dtype=torch.long, device=dev),
                 "done": torch.zeros((B,), dtype=torch.bool, device=dev)}
        self.state = state
        self.step, self.info = compile_static(
            self._step, state, "generate.step",
            generator=self.gen if cfg.do_sample else None,
            what="generate's step") if n > 1 else (None, None)

    def _step(self, tok, pos, done):
        """One token for every row, in place: tok and done take the new
        token and flags, its column of out is written, pos advances."""
        cfg = self.cfg
        logits, _ = self._model()(tok[:, None], None, self.caches, pos)
        nxt = _sample(logits[:, -1].float(), cfg, self.gen)
        if cfg.eos_token_id is not None:
            nxt = torch.where(done, cfg.pad_token_id, nxt)
            torch.logical_or(done, nxt == cfg.eos_token_id, out=done)
        self.out.index_copy_(1, (pos - (self.L - 1)).reshape(1),
                             nxt[:, None])
        tok.copy_(nxt)
        pos.add_(1)

    def __call__(self, ids, seed):
        self.calls += 1
        cfg = self.cfg
        for c in self.caches:
            c.k.zero_()
            c.v.zero_()
        self.gen.manual_seed(int(seed))
        # the whole prompt in one pass
        logits, _ = self._model()(ids, None, self.caches, 0)
        first = _sample(logits[:, -1].float(), cfg, self.gen)
        self.out[:, 0] = first
        st = self.state
        st["tok"].copy_(first)
        st["pos"].fill_(self.L)
        if cfg.eos_token_id is not None:
            torch.eq(first, cfg.eos_token_id, out=st["done"])
        else:
            st["done"].zero_()
        for _ in range(cfg.max_new_tokens - 1):
            self.step()
        return torch.cat([ids, self.out], dim=1).to(torch.int32) \
            .cpu().numpy()

    def close(self):
        if self.step is not None:
            self.step.close()
        self.caches = self.out = self.state = None
