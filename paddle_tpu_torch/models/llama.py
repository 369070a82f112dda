"""Llama decoder-only transformer (``paddle_tpu/models/llama.py``).

Same configuration fields, layer names and ``[in, out]`` weight layout
as the JAX package, so ``state_dict`` names match one for one.  Every
decoder layer runs

    fused_rmsnorm_qkv -> RoPE -> attention (paged cache or dense)
    -> o_proj + residual -> RMSNorm -> fused_mlp -> residual

where the two fused functions launch their CUDA kernels for CUDA tensors
at every row count (the TPU package routes them only where Mosaic can
tile the shape) and take their plain versions on the CPU.  Projections
converted to ``QuantedLinear`` (``quantize_for_serving``, the engine's
``int8_weights``, PTQ) or wrapped for calibration or QAT have no fp
weight for the fused kernels, so, as in the JAX package
(``models/llama.py:173-185, 245-256``), a layer with any quantized q/k/v
projection takes RMSNorm then the projections one by one, and an MLP
with any quantized projection takes ``down(silu(gate(x)) * up(x))``;
each projection then runs the quant-matmul kernel.  The dense
(no-cache) attention reaches the flash-attention kernels on CUDA for
eligible shapes.  Under autograd the fused functions and flash attention
run their custom VJPs, so ``loss`` trains through the same kernels.  The
RoPE tables stay fp32 in a bf16 model.

At ``PADDLE_TPU_FUSED_BLOCK=decoder`` (or ``measured``, where the
ledger measured the block faster at the layer's shape) a cache-free,
mask-free, offset-0 call (``.loss()``, scoring, a full prompt without a cache) runs each
layer whose shape the gate takes as ``F.fused_decoder_block``
(``paddle_tpu/models/llama.py:188-225, 268-278``): one launch of the
whole-block kernel on the card, the plain block on the CPU, and in
training the block-boundary remat, whose backward recomputes the layer
through the per-segment kernels.  ``fused_decoder_block.routes`` counts
the layers each way.  The paged engine always carries a cache, so it
never reaches the tier.
With a ``StaticCache`` (``generate`` and the slot-contiguous engine)
attention is ``static_cache_attention``; with a ``PagedCache``
``paged_cache_attention``; with a ``(k, v)`` pair (``[b, s_past,
kv_heads, head_dim]`` each, s_past may be 0) the step's k/v are
concatenated after the past and the layer returns the grown pair, as in
the JAX package.  ``partition_specs`` comes with a later slice of the
port (ROADMAP.md, queue 1, item 8)."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from paddle_tpu_torch.core.state import resolve_device
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.common_layers import Embedding, Linear
from paddle_tpu_torch.nn.layer import Layer
from paddle_tpu_torch.nn.norm_layers import RMSNorm
from paddle_tpu_torch.ops.kernels import fused_block as _FB

__all__ = ["LlamaConfig", "LlamaAttention", "LlamaMLP", "LlamaDecoderLayer",
           "LlamaModel", "LlamaForCausalLM"]


@dataclasses.dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: Optional[int] = None  # None -> MHA
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False
    # sparse_embed=True gives the embedding a row-sparse gradient in eager
    # training (rows-touched optimizer update, no dense [vocab, d]
    # gradient: core/sparse_grad.py); TrainStep keeps dense gradients
    sparse_embed: bool = False
    dtype: str = "float32"

    def __post_init__(self):
        if self.num_key_value_heads is None:
            self.num_key_value_heads = self.num_attention_heads

    @property
    def head_dim(self):
        return self.hidden_size // self.num_attention_heads

    @staticmethod
    def llama3_8b():
        return LlamaConfig(
            vocab_size=128256, hidden_size=4096, intermediate_size=14336,
            num_hidden_layers=32, num_attention_heads=32,
            num_key_value_heads=8, max_position_embeddings=8192,
            rope_theta=500000.0, dtype="bfloat16")

    @staticmethod
    def tiny(**over):
        cfg = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                   num_hidden_layers=2, num_attention_heads=4,
                   num_key_value_heads=2, max_position_embeddings=128)
        cfg.update(over)
        return LlamaConfig(**cfg)


class LlamaAttention(Layer):
    def __init__(self, config: LlamaConfig, device=None):
        super().__init__(dtype=config.dtype, device=device)
        c = config
        self.num_heads = c.num_attention_heads
        self.num_kv_heads = c.num_key_value_heads
        self.head_dim = c.head_dim
        kw = dict(bias_attr=False, dtype=c.dtype, device=device)
        self.q_proj = Linear(c.hidden_size, self.num_heads * self.head_dim,
                             **kw)
        self.k_proj = Linear(c.hidden_size, self.num_kv_heads * self.head_dim,
                             **kw)
        self.v_proj = Linear(c.hidden_size, self.num_kv_heads * self.head_dim,
                             **kw)
        self.o_proj = Linear(self.num_heads * self.head_dim, c.hidden_size,
                             **kw)

    def forward(self, x, rope_cos, rope_sin, attn_mask=None, cache=None,
                position_offset=0):
        """The unfused path over normalised x: each projection on its
        own, then :meth:`attend`."""
        return self.attend(self.q_proj(x), self.k_proj(x), self.v_proj(x),
                           rope_cos, rope_sin, attn_mask, cache,
                           position_offset)

    def attend(self, q, k, v, rope_cos, rope_sin, attn_mask=None,
               cache=None, position_offset=0):
        """Everything after the projections: RoPE, the cache, attention,
        o_proj.  With a cache returns ``(out, new_cache)``."""
        b, s = q.shape[0], q.shape[1]
        q = q.reshape(b, s, self.num_heads, self.head_dim)
        k = k.reshape(b, s, self.num_kv_heads, self.head_dim)
        v = v.reshape(b, s, self.num_kv_heads, self.head_dim)
        q = F.apply_rotary_emb(q, rope_cos, rope_sin, position_offset)
        k = F.apply_rotary_emb(k, rope_cos, rope_sin, position_offset)
        if cache is not None:
            from paddle_tpu_torch.generation import (StaticCache,
                                                     static_cache_attention)
            from paddle_tpu_torch.inference.kv_cache import (
                PagedCache, paged_cache_attention)
            if isinstance(cache, (StaticCache, PagedCache)):
                # generate() and the slot-contiguous engine: fixed
                # buffers written in place at the offset; the paged
                # engine: block pools through a block table
                attend = static_cache_attention \
                    if isinstance(cache, StaticCache) \
                    else paged_cache_attention
                out, new_cache = attend(q, k, v, cache, position_offset,
                                        attn_mask)
                return self.o_proj(out.reshape(b, s, -1)), new_cache
            # the concatenated cache (models/llama.py:137-147): the past
            # k/v before the step's; is_causal stays on, the tril offset
            # by sk - sq, and sq != sk never takes flash
            pk, pv = cache
            k = torch.cat([pk, k], dim=1)
            v = torch.cat([pv, v], dim=1)
            out = F.scaled_dot_product_attention(
                q, k, v, attn_mask=attn_mask, is_causal=attn_mask is None)
            return self.o_proj(out.reshape(b, s, -1)), (k, v)
        out = F.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask,
                                             is_causal=attn_mask is None)
        return self.o_proj(out.reshape(b, s, -1))


def _unfused(*layers) -> bool:
    """Whether any of `layers` is not a plain ``Linear`` with an fp
    weight for the fused kernels: a ``QuantedLinear`` (serving or PTQ),
    a QAT ``FakeQuantLinear`` or a PTQ calibration wrapper.  Such a layer
    runs projection by projection, as the JAX package's reference path
    does off the TPU."""
    return any(type(p) is not Linear for p in layers)


class LlamaMLP(Layer):
    """SwiGLU ``down(silu(gate(x)) * up(x))`` through ``F.fused_mlp``, or
    projection by projection when any of them is quantized or wrapped
    (:func:`_unfused`)."""

    def __init__(self, config: LlamaConfig, device=None):
        super().__init__(dtype=config.dtype, device=device)
        c = config
        kw = dict(bias_attr=False, dtype=c.dtype, device=device)
        self.gate_proj = Linear(c.hidden_size, c.intermediate_size, **kw)
        self.up_proj = Linear(c.hidden_size, c.intermediate_size, **kw)
        self.down_proj = Linear(c.intermediate_size, c.hidden_size, **kw)

    def forward(self, x):
        quanted = _unfused(self.gate_proj, self.up_proj, self.down_proj)
        _FB.record_path("mlp", not quanted and x.device.type == "cuda")
        if quanted:
            return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))
        return F.fused_mlp(x, self.gate_proj.weight, self.up_proj.weight,
                           self.down_proj.weight)


def _fused_decoder(layer, x, rope_cos, rope_sin):
    """The whole block through ``F.fused_decoder_block`` at the
    ``PADDLE_TPU_FUSED_BLOCK=decoder`` tier where the layer has no
    quantized projection, the RoPE tables cover s rows and
    ``fused_decoder_eligible`` takes the shape; None sends the caller to
    the per-segment path.  At the ``measured`` tier the layer goes to the
    block only where the ledger measured it faster for this ``(b, s, d)``
    (``measured_tier_for``; ``paddle_tpu/models/llama.py:188-225``).
    Counts the choice in ``fused_decoder_block.routes`` (JAX's
    ``record_path("decoder_block", ...)``,
    ``paddle_tpu/models/llama.py:215``)."""
    tier = _FB.fused_block_tier()
    if tier not in ("decoder", "measured"):
        return None
    attn, mlp = layer.self_attn, layer.mlp
    b, s, d = x.shape
    if tier == "measured" and \
            _FB.measured_tier_for((b, s, d), x.dtype) != "decoder":
        _FB.fused_decoder_block.routes["segments"] += 1
        return None
    dq = attn.num_heads * attn.head_dim
    dkv = attn.num_kv_heads * attn.head_dim
    fused = not _unfused(attn.q_proj, attn.k_proj, attn.v_proj,
                           attn.o_proj, mlp.gate_proj, mlp.up_proj,
                           mlp.down_proj) and \
        rope_cos.shape[0] >= s and _FB.fused_decoder_eligible(
            b, s, d, dq, dkv, attn.head_dim, mlp.gate_proj.weight.shape[-1],
            x.dtype)
    _FB.fused_decoder_block.routes["decoder" if fused else "segments"] += 1
    _FB.record_path("decoder_block", fused and x.device.type == "cuda")
    if not fused:
        return None
    return F.fused_decoder_block(
        x, layer.input_layernorm.weight, attn.q_proj.weight,
        attn.k_proj.weight, attn.v_proj.weight, rope_cos, rope_sin,
        attn.o_proj.weight, layer.post_attention_layernorm.weight,
        mlp.gate_proj.weight, mlp.up_proj.weight, mlp.down_proj.weight,
        num_heads=attn.num_heads, num_kv_heads=attn.num_kv_heads,
        epsilon=layer.input_layernorm._epsilon)


class LlamaDecoderLayer(Layer):
    def __init__(self, config: LlamaConfig, device=None):
        super().__init__(dtype=config.dtype, device=device)
        kw = dict(epsilon=config.rms_norm_eps, dtype=config.dtype,
                  device=device)
        self.input_layernorm = RMSNorm(config.hidden_size, **kw)
        self.self_attn = LlamaAttention(config, device=device)
        self.post_attention_layernorm = RMSNorm(config.hidden_size, **kw)
        self.mlp = LlamaMLP(config, device=device)

    def forward(self, x, rope_cos, rope_sin, attn_mask=None, cache=None,
                position_offset=0):
        # the decoder tier: the cache-free, mask-free, offset-0 form
        if cache is None and attn_mask is None and \
                isinstance(position_offset, int) and position_offset == 0:
            y = _fused_decoder(self, x, rope_cos, rope_sin)
            if y is not None:
                return y
        attn = self.self_attn
        quanted = _unfused(attn.q_proj, attn.k_proj, attn.v_proj)
        _FB.record_path("rmsnorm_qkv", not quanted and x.device.type == "cuda")
        if quanted:
            h = attn(self.input_layernorm(x), rope_cos, rope_sin, attn_mask,
                     cache, position_offset)
        else:
            q, k, v = F.fused_rmsnorm_qkv(
                x, self.input_layernorm.weight, attn.q_proj.weight,
                attn.k_proj.weight, attn.v_proj.weight,
                epsilon=self.input_layernorm._epsilon)
            h = attn.attend(q, k, v, rope_cos, rope_sin, attn_mask, cache,
                            position_offset)
        new_cache = None
        if cache is not None:
            h, new_cache = h
        x = x + h
        x = x + self.mlp(self.post_attention_layernorm(x))
        if cache is not None:
            return x, new_cache
        return x


class LlamaModel(Layer):
    def __init__(self, config: LlamaConfig, device=None):
        super().__init__(dtype=config.dtype, device=device)
        self.config = config
        self.embed_tokens = Embedding(config.vocab_size, config.hidden_size,
                                      sparse=config.sparse_embed,
                                      dtype=config.dtype, device=device)
        self.layers = []
        for i in range(config.num_hidden_layers):
            layer = LlamaDecoderLayer(config, device=device)
            self.add_sublayer(f"layers_{i}", layer)
            self.layers.append(layer)
        self.norm = RMSNorm(config.hidden_size, epsilon=config.rms_norm_eps,
                            dtype=config.dtype, device=device)
        cos, sin = F.rotary_freqs(config.head_dim,
                                  config.max_position_embeddings,
                                  base=config.rope_theta, device=device)
        self.register_buffer("rope_cos", cos, persistable=False)
        self.register_buffer("rope_sin", sin, persistable=False)

    def astype(self, dtype):
        """Cast the weights; the RoPE tables stay fp32 (they are applied
        in fp32 whatever the weights' dtype)."""
        cos, sin = self.rope_cos.data, self.rope_sin.data
        super().astype(dtype)
        self.rope_cos.data, self.rope_sin.data = cos, sin
        return self

    def forward(self, input_ids, attn_mask=None, caches=None,
                position_offset=0):
        x = self.embed_tokens(input_ids)
        new_caches = [] if caches is not None else None
        for i, layer in enumerate(self.layers):
            cache = caches[i] if caches is not None else None
            x = layer(x, self.rope_cos, self.rope_sin, attn_mask, cache,
                      position_offset)
            if caches is not None:
                x, c = x
                new_caches.append(c)
        x = self.norm(x)
        if caches is not None:
            return x, new_caches
        return x


class LlamaForCausalLM(Layer):
    """Entry point: parameters are created on ``device`` (``cuda``
    unless the caller passes another; CUDA absent and not asked for the
    CPU raises), in ``config.dtype``, from the device's seeded
    generator."""

    def __init__(self, config: LlamaConfig, device=None):
        device = resolve_device(device)
        super().__init__(dtype=config.dtype, device=device)
        self.config = config
        self.model = LlamaModel(config, device=device)
        if config.tie_word_embeddings:
            self.lm_head = None
        else:
            self.lm_head = Linear(config.hidden_size, config.vocab_size,
                                  bias_attr=False, dtype=config.dtype,
                                  device=device)

    @property
    def device(self) -> torch.device:
        return self._device

    def forward(self, input_ids, attn_mask=None, caches=None,
                position_offset=0):
        h = self.model(input_ids, attn_mask, caches, position_offset)
        new_caches = None
        if caches is not None:
            h, new_caches = h
        if self.lm_head is None:
            logits = torch.matmul(h, self.model.embed_tokens.weight.t())
        else:
            logits = self.lm_head(h)
        if caches is not None:
            return logits, new_caches
        return logits

    def generate(self, input_ids, generation_config=None, **kwargs):
        """KV-cache decoding over static caches
        (:func:`paddle_tpu_torch.generation.generate`)."""
        from paddle_tpu_torch.generation import generate as _gen
        return _gen(self, input_ids, generation_config, **kwargs)

    def loss(self, input_ids, labels):
        """Next-token cross-entropy through the fused chunked lm-head +
        CE (``models/llama.py:372-382``): the ``[T, V]`` fp32 logits are
        never materialised whole."""
        h = self.model(input_ids)
        d = h.shape[-1]
        w = self.model.embed_tokens.weight.t() if self.lm_head is None \
            else self.lm_head.weight
        return F.fused_linear_cross_entropy(h.reshape(-1, d), w,
                                            labels.reshape(-1))
