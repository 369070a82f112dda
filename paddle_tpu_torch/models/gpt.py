"""GPT decoder-only transformer: learned positions, pre-LN, GELU MLP, tied
embeddings (``paddle_tpu/models/gpt.py``).

Same configuration fields, layer names and ``[in, out]`` weight layout
as the JAX package, so ``state_dict`` names match one for one (tied: no
``lm_head``).  Attention is ``F.scaled_dot_product_attention`` over the
fused qkv projection: at head_dim 64 and seq >= 1024 with no mask and no
active dropout a CUDA tensor goes to the flash kernels through the
head_dim pad, as the JAX package gates it (``attention.py:77-95``).
``loss`` is ``F.cross_entropy`` over the ``[T, V]`` logits, which runs
the fused softmax cross-entropy kernels on the card.  The tied logits
``h @ E^T`` are one ``torch.matmul``, as JAX leaves them to XLA.

With caches (a ``StaticCache`` a layer, as ``generate`` passes them)
attention is ``static_cache_attention`` and the learned positions are
read at ``position_offset + arange(s)`` (an int, a 0-d tensor, or a
``[B]`` tensor of per-row offsets).  ``partition_specs`` waits in
``ROADMAP.md``, queue 1, item 8."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from paddle_tpu_torch.core.state import resolve_device
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.common_layers import Dropout, Embedding, Linear
from paddle_tpu_torch.nn.layer import Layer
from paddle_tpu_torch.nn.norm_layers import LayerNorm

__all__ = ["GPTConfig", "GPTAttention", "GPTMLP", "GPTDecoderLayer",
           "GPTModel", "GPTForCausalLM"]


@dataclasses.dataclass
class GPTConfig:
    """The defaults are GPT-2 medium (Radford et al. 2019): vocab 50304
    (50257 padded), d 1024, 24 layers, 16 heads of 64, FFN 4096, 1024
    learned positions, tied embeddings."""
    vocab_size: int = 50304
    hidden_size: int = 1024
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    intermediate_size: Optional[int] = None  # None -> 4 * hidden
    max_position_embeddings: int = 1024
    layer_norm_epsilon: float = 1e-5
    hidden_dropout_prob: float = 0.1
    attention_dropout_prob: float = 0.1
    tie_word_embeddings: bool = True
    dtype: str = "float32"

    def __post_init__(self):
        if self.intermediate_size is None:
            self.intermediate_size = 4 * self.hidden_size

    @property
    def num_key_value_heads(self):
        return self.num_attention_heads      # MHA

    @property
    def head_dim(self):
        return self.hidden_size // self.num_attention_heads

    @staticmethod
    def ernie_345m():
        """ERNIE-scale medium config."""
        return GPTConfig(vocab_size=40000, hidden_size=1024,
                         num_hidden_layers=24, num_attention_heads=16,
                         max_position_embeddings=2048)

    @staticmethod
    def tiny(**over):
        cfg = dict(vocab_size=256, hidden_size=64, num_hidden_layers=2,
                   num_attention_heads=4, max_position_embeddings=128,
                   hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
        cfg.update(over)
        return GPTConfig(**cfg)


def _queue1(item: int, what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md, queue 1, item {item})")


class GPTAttention(Layer):
    def __init__(self, config: GPTConfig, device=None):
        super().__init__(dtype=config.dtype, device=device)
        c = config
        self.num_heads = c.num_attention_heads
        self.head_dim = c.head_dim
        kw = dict(dtype=c.dtype, device=device)
        self.qkv_proj = Linear(c.hidden_size, 3 * c.hidden_size, **kw)
        self.out_proj = Linear(c.hidden_size, c.hidden_size, **kw)
        self.dropout_p = c.attention_dropout_prob

    def forward(self, x, cache=None, position_offset=0, attn_mask=None):
        b, s = x.shape[0], x.shape[1]
        qkv = self.qkv_proj(x).reshape(b, s, 3, self.num_heads,
                                       self.head_dim)
        q, k, v = qkv.unbind(dim=2)
        if cache is not None:
            # the static-buffer decode path shared with LlamaAttention
            from paddle_tpu_torch.generation import static_cache_attention
            out, new_cache = static_cache_attention(q, k, v, cache,
                                                    position_offset,
                                                    attn_mask)
            return self.out_proj(out.reshape(b, s, -1)), new_cache
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, is_causal=attn_mask is None,
            dropout_p=self.dropout_p, training=self.training)
        return self.out_proj(out.reshape(b, s, self.num_heads * self.head_dim))


class GPTMLP(Layer):
    def __init__(self, config: GPTConfig, device=None):
        super().__init__(dtype=config.dtype, device=device)
        kw = dict(dtype=config.dtype, device=device)
        self.fc_in = Linear(config.hidden_size, config.intermediate_size, **kw)
        self.fc_out = Linear(config.intermediate_size, config.hidden_size,
                             **kw)

    def forward(self, x):
        return self.fc_out(F.gelu(self.fc_in(x)))


class GPTDecoderLayer(Layer):
    def __init__(self, config: GPTConfig, device=None):
        super().__init__(dtype=config.dtype, device=device)
        kw = dict(epsilon=config.layer_norm_epsilon, dtype=config.dtype,
                  device=device)
        self.ln_1 = LayerNorm(config.hidden_size, **kw)
        self.attn = GPTAttention(config, device=device)
        self.ln_2 = LayerNorm(config.hidden_size, **kw)
        self.mlp = GPTMLP(config, device=device)
        self.dropout = Dropout(config.hidden_dropout_prob)

    def forward(self, x, cache=None, position_offset=0, attn_mask=None):
        if cache is not None:
            a, new_cache = self.attn(self.ln_1(x), cache, position_offset,
                                     attn_mask)
            x = x + self.dropout(a)
            return x + self.dropout(self.mlp(self.ln_2(x))), new_cache
        x = x + self.dropout(self.attn(self.ln_1(x), None, 0, attn_mask))
        return x + self.dropout(self.mlp(self.ln_2(x)))


class GPTModel(Layer):
    def __init__(self, config: GPTConfig, device=None):
        super().__init__(dtype=config.dtype, device=device)
        self.config = config
        kw = dict(dtype=config.dtype, device=device)
        self.embed_tokens = Embedding(config.vocab_size, config.hidden_size,
                                      **kw)
        self.embed_positions = Embedding(config.max_position_embeddings,
                                         config.hidden_size, **kw)
        self.dropout = Dropout(config.hidden_dropout_prob)
        self.layers = []
        for i in range(config.num_hidden_layers):
            layer = GPTDecoderLayer(config, device=device)
            self.add_sublayer(f"layers_{i}", layer)
            self.layers.append(layer)
        self.ln_f = LayerNorm(config.hidden_size,
                              epsilon=config.layer_norm_epsilon, **kw)

    def forward(self, input_ids, attn_mask=None, caches=None,
                position_offset=0):
        if attn_mask is not None and attn_mask.ndim == 0:
            raise ValueError("attn_mask must be an array broadcastable to "
                             "[batch, heads, seq, seq], not a scalar")
        s = input_ids.shape[1]
        steps = torch.arange(s, device=input_ids.device)
        if torch.is_tensor(position_offset):
            off = position_offset.to(device=steps.device, dtype=torch.long)
            # [B] offsets give [B, s] positions, a 0-d one [s]
            pos = off[:, None] + steps[None] if off.ndim == 1 \
                else off + steps
        else:
            pos = position_offset + steps
        x = self.embed_tokens(input_ids) + self.embed_positions(pos)
        x = self.dropout(x)
        new_caches = [] if caches is not None else None
        for i, layer in enumerate(self.layers):
            if caches is not None:
                x, c = layer(x, caches[i], position_offset, attn_mask)
                new_caches.append(c)
            else:
                x = layer(x, None, 0, attn_mask)
        x = self.ln_f(x)
        if caches is not None:
            return x, new_caches
        return x


class GPTForCausalLM(Layer):
    """Entry point: parameters are created on ``device`` (``cuda``
    unless the caller passes another; CUDA absent and not asked for the
    CPU raises), in ``config.dtype``, from the device's seeded
    generator."""

    def __init__(self, config: GPTConfig, device=None):
        device = resolve_device(device)
        super().__init__(dtype=config.dtype, device=device)
        self.config = config
        self.model = GPTModel(config, device=device)
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
        """Next-token cross-entropy of the ``[T, V]`` logits through
        ``F.cross_entropy`` (``models/gpt.py:201-205``): the fused
        softmax cross-entropy, a kernel each way on the card."""
        logits = self(input_ids)
        v = logits.shape[-1]
        return F.cross_entropy(logits.reshape(-1, v), labels.reshape(-1))

    @staticmethod
    def partition_specs(config, dp_axis="dp", tp_axis="tp", fsdp_axis=None):
        raise _queue1(8, "GPTForCausalLM.partition_specs (meshes and "
                         "sharded placement)")

    @staticmethod
    def spec_for(name, rules):
        raise _queue1(8, "GPTForCausalLM.spec_for (meshes and sharded "
                         "placement)")
