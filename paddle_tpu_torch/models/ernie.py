"""ERNIE family (``paddle_tpu/models/ernie.py``): both generations.

* **ErnieModel / ErnieForSequenceClassification / ErnieForMaskedLM** —
  the ERNIE 3.0 bidirectional encoder (ernie-3.0-medium-zh and kin):
  post-LayerNorm blocks with learned position and token-type embeddings
  and a tanh pooler, the topology the reference serves through
  ``fused_multi_transformer``.  Same config fields, layer names and
  ``[in, out]`` weights as the JAX package.  Attention is
  ``F.scaled_dot_product_attention``: at head_dim 64 and seq >= 1024
  with no mask a CUDA tensor goes to the flash kernel (fp32 at head_dim
  64 as it is, bf16 through the pad to 128), as the JAX package gates
  it; the projections and the FFN are separate Linears, as in JAX.  The
  masked-LM loss runs through the chunked ``fused_linear_cross_entropy``.
* **ErnieForCausalLM** — the ERNIE 4.5 text decoder: the MoE decoder of
  ``models/moe_llm.py`` at ERNIE-4.5-21B-A3B's public shape.

The entry points (the three encoder classes, ``ErnieForCausalLM``)
create their parameters on ``device`` (``cuda`` unless the caller asks
for the CPU)."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from paddle_tpu_torch.core.state import resolve_device
from paddle_tpu_torch.models.moe_llm import MoEConfig, MoEForCausalLM
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.common_layers import Dropout, Embedding, Linear
from paddle_tpu_torch.nn.layer import Layer
from paddle_tpu_torch.nn.norm_layers import LayerNorm

__all__ = ["ErnieConfig", "ErnieModel", "ErnieForSequenceClassification",
           "ErnieForMaskedLM", "ErnieForCausalLM", "ernie45_moe_config"]


@dataclasses.dataclass
class ErnieConfig:
    """ERNIE 3.0 encoder shape (ernie-3.0-medium-zh defaults)."""
    vocab_size: int = 40000
    hidden_size: int = 768
    num_hidden_layers: int = 6
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 2048
    type_vocab_size: int = 4
    layer_norm_eps: float = 1e-12
    pad_token_id: int = 0
    initializer_range: float = 0.02   # reference init_weights normal std
    dtype: str = "float32"

    @staticmethod
    def tiny(**over):
        cfg = dict(vocab_size=128, hidden_size=32, num_hidden_layers=2,
                   num_attention_heads=4, intermediate_size=64,
                   max_position_embeddings=64, type_vocab_size=2,
                   hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
        cfg.update(over)
        return ErnieConfig(**cfg)


class _ErnieSelfAttention(Layer):
    def __init__(self, c: ErnieConfig, device=None):
        super().__init__(dtype=c.dtype, device=device)
        kw = dict(dtype=c.dtype, device=device)
        self.num_heads = c.num_attention_heads
        self.head_dim = c.hidden_size // c.num_attention_heads
        self.qkv = Linear(c.hidden_size, 3 * c.hidden_size, **kw)
        self.out = Linear(c.hidden_size, c.hidden_size, **kw)
        self.dropout = Dropout(c.attention_probs_dropout_prob)

    def forward(self, x, attn_mask=None):
        b, s = x.shape[0], x.shape[1]
        qkv = self.qkv(x).reshape(b, s, 3, self.num_heads, self.head_dim)
        q, k, v = qkv.unbind(dim=2)                     # [b,s,h,d] each
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, is_causal=False)
        return self.out(out.reshape(b, s, -1))


class _ErnieEncoderLayer(Layer):
    """Post-LN encoder block (the reference's fused_multi_transformer
    chain per layer)."""

    def __init__(self, c: ErnieConfig, device=None):
        super().__init__(dtype=c.dtype, device=device)
        kw = dict(dtype=c.dtype, device=device)
        self.self_attn = _ErnieSelfAttention(c, device=device)
        self.norm1 = LayerNorm(c.hidden_size, epsilon=c.layer_norm_eps, **kw)
        self.fc1 = Linear(c.hidden_size, c.intermediate_size, **kw)
        self.fc2 = Linear(c.intermediate_size, c.hidden_size, **kw)
        self.norm2 = LayerNorm(c.hidden_size, epsilon=c.layer_norm_eps, **kw)
        self.dropout = Dropout(c.hidden_dropout_prob)
        self.act = getattr(F, c.hidden_act)

    def forward(self, x, attn_mask=None):
        x = self.norm1(x + self.dropout(self.self_attn(x, attn_mask)))
        return self.norm2(x + self.dropout(self.fc2(self.act(self.fc1(x)))))


class ErnieModel(Layer):
    """ERNIE 3.0 encoder with pooler (reference user API:
    paddlenlp.transformers.ErnieModel over the fused stack)."""

    def __init__(self, config: ErnieConfig, device=None):
        device = resolve_device(device)
        super().__init__(dtype=config.dtype, device=device)
        c = self.config = config
        kw = dict(dtype=c.dtype, device=device)
        self.word_embeddings = Embedding(c.vocab_size, c.hidden_size, **kw)
        self.position_embeddings = Embedding(c.max_position_embeddings,
                                             c.hidden_size, **kw)
        self.token_type_embeddings = Embedding(c.type_vocab_size,
                                               c.hidden_size, **kw)
        self.embed_norm = LayerNorm(c.hidden_size, epsilon=c.layer_norm_eps,
                                    **kw)
        self.embed_dropout = Dropout(c.hidden_dropout_prob)
        # reference init_weights: every embedding table is
        # Normal(0, initializer_range); nn.Embedding's default is N(0, 1)
        # from the seeded stream, scaled here as the JAX package does
        with torch.no_grad():
            for emb in (self.word_embeddings, self.position_embeddings,
                        self.token_type_embeddings):
                emb.weight.mul_(c.initializer_range)
        self.layers = []
        for i in range(c.num_hidden_layers):
            layer = _ErnieEncoderLayer(c, device=device)
            self.add_sublayer(f"layers_{i}", layer)
            self.layers.append(layer)
        self.pooler = Linear(c.hidden_size, c.hidden_size, **kw)

    def forward(self, input_ids, token_type_ids=None, attn_mask=None):
        s = input_ids.shape[1]
        pos = torch.arange(s, dtype=torch.int64, device=input_ids.device)
        x = self.word_embeddings(input_ids) + self.position_embeddings(pos)
        if token_type_ids is None:
            token_type_ids = input_ids * 0
        x = x + self.token_type_embeddings(token_type_ids)
        x = self.embed_dropout(self.embed_norm(x))
        for layer in self.layers:
            x = layer(x, attn_mask)
        pooled = F.tanh(self.pooler(x[:, 0]))
        return x, pooled


class ErnieForSequenceClassification(Layer):
    def __init__(self, config: ErnieConfig, num_classes: int = 2,
                 device=None):
        device = resolve_device(device)
        super().__init__(dtype=config.dtype, device=device)
        self.ernie = ErnieModel(config, device=device)
        self.dropout = Dropout(config.hidden_dropout_prob)
        self.classifier = Linear(config.hidden_size, num_classes,
                                 dtype=config.dtype, device=device)

    def forward(self, input_ids, token_type_ids=None, attn_mask=None):
        _, pooled = self.ernie(input_ids, token_type_ids, attn_mask)
        return self.classifier(self.dropout(pooled))

    def loss(self, input_ids, labels, token_type_ids=None):
        return F.cross_entropy(self(input_ids, token_type_ids), labels)


class ErnieForMaskedLM(Layer):
    """Pretraining head: tied-embedding masked-LM logits."""

    def __init__(self, config: ErnieConfig, device=None):
        device = resolve_device(device)
        super().__init__(dtype=config.dtype, device=device)
        kw = dict(dtype=config.dtype, device=device)
        self.ernie = ErnieModel(config, device=device)
        self.transform = Linear(config.hidden_size, config.hidden_size, **kw)
        self.norm = LayerNorm(config.hidden_size,
                              epsilon=config.layer_norm_eps, **kw)

    def _features(self, input_ids, token_type_ids=None, attn_mask=None):
        """Encoder + MLM head transform, shared by forward and loss."""
        h, _ = self.ernie(input_ids, token_type_ids, attn_mask)
        return self.norm(F.gelu(self.transform(h)))

    def forward(self, input_ids, token_type_ids=None, attn_mask=None):
        h = self._features(input_ids, token_type_ids, attn_mask)
        return torch.matmul(h, self.ernie.word_embeddings.weight.t())

    def loss(self, input_ids, labels, ignore_index: int = -100):
        """Masked-token CE through the chunked lm-head + CE (the ``[T,
        V]`` logits are never materialized; positions labelled
        ``ignore_index`` contribute neither loss nor gradient)."""
        h = self._features(input_ids)
        d = h.shape[-1]
        return F.fused_linear_cross_entropy(
            h.reshape(-1, d), self.ernie.word_embeddings.weight.t(),
            labels.reshape(-1), ignore_index=ignore_index)


# -- ERNIE 4.5: heterogeneous-MoE decoder -------------------------------------

def ernie45_moe_config(**over) -> MoEConfig:
    """ERNIE-4.5-21B-A3B public shape: 28 layers, d=2560, 20 q heads /
    4 kv heads, 64 routed experts top-6 + 2 shared, expert ffn 1536."""
    cfg = dict(vocab_size=103424, hidden_size=2560,
               intermediate_size=12288, moe_intermediate_size=1536,
               num_hidden_layers=28, num_attention_heads=20,
               num_key_value_heads=4, num_experts=64,
               num_experts_per_tok=6, num_shared_experts=2,
               first_k_dense_replace=1, max_position_embeddings=131072,
               rope_theta=500000.0, dtype="bfloat16")
    cfg.update(over)
    return MoEConfig(**cfg)


class ErnieForCausalLM(MoEForCausalLM):
    """ERNIE 4.5 = the MoE decoder with ERNIE's shape; the train step,
    aux load-balance loss and grouped expert kernel are inherited."""

    def __init__(self, config: Optional[MoEConfig] = None, device=None,
                 **over):
        super().__init__(config or ernie45_moe_config(**over), device=device)
