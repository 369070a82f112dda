"""MoE decoder LM — DeepSeekMoE / Qwen2-MoE / ERNIE 4.5 shape
(``paddle_tpu/models/moe_llm.py``).

Llama attention and RMSNorm blocks where the dense SwiGLU MLP is a routed
expert bank (``distributed/moe.py``, fine-grained experts, top-k) plus
always-on shared experts: ``out = x + shared_mlp(h) + moe(h)``.  Layer
names and ``[in, out]`` / ``[E, d, h]`` layouts are the JAX package's, so
state dicts move across as numpy arrays (``Layer.set_state_dict``).

As in the JAX package the attention is unfused: ``input_layernorm``,
then ``LlamaAttention.forward`` (each projection on its own, flash
attention on the card); the dense and shared MLPs are ``LlamaMLP``
through the fused SwiGLU kernel pair; the routed experts run the grouped
expert-FFN kernel.  ``partition_specs`` and the all_to_all dispatch
modes wait in ``ROADMAP.md``, queue 1."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from paddle_tpu_torch.core.state import resolve_device
from paddle_tpu_torch.distributed.moe import MoELayer
from paddle_tpu_torch.models.llama import LlamaAttention, LlamaConfig, LlamaMLP
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.common_layers import Embedding, Linear
from paddle_tpu_torch.nn.layer import Layer
from paddle_tpu_torch.nn.norm_layers import RMSNorm

__all__ = ["MoEConfig", "MoEDecoderLayer", "MoEModel", "MoEForCausalLM"]


@dataclasses.dataclass
class MoEConfig:
    vocab_size: int = 32000
    hidden_size: int = 2048
    intermediate_size: int = 5632        # dense/shared-expert MLP width
    moe_intermediate_size: int = 1408    # per routed expert width
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    num_key_value_heads: Optional[int] = None
    num_experts: int = 64
    num_experts_per_tok: int = 6
    num_shared_experts: int = 2
    first_k_dense_replace: int = 1       # leading dense layers (DeepSeek)
    capacity_factor: float = 1.25
    aux_loss_alpha: float = 0.001
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    # "einsum" or "index" (the single-program modes that are ported)
    dispatch_mode: str = "einsum"
    mesh: object = None                  # the all_to_all modes (not ported)
    dtype: str = "float32"

    def __post_init__(self):
        if self.num_key_value_heads is None:
            self.num_key_value_heads = self.num_attention_heads

    def as_llama(self) -> LlamaConfig:
        return LlamaConfig(
            vocab_size=self.vocab_size, hidden_size=self.hidden_size,
            intermediate_size=self.intermediate_size,
            num_hidden_layers=self.num_hidden_layers,
            num_attention_heads=self.num_attention_heads,
            num_key_value_heads=self.num_key_value_heads,
            max_position_embeddings=self.max_position_embeddings,
            rms_norm_eps=self.rms_norm_eps, rope_theta=self.rope_theta,
            dtype=self.dtype)

    @property
    def head_dim(self):
        return self.hidden_size // self.num_attention_heads

    @staticmethod
    def qwen2_moe_a2_7b():
        return MoEConfig(vocab_size=151936, hidden_size=2048,
                         intermediate_size=5632, moe_intermediate_size=1408,
                         num_hidden_layers=24, num_attention_heads=16,
                         num_experts=60, num_experts_per_tok=4,
                         num_shared_experts=4, first_k_dense_replace=0,
                         dtype="bfloat16")

    @staticmethod
    def deepseek_moe_16b():
        return MoEConfig(vocab_size=102400, hidden_size=2048,
                         intermediate_size=10944, moe_intermediate_size=1408,
                         num_hidden_layers=28, num_attention_heads=16,
                         num_experts=64, num_experts_per_tok=6,
                         num_shared_experts=2, first_k_dense_replace=1,
                         dtype="bfloat16")

    @staticmethod
    def tiny(**over):
        cfg = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                   moe_intermediate_size=64, num_hidden_layers=2,
                   num_attention_heads=4, num_key_value_heads=2,
                   num_experts=4, num_experts_per_tok=2,
                   num_shared_experts=1, first_k_dense_replace=1,
                   max_position_embeddings=128, capacity_factor=2.0)
        cfg.update(over)
        return MoEConfig(**cfg)


class _SharedMLP(LlamaMLP):
    """Always-on shared expert(s): one SwiGLU of width
    ``num_shared_experts * moe_intermediate_size``."""

    def __init__(self, config: MoEConfig, device=None):
        shared = config.as_llama()
        shared.intermediate_size = (config.num_shared_experts
                                    * config.moe_intermediate_size)
        super().__init__(shared, device=device)


class MoEDecoderLayer(Layer):
    def __init__(self, config: MoEConfig, dense: bool = False, device=None):
        super().__init__(dtype=config.dtype, device=device)
        lc = config.as_llama()
        kw = dict(epsilon=config.rms_norm_eps, dtype=config.dtype,
                  device=device)
        self.input_layernorm = RMSNorm(config.hidden_size, **kw)
        self.self_attn = LlamaAttention(lc, device=device)
        self.post_attention_layernorm = RMSNorm(config.hidden_size, **kw)
        self.is_dense = dense
        if dense:
            self.mlp = LlamaMLP(lc, device=device)
        else:
            self.shared_mlp = _SharedMLP(config, device=device)
            self.moe = MoELayer(
                d_model=config.hidden_size,
                num_experts=config.num_experts,
                d_hidden=config.moe_intermediate_size,
                gate="naive", top_k=config.num_experts_per_tok,
                capacity_factor=config.capacity_factor,
                dispatch_mode=config.dispatch_mode, mesh=config.mesh,
                dtype=config.dtype, device=device)

    def forward(self, x, rope_cos, rope_sin):
        x = x + self.self_attn(self.input_layernorm(x), rope_cos, rope_sin)
        h = self.post_attention_layernorm(x)
        if self.is_dense:
            return x + self.mlp(h)
        return x + self.shared_mlp(h) + self.moe(h)


class MoEModel(Layer):
    def __init__(self, config: MoEConfig, device=None):
        super().__init__(dtype=config.dtype, device=device)
        self.config = config
        self.embed_tokens = Embedding(config.vocab_size, config.hidden_size,
                                      dtype=config.dtype, device=device)
        self.layers = []
        for i in range(config.num_hidden_layers):
            layer = MoEDecoderLayer(config,
                                    dense=i < config.first_k_dense_replace,
                                    device=device)
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
        """Cast the weights; the RoPE tables stay fp32
        (``moe_llm.py:169-172``)."""
        cos, sin = self.rope_cos.data, self.rope_sin.data
        super().astype(dtype)
        self.rope_cos.data, self.rope_sin.data = cos, sin
        return self

    def forward(self, input_ids):
        x = self.embed_tokens(input_ids)
        for layer in self.layers:
            x = layer(x, self.rope_cos, self.rope_sin)
        return self.norm(x)

    def aux_loss(self):
        """Sum of the last forward's per-layer load-balance losses."""
        total = None
        for layer in self.layers:
            if not layer.is_dense and layer.moe.aux_loss is not None:
                total = layer.moe.aux_loss if total is None \
                    else total + layer.moe.aux_loss
        return total


class MoEForCausalLM(Layer):
    """Entry point: parameters are created on ``device`` (``cuda``
    unless the caller passes another; CUDA absent and not asked for the
    CPU raises), in ``config.dtype``, from the device's seeded
    generator."""

    def __init__(self, config: MoEConfig, device=None):
        device = resolve_device(device)
        super().__init__(dtype=config.dtype, device=device)
        self.config = config
        self.model = MoEModel(config, device=device)
        self.lm_head = Linear(config.hidden_size, config.vocab_size,
                              bias_attr=False, dtype=config.dtype,
                              device=device)

    @property
    def device(self) -> torch.device:
        return self._device

    def forward(self, input_ids):
        return self.lm_head(self.model(input_ids))

    def loss(self, input_ids, labels):
        """Fused chunked lm-head CE (the ``[T, V]`` fp32 logits are never
        whole) + ``aux_loss_alpha`` * the layers' load-balance losses
        (``moe_llm.py:201-215``)."""
        h = self.model(input_ids)
        d = h.shape[-1]
        ce = F.fused_linear_cross_entropy(h.reshape(-1, d),
                                          self.lm_head.weight,
                                          labels.reshape(-1))
        aux = self.model.aux_loss()
        if aux is None:
            return ce
        loss = ce + self.config.aux_loss_alpha * aux
        # the layers keep their aux losses' values, not their graphs: a
        # graph that outlives its step holds the parameters' gradient
        # accumulators, bound to the stream they were made on, which a
        # later CUDA graph capture (on its own stream) cannot wait on
        for layer in self.model.layers:
            if not layer.is_dense and layer.moe.aux_loss is not None:
                layer.moe.aux_loss = layer.moe.aux_loss.detach()
        return loss
