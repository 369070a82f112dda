"""ERNIE 4.5 text decoder (``paddle_tpu/models/ernie.py:202-225``): the
MoE decoder of ``models/moe_llm.py`` at ERNIE-4.5-21B-A3B's public shape.

The ERNIE 3.0 encoder classes of the same JAX module (``ErnieModel``,
``ErnieForSequenceClassification``, ``ErnieForMaskedLM``) wait in
``ROADMAP.md``, queue 1."""

from __future__ import annotations

from typing import Optional

from paddle_tpu_torch.models.moe_llm import MoEConfig, MoEForCausalLM

__all__ = ["ErnieForCausalLM", "ernie45_moe_config"]


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
