"""Models of the port (``paddle_tpu.models``)."""

from paddle_tpu_torch.models.llama import (LlamaAttention, LlamaConfig,
                                           LlamaDecoderLayer,
                                           LlamaForCausalLM, LlamaMLP,
                                           LlamaModel)
from paddle_tpu_torch.models.moe_llm import (MoEConfig, MoEDecoderLayer,
                                             MoEForCausalLM, MoEModel)
from paddle_tpu_torch.models.dit import DiT, DiTBlock, DiTConfig
from paddle_tpu_torch.models.ernie import (ErnieConfig, ErnieForCausalLM,
                                           ErnieForMaskedLM,
                                           ErnieForSequenceClassification,
                                           ErnieModel, ernie45_moe_config)
from paddle_tpu_torch.models.gpt import (GPTAttention, GPTConfig,
                                         GPTDecoderLayer, GPTForCausalLM,
                                         GPTMLP, GPTModel)

__all__ = ["LlamaConfig", "LlamaAttention", "LlamaMLP", "LlamaDecoderLayer",
           "LlamaModel", "LlamaForCausalLM",
           "MoEConfig", "MoEDecoderLayer", "MoEModel", "MoEForCausalLM",
           "DiTConfig", "DiTBlock", "DiT",
           "ErnieConfig", "ErnieModel", "ErnieForSequenceClassification",
           "ErnieForMaskedLM", "ErnieForCausalLM", "ernie45_moe_config",
           "GPTConfig", "GPTAttention", "GPTMLP", "GPTDecoderLayer",
           "GPTModel", "GPTForCausalLM"]
