"""Models of the port (``paddle_tpu.models``)."""

from paddle_tpu_torch.models.llama import (LlamaAttention, LlamaConfig,
                                           LlamaDecoderLayer,
                                           LlamaForCausalLM, LlamaMLP,
                                           LlamaModel)

__all__ = ["LlamaConfig", "LlamaAttention", "LlamaMLP", "LlamaDecoderLayer",
           "LlamaModel", "LlamaForCausalLM"]
