"""Distributed pieces of the port (``paddle_tpu.distributed``): the
single-program Mixture-of-Experts layer.  Meshes, collectives and the
all_to_all expert dispatch wait in ROADMAP.md, queue 1."""

from paddle_tpu_torch.distributed.moe import (ExpertFFN, GShardGate,
                                              MoELayer, NaiveGate,
                                              SwitchGate, top_k_gating,
                                              top_k_gating_indices)

__all__ = ["MoELayer", "ExpertFFN", "NaiveGate", "SwitchGate", "GShardGate",
           "top_k_gating", "top_k_gating_indices"]
