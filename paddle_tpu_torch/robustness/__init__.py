"""Robustness (``paddle_tpu.robustness``): the error the training step's
non-finite guard raises.  Fault injection and recovery wait (ROADMAP.md,
queue 1, item 9)."""

from paddle_tpu_torch.robustness.faults import NonFiniteStepError

__all__ = ["NonFiniteStepError"]
