"""Robustness (``paddle_tpu.robustness``): the fault-injection registry
the serving fleet's chaos points run on, and the errors of the training
step's guard and of bounded admission.  Peer snapshots, SDC sentinels
and recovery (``recovery.py``) wait (ROADMAP.md, queue 1, item 9)."""

from paddle_tpu_torch.robustness.faults import (  # noqa: F401
    FaultRegistry, FaultSpec, InjectedFault, NonFiniteStepError,
    QueueFullError, clear_faults, fault_fires, fault_point, fault_registry,
    fault_stats, inject, reset_registry)

__all__ = [
    "FaultRegistry", "FaultSpec", "InjectedFault", "NonFiniteStepError",
    "QueueFullError", "clear_faults", "fault_fires", "fault_point",
    "fault_registry", "fault_stats", "inject", "reset_registry",
]
