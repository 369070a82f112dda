"""Robustness (``paddle_tpu.robustness``): the fault-injection registry
the chaos points run on, the errors of the training step's guard and of
bounded admission, and fast recovery (``recovery.py``): peer snapshots
of the training state, SDC sentinels and the quarantine roster."""

from paddle_tpu_torch.robustness.faults import (  # noqa: F401
    FaultRegistry, FaultSpec, InjectedFault, NonFiniteStepError,
    QueueFullError, clear_faults, fault_fires, fault_point, fault_registry,
    fault_stats, inject, reset_registry)
from paddle_tpu_torch.robustness import recovery  # noqa: F401
from paddle_tpu_torch.robustness.recovery import (  # noqa: F401
    PeerSnapshotter, SDCSentinel, buddy_map, buddy_of,
    deterministic_replay, is_quarantined, params_digest,
    probe_quarantine, quarantine_host, quarantine_ttl_s,
    quarantined_hosts, restore_from_peers, resume_train_state)

__all__ = [
    "FaultRegistry", "FaultSpec", "InjectedFault", "NonFiniteStepError",
    "QueueFullError", "clear_faults", "fault_fires", "fault_point",
    "fault_registry", "fault_stats", "inject", "reset_registry",
    "recovery", "PeerSnapshotter", "SDCSentinel", "buddy_map", "buddy_of",
    "deterministic_replay", "is_quarantined", "params_digest",
    "probe_quarantine", "quarantine_host", "quarantine_ttl_s",
    "quarantined_hosts", "restore_from_peers", "resume_train_state",
]
