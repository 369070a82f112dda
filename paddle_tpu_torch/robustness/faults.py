"""Fault types (``paddle_tpu/robustness/faults.py``).  Only the error of
the training step's guard is ported; the fault-injection registry waits
(ROADMAP.md, queue 1, item 9)."""

__all__ = ["NonFiniteStepError"]


class NonFiniteStepError(FloatingPointError):
    """TrainStep's anomaly guard exhausted its consecutive-skip budget:
    the loss/grads have been NaN/Inf for K straight steps — a persistent
    divergence, not a one-off bad microbatch."""
