"""hapi of the port (``paddle_tpu.hapi``): the high-level ``Model`` and
its callbacks; ``summary`` / ``flops`` are in ``hapi/summary.py``."""

from paddle_tpu_torch.hapi.model import Model  # noqa: F401
from paddle_tpu_torch.hapi.callbacks import (  # noqa: F401
    Callback, EarlyStopping, LRScheduler, ModelCheckpoint, ProgBarLogger)

__all__ = ["Model", "Callback", "ProgBarLogger", "ModelCheckpoint",
           "EarlyStopping", "LRScheduler"]
