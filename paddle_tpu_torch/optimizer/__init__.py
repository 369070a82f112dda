"""Optimizers of the port (``paddle_tpu.optimizer``) and their LR
schedulers (``optimizer.lr``)."""

from paddle_tpu_torch.optimizer import lr
from paddle_tpu_torch.optimizer.optimizer import Optimizer
from paddle_tpu_torch.optimizer.optimizers import (SGD, Adadelta, Adagrad,
                                                   Adam, Adamax, AdamW, Lamb,
                                                   Momentum, RMSProp)

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Adagrad",
           "RMSProp", "Adadelta", "Adamax", "Lamb", "lr"]
