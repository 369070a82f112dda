"""Loss layers (``paddle_tpu/nn/loss_layers.py``)."""

from __future__ import annotations

from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.layer import Layer

__all__ = ["CrossEntropyLoss"]


class CrossEntropyLoss(Layer):
    """``F.cross_entropy`` with its options fixed at construction
    (``:14-26``): hard labels without a weight or smoothing take the
    fused softmax cross-entropy."""

    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 soft_label=False, axis=-1, use_softmax=True,
                 label_smoothing=0.0):
        super().__init__()
        self.weight = weight
        self.kw = dict(ignore_index=ignore_index, reduction=reduction,
                       soft_label=soft_label, axis=axis,
                       use_softmax=use_softmax,
                       label_smoothing=label_smoothing)

    def forward(self, input, label):
        return F.cross_entropy(input, label, weight=self.weight, **self.kw)
