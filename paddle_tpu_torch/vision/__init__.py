"""``paddle_tpu_torch.vision`` (``paddle_tpu/vision/``): the model zoo
(``models``).  Datasets, transforms and the detection ops are not ported
yet (ROADMAP.md, queue 1, item 7.7)."""

from paddle_tpu_torch.vision import models  # noqa: F401

__all__ = ["models"]
