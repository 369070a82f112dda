"""Framework utilities of the port (``paddle_tpu/framework/``):
``save`` / ``load`` (``io_.py``)."""

from paddle_tpu_torch.framework.io_ import load, save  # noqa: F401

__all__ = ["save", "load"]
