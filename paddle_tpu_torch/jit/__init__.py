"""Training step of the port (``paddle_tpu.jit``): ``TrainStep``.
``to_static``, ``save``/``load`` and the compiled-step machinery wait
(ROADMAP.md, queue 1)."""

from paddle_tpu_torch.jit.train_step import TrainStep

__all__ = ["TrainStep"]
