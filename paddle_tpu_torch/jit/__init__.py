"""Training step of the port (``paddle_tpu.jit``): ``TrainStep``, and
``StaticGraph``, a body bound to static buffers (one CUDA graph on the
card), which the serving engine's ``aot_warmup`` and ``generate`` use.
``to_static`` and ``save``/``load`` wait (ROADMAP.md, queue 1)."""

from paddle_tpu_torch.jit.static_graph import StaticGraph
from paddle_tpu_torch.jit.train_step import TrainStep

__all__ = ["TrainStep", "StaticGraph"]
