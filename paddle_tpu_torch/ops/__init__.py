"""Operators of the port (``paddle_tpu/ops/``): the generated ops of the
op schema (``gen/ops.yaml`` -> ``generated_math.py``), the hand-written
op modules, and ``ops.kernels``, the CUDA kernels.  Every op is on the
hook (``core/dispatch.py``)."""

from paddle_tpu_torch.ops import (creation, linalg, logic, manipulation,  # noqa: F401
                                  math, random, search, stat)
