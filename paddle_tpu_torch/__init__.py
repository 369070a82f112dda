"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu.

The JAX package (``paddle_tpu``) is the reference; this package mirrors
its layout and names (``core/``, ``nn/``, ``models/llama.py``,
``inference/``, ``generation/``, ``optimizer/``, ``jit/``) and replaces
every Pallas TPU kernel on its path with a CUDA kernel written for
Hopper (``ops/kernels/``).  It imports torch and never jax, and nothing
of ``paddle_tpu``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
on the CPU every kernel wrapper takes its plain PyTorch version."""

from paddle_tpu_torch import optimizer
from paddle_tpu_torch.core.state import get_seed, resolve_device, seed
from paddle_tpu_torch.flags import get_flags, set_flags

__version__ = "0.1.0"

__all__ = ["seed", "get_seed", "resolve_device", "optimizer", "get_flags",
           "set_flags", "__version__"]
