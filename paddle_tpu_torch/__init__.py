"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu.

The JAX package (``paddle_tpu``) is the reference; this package mirrors
its layout and names (``core/``, ``ops/``, ``nn/``, ``amp/``,
``models/llama.py``, ``inference/``, ``generation/``, ``optimizer/``,
``jit/``) and replaces every Pallas TPU kernel on its path with a CUDA
kernel written for Hopper (``ops/kernels/``).  It imports torch and
never jax, and nothing of ``paddle_tpu``.

The top level is JAX's (``paddle_tpu/__init__.py:12-39``): the dtype
names, the op surface (the generated ops, then the hand-written op
modules over them, in JAX's order, so each name is the same op), the
``linalg`` and ``fft`` namespaces, ``amp``, ``autograd`` and ``grad``,
``framework``, ``hapi`` with ``Model``, ``summary`` and ``flops``, ``io``,
``jit`` (``to_static``, ``save`` / ``load``), ``metric``, ``text``,
``static``, ``set_device`` / ``get_device``, ``save`` / ``load``.  Ops
take and return ``torch.Tensor``s;
the names of the op surface that ``torch.Tensor`` lacks are installed on
it as methods (``core/tensor_methods.py``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
or calls ``set_device("cpu")``; on the CPU every kernel wrapper takes
its plain PyTorch version."""

from paddle_tpu_torch import optimizer
from paddle_tpu_torch.core.dtypes import (  # noqa: F401
    bfloat16, bool_, complex64, complex128, float16, float32, float64,
    int8, int16, int32, int64, uint8,
)
from paddle_tpu_torch.core.state import (get_default_dtype, get_rng_state,
                                         get_seed, resolve_device, seed,
                                         set_default_dtype, set_rng_state)
from paddle_tpu_torch.core.tensor import (Parameter, enable_grad,
                                          is_grad_enabled, no_grad,
                                          set_grad_enabled)
from paddle_tpu_torch.flags import get_flags, set_flags

# op surface → top level (paddle parity, JAX's order)
from paddle_tpu_torch.ops.creation import *  # noqa: F401,F403,E402
from paddle_tpu_torch.ops.creation import to_tensor  # noqa: F401,E402
from paddle_tpu_torch.ops import linalg  # noqa: F401,E402
from paddle_tpu_torch.ops.math import *  # noqa: F401,F403,E402
from paddle_tpu_torch.ops.linalg import *  # noqa: F401,F403,E402
from paddle_tpu_torch.ops.manipulation import *  # noqa: F401,F403,E402
from paddle_tpu_torch.ops.array_ops import (  # noqa: F401,E402
    array_length, array_read, array_write, create_array,
)
from paddle_tpu_torch.ops.logic import *  # noqa: F401,F403,E402
from paddle_tpu_torch.ops.search import *  # noqa: F401,F403,E402
from paddle_tpu_torch.ops.stat import *  # noqa: F401,F403,E402
from paddle_tpu_torch.ops.random import (  # noqa: F401,E402
    bernoulli, multinomial, normal, poisson, rand, rand_like, randint,
    randint_like, randn, randn_like, randperm, standard_normal, uniform,
)

# the op surface as torch.Tensor methods, where torch has no such name
import paddle_tpu_torch.core.tensor_methods  # noqa: F401,E402

from paddle_tpu_torch import amp  # noqa: F401,E402
from paddle_tpu_torch import autograd  # noqa: F401,E402
# `import` (not `from ... import`): the generated top-level `fft` OP is
# already bound on the package; importing the submodule rebinds the
# attribute to the module (paddle.fft is the namespace, paddle.fft.fft
# the transform), as in the JAX package
import paddle_tpu_torch.fft  # noqa: F401,E402
from paddle_tpu_torch import framework  # noqa: F401,E402
from paddle_tpu_torch import hapi  # noqa: F401,E402
from paddle_tpu_torch.hapi import Model  # noqa: F401,E402
from paddle_tpu_torch.hapi.summary import flops, summary  # noqa: F401,E402
from paddle_tpu_torch import io  # noqa: F401,E402
from paddle_tpu_torch import jit  # noqa: F401,E402
from paddle_tpu_torch import metric  # noqa: F401,E402
from paddle_tpu_torch import text  # noqa: F401,E402
from paddle_tpu_torch import static  # noqa: F401,E402
from paddle_tpu_torch.device import get_device, set_device  # noqa: F401,E402
from paddle_tpu_torch.framework.io_ import load, save  # noqa: F401,E402
from paddle_tpu_torch.autograd import grad  # noqa: F401,E402

__version__ = "0.1.0"
