"""The port's ``paddle_tpu.static`` (``paddle_tpu/static/__init__.py``):
the "static graph" user API.

Reference parity: ``paddle.static`` (Program/Executor user API,
python/paddle/static/).  What survives of the surface, as in the JAX
package:

* ``InputSpec`` — shape/dtype declaration (shared with jit.save)
* ``save_inference_model`` / ``load_inference_model`` — thin veneers over
  jit.save / jit.load producing the same artifacts
* ``static.nn`` — the layer-builder API (fc / conv2d / batch_norm /
  embedding / layer_norm) over a Program-like parameter scope with
  ``program_guard`` name reuse (static/nn.py)
* ``data`` — input placeholder declaration -> InputSpec

Deliberately absent, as in the JAX package: Program / Block / Executor
object graphs, append_op and the IR passes; here the exported program
of ``jit.save`` is that machinery.
"""

from __future__ import annotations

from paddle_tpu_torch.jit.save_load import InputSpec  # noqa: F401
from paddle_tpu_torch.static import nn  # noqa: F401
from paddle_tpu_torch.static.nn import (program_guard,  # noqa: F401
                                         reset_program)

__all__ = ["InputSpec", "save_inference_model", "load_inference_model",
           "nn", "data", "program_guard", "reset_program"]


def data(name: str, shape, dtype="float32", lod_level=0):
    """Reference ``static.data``: declare a graph input.  Returns an
    InputSpec consumable by to_static/jit.save."""
    return InputSpec(shape, dtype=dtype, name=name)


def save_inference_model(path_prefix: str, feed_vars, fetch_vars,
                         executor=None, program=None, **kwargs):
    """Reference signature parity.  `fetch_vars` must be (or wrap) a Layer
    — the deployable unit is a Layer, not a Program."""
    from paddle_tpu_torch.jit import save as jit_save
    from paddle_tpu_torch.nn.layer import Layer
    layer = kwargs.get("layer")
    if layer is None and isinstance(fetch_vars, Layer):
        layer = fetch_vars
    if layer is None:
        raise ValueError(
            "save_inference_model serializes a Layer: pass layer=<Layer> "
            "(the Program abstraction does not exist here)")
    return jit_save(layer, path_prefix, input_spec=feed_vars)


def load_inference_model(path_prefix: str, executor=None, **kwargs):
    """``jit.load``'s TranslatedLayer (``device=`` as ``jit.load``)."""
    from paddle_tpu_torch.jit import load as jit_load
    return jit_load(path_prefix, device=kwargs.get("device"))
