"""The port's ``paddle_tpu.jit``: ``TrainStep``; ``StaticGraph``, a body
bound to static buffers (one CUDA graph on the card), which the serving
engine's ``aot_warmup`` and ``generate`` use; ``to_static`` with the
dy2static rewrite (``dy2static.py``); and ``save`` / ``load``, an
exported program of a Layer's pure function (``save_load.py``).

``to_static`` runs the converted body EAGERLY on the caller's device:
the port's eager path is its kernels, and its compiled forms are the
exported program (``save``) and ``StaticGraph``.  The JAX package's
``to_static`` compiles with XLA; this one does not (ROADMAP.md, queue
3).  Under ``torch.export`` the converted body's data-dependent control
flow becomes ``torch.cond`` / ``while_loop``."""

from __future__ import annotations

from paddle_tpu_torch.jit.save_load import (InputSpec, TranslatedLayer,
                                            load, save)
from paddle_tpu_torch.jit.static_graph import StaticGraph
from paddle_tpu_torch.jit.train_step import TrainStep

__all__ = ["TrainStep", "StaticGraph", "to_static", "save", "load",
           "InputSpec", "TranslatedLayer"]


def _coerce_to_specs(args, specs):
    """Honor ``input_spec``: validate each positional arg against its
    spec and coerce it to the spec's dtype (python scalars become
    tensors of that dtype on the default device).  Dims that are
    None/-1 are free; int dims must match."""
    import torch

    from paddle_tpu_torch.core.dtypes import to_torch
    from paddle_tpu_torch.core.state import resolve_device

    out = list(args)
    for i, spec in enumerate(specs):
        if i >= len(out) or not isinstance(spec, InputSpec):
            continue
        x = out[i]
        dev = x.device if torch.is_tensor(x) else resolve_device(None)
        arr = torch.as_tensor(x, dtype=to_torch(spec.dtype), device=dev)
        shape = tuple(arr.shape)
        if len(shape) != len(spec.shape):
            raise ValueError(
                f"to_static: argument {i} has rank {len(shape)}, "
                f"input_spec expects rank {len(spec.shape)} "
                f"(spec {spec}, got shape {shape})")
        for d, (got, want) in enumerate(zip(shape, spec.shape)):
            if want is None or (isinstance(want, int) and want < 0):
                continue
            if got != want:
                raise ValueError(
                    f"to_static: argument {i} dim {d} is {got}, "
                    f"input_spec pins it to {want} (spec {spec})")
        out[i] = arr
    return tuple(out)


def to_static(obj=None, input_spec=None, full_graph=True, analyze=None,
              shardings=None, **kwargs):
    """Decorator/function: a Layer's forward or a plain function with
    ``input_spec`` applied to its positional arguments (validated and
    coerced to each spec's dtype, ``_coerce_to_specs``).  A plain
    function goes through ``convert_to_static`` (its data-dependent
    ``if`` / ``while`` / ``for range`` become the dy2static helpers); a
    Layer's forward does not.  The call runs eagerly; ``__wrapped__`` is
    the target, which ``jit.save`` unwraps."""
    from paddle_tpu_torch.analysis.recompile import SignatureMonitor
    from paddle_tpu_torch.nn.layer import Layer

    if analyze is not None:
        raise NotImplementedError(
            "to_static(analyze=): not ported yet (ROADMAP.md, queue 1, "
            "item 10: program analysis)")
    if shardings is not None:
        raise NotImplementedError(
            "to_static(shardings=): not ported yet (ROADMAP.md, queue 1, "
            "item 8: distributed)")

    def wrap(target):
        name = getattr(target, "__name__", type(target).__name__)
        monitor = SignatureMonitor(name=name)
        specs = list(input_spec) if input_spec is not None else None
        if not isinstance(target, Layer) and callable(target):
            from paddle_tpu_torch.jit.dy2static import convert_to_static
            target = convert_to_static(target)

        def call(*a, **kw):
            if specs is not None:
                a = _coerce_to_specs(a, specs)
            if monitor.active:
                monitor.record(a, kw)
            return target(*a, **kw)
        call.__wrapped__ = target
        call._signature_monitor = monitor
        return call

    if obj is None:
        return wrap
    return wrap(obj)
