"""jit.save / jit.load — deployable artifacts
(``paddle_tpu/jit/save_load.py``).

Reference parity: ``paddle.jit.save`` (jit/api.py) writes ``model.pdmodel``
(ProgramDesc) + ``model.pdiparams``; ``paddle.jit.load`` returns a
``TranslatedLayer``; the serving side loads the same artifact.

The port's artifact is a ``torch.export`` program of the Layer's PURE
function, as the JAX package exports one with ``jax.export``:
``(params_tuple, *inputs) -> outputs`` through ``functional_call`` over
the sorted state-dict names, so the parameters are inputs of the graph
and not constants.  Three files:

* ``<path>.pdmodel`` — ``torch.export.save`` of that program (no
  weights; the non-persistable buffers, e.g. RoPE tables, are its
  constants);
* ``<path>.pdiparams.npz`` — the parameters under JAX's keys; bfloat16
  and float8 ones as their raw bits (numpy has no such dtype without
  ``ml_dtypes``), their dtypes in the meta's ``param_dtypes``;
* ``<path>.pdmeta`` — JAX's keys (``param_names``, ``input_names``,
  ``inputs`` with symbolic dims written as their names) and the port's
  own ``format``, ``platform``, ``param_dtypes``, ``graph_preview`` (in
  place of ``mlir_preview``) and the seconds the trace and the writes
  took (``export_s``, ``write_s``); there is no ``.pdstablehlo``.

The kernels are ``ptt::`` dispatcher ops with fakes
(``ops/kernels/*.py``), so an exported graph records each kernel as one
node, which launches the hand-written kernel when the loaded program
runs.  The program is bound to the platform it was traced on, as a
``jax.export`` artifact is: the routing (flash or plain attention, the
fused kernels or their plain versions) was decided at trace time, so a
CPU artifact, which holds the plain versions inline, is refused on the
card, and the reverse.  A dynamic dim (``None`` / ``-1``) is a
``torch.export.Dim``; axis 0 is one ``"batch"`` shared by every input
(JAX's rule).  A dynamic dim that a kernel's gate reads (flash's
sequence length) makes ``save`` raise: the route would depend on it.
"""

from __future__ import annotations

import io
import json
import os
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

__all__ = ["save", "load", "InputSpec", "TranslatedLayer"]

FORMAT = "torch-export-ptt-v1"
_DYNAMIC_EXAMPLE = 2          # an example size for a dynamic dim
# bfloat16 / float8 stored as their bits: the numpy view of each
_BITS = {torch.bfloat16: np.int16, torch.float8_e4m3fn: np.uint8,
         torch.float8_e5m2: np.uint8}


class InputSpec:
    """Reference ``paddle.static.InputSpec`` parity."""

    def __init__(self, shape: Sequence[Optional[int]], dtype="float32",
                 name: Optional[str] = None):
        self.shape = tuple(shape)
        self.dtype = dtype
        self.name = name

    def has_dynamic_dims(self) -> bool:
        return any(_dynamic(d) for d in self.shape)

    def dim_names(self, name_hint="x"):
        """Each dim as an int, or (dynamic) its symbol's name: ``"batch"``
        on axis 0, else ``f"{name_hint}_d{i}"`` (``InputSpec.to_sds``)."""
        return [("batch" if i == 0 else f"{name_hint}_d{i}")
                if _dynamic(d) else int(d) for i, d in enumerate(self.shape)]

    def __repr__(self):
        return f"InputSpec(shape={self.shape}, dtype={self.dtype})"


def _dynamic(d) -> bool:
    return d is None or (isinstance(d, int) and d < 0)


class _Pure(torch.nn.Module):
    """The Layer's pure function ``(params_tuple, *inputs)``.  The layer
    is held outside the module tree, so its weights are graph inputs and
    never the program's constants."""

    def __init__(self, layer, names, dyn_dims, symbols):
        super().__init__()
        object.__setattr__(self, "_layer", layer)
        self._names = names
        self._dyn_dims = dyn_dims     # [(input index, axis, name)]
        # symbol -> dim name, filled while tracing (export restores the
        # module's own attributes after the trace, so the dict is held
        # by a closure)
        self._note = lambda sym, name: symbols.__setitem__(sym, name)

    def forward(self, params, *inputs):
        from paddle_tpu_torch.core.functional import functional_call
        for i, axis, name in self._dyn_dims:
            size = inputs[i].shape[axis]
            if isinstance(size, torch.SymInt):
                self._note(str(size.node.expr), name)
        return functional_call(self._layer, dict(zip(self._names, params)),
                               *inputs)


def _example(spec, i, device, batch):
    """An example input for `spec` and its ``dynamic_shapes`` entry."""
    if isinstance(spec, InputSpec):
        from paddle_tpu_torch.core.dtypes import to_torch
        names = spec.dim_names(f"x{i}")
        shape = [_DYNAMIC_EXAMPLE if isinstance(n, str) else n
                 for n in names]
        dims = {a: (batch if a == 0 else torch.export.Dim(n))
                for a, n in enumerate(names) if isinstance(n, str)}
        return (torch.zeros(shape, dtype=to_torch(spec.dtype),
                            device=device), dims or None, names)
    t = spec if torch.is_tensor(spec) else torch.as_tensor(np.asarray(spec))
    t = t.detach().to(device)
    return t, None, list(t.shape)


def _param_bits(t: torch.Tensor) -> np.ndarray:
    t = t.detach().to("cpu").contiguous()
    view = _BITS.get(t.dtype)
    if view is not None:
        return t.view(torch.int16 if view == np.int16 else torch.uint8
                      ).numpy()
    return t.numpy()


def save(layer, path: str, input_spec: Optional[List] = None, **configs):
    """Serialize `layer` (or a to_static-wrapped Layer) for inference,
    traced on the device its parameters live on."""
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.core.dtypes import name_of
    from paddle_tpu_torch.core.functional import params_of
    from paddle_tpu_torch.nn.layer import Layer
    from paddle_tpu_torch.ops.kernels._build import GatedDimError

    target = getattr(layer, "__wrapped__", layer)
    if not isinstance(target, Layer):
        raise TypeError("jit.save expects a Layer (or to_static(Layer))")
    if input_spec is None:
        raise ValueError("jit.save requires input_spec (the program is "
                         "traced at these shapes; provide InputSpec / "
                         "example tensors)")
    if flags.get("check_nan_inf"):
        raise ValueError(
            "jit.save: FLAGS_check_nan_inf is on; its sweep reads every "
            "op's values, which a traced program does not have. Turn the "
            "flag off to export")
    params = params_of(target)
    param_names = sorted(params)
    device = next(iter(params.values())).device if params else \
        target._device
    batch = torch.export.Dim("batch")
    examples, dynamic, shapes, dyn_dims = [], [], [], []
    for i, spec in enumerate(input_spec):
        ex, dims, names = _example(spec, i, device, batch)
        examples.append(ex)
        dynamic.append(dims)
        shapes.append(names)
        dyn_dims += [(i, a, n) for a, n in enumerate(names)
                     if isinstance(n, str)]
    symbols = {}
    pure = _Pure(target, param_names, dyn_dims, symbols)
    args = (tuple(params[n] for n in param_names), *examples)
    t0 = time.perf_counter()
    try:
        with torch.no_grad():
            program = torch.export.export(
                pure, args,
                dynamic_shapes=((None,) * len(param_names), tuple(dynamic)))
    except GatedDimError as e:
        names = sorted({n for sym, n in symbols.items()
                        if sym in e.symbols}) or [d[2] for d in dyn_dims]
        raise ValueError(
            f"jit.save: dynamic dim {', '.join(names)} reaches a kernel's "
            f"gate ({e.gate}); the route would depend on its value. Pin "
            "it in the InputSpec (one artifact per signature)") from e

    export_s = time.perf_counter() - t0
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    # the example inputs are the parameters: not written into the program
    program.example_inputs = None
    # through a buffer: torch.export.save names its files *.pt2
    buf = io.BytesIO()
    torch.export.save(program, buf)
    with open(path + ".pdmodel", "wb") as f:
        f.write(buf.getbuffer())
    np.savez(path + ".pdiparams",
             **{n: _param_bits(params[n]) for n in param_names})
    input_names = []
    for i, spec in enumerate(input_spec):
        name = getattr(spec, "name", None)
        input_names.append(name if name else f"x{i}")
    meta = {
        "format": FORMAT,
        "platform": device.type,
        "param_names": param_names,
        "param_dtypes": {n: name_of(params[n].dtype) for n in param_names},
        "input_names": input_names,
        "inputs": [{"shape": s, "dtype": name_of(ex.dtype)}
                   for s, ex in zip(shapes, examples)],
        "graph_preview": str(program.graph)[:2000],
        "export_s": export_s,
        "write_s": time.perf_counter() - t0 - export_s,
    }
    with open(path + ".pdmeta", "w") as f:
        json.dump(meta, f, indent=2)
    return path


class TranslatedLayer:
    """Loaded inference layer (reference TranslatedLayer,
    jit/translated_layer.py): call like the original Layer.  Runs the
    exported program on the device its parameters were loaded to."""

    def __init__(self, program, params_tuple, meta, device):
        self._program = program
        self._module = program.module()
        self._params = params_tuple
        self._meta = meta
        self.device = device

    def __call__(self, *inputs):
        raw = tuple((x if torch.is_tensor(x) else
                     torch.from_numpy(np.ascontiguousarray(x))
                     ).to(self.device) for x in inputs)
        with torch.no_grad():
            return self._module(self._params, *raw)

    forward = __call__

    def eval(self):
        return self

    @property
    def input_specs(self):
        return self._meta["inputs"]


def _param_from(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    from paddle_tpu_torch.core.dtypes import to_torch
    dt = to_torch(dtype_name)
    t = torch.from_numpy(np.ascontiguousarray(arr))
    return t.view(dt) if dt in _BITS else t


def load(path: str, device=None) -> TranslatedLayer:
    """The artifact at `path` as a :class:`TranslatedLayer` with its
    parameters on `device` (the card unless the caller asks for the CPU,
    :func:`~paddle_tpu_torch.core.state.resolve_device`).  An artifact
    traced on another platform raises."""
    from paddle_tpu_torch.core.state import resolve_device
    # the ptt:: ops must be registered before the program is read
    import paddle_tpu_torch.ops.kernels  # noqa: F401
    dev = resolve_device(device)
    with open(path + ".pdmeta") as f:
        meta = json.load(f)
    if meta.get("format") != FORMAT:
        raise ValueError(f"jit.load: {path}.pdmeta is format "
                         f"{meta.get('format')!r}, not {FORMAT!r}")
    if meta["platform"] != dev.type:
        raise ValueError(
            f"jit.load: {path} was exported on {meta['platform']!r}; its "
            f"graph holds that platform's routes (a CPU artifact runs the "
            f"plain versions inline, bypassing every kernel), so it does "
            f"not run on {dev.type!r}. Export it on {dev.type!r}")
    with open(path + ".pdmodel", "rb") as f:
        program = torch.export.load(io.BytesIO(f.read()))
    with np.load(path + ".pdiparams.npz") as archive:
        params = tuple(
            _param_from(archive[n], meta["param_dtypes"][n]).to(dev)
            for n in meta["param_names"])
    return TranslatedLayer(program, params, meta, dev)
