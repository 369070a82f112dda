"""A body bound to static buffers: the port's counterpart of the JAX
package's ahead-of-time compiled serving and generation programs.

:class:`StaticGraph` owns one set of input tensors.  On CUDA it warms
the body up on a side stream, then captures it as one CUDA graph; each
call copies its arguments into the inputs and replays the graph.  On
the CPU there is no graph: each call runs the same body on the same
buffers, so the CPU tests hold the captured body.  A call whose
argument does not have the captured shape and dtype raises, as a JAX
compiled object does; nothing is recorded again behind the caller's
back.

Rules the capture keeps (as ``TrainStep.compile``): every
``_build.workspace`` / ``tickets`` buffer must exist before it (the
warm-up makes them; the capture runs under ``_build.frozen``, which
raises on growth) and the graph keeps every one it was handed; a
generator the body draws from is registered with the graph, and its
state is put back after the warm-up and the capture, so the first
replay draws what an eager call would have; the kernel wrappers' launch
counters move at the capture only (``launches``: what one replay
launches; ``replays`` counts the replays)."""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import torch

from paddle_tpu_torch.ops.kernels import _build

__all__ = ["StaticGraph"]


def launch_counts() -> Dict[str, int]:
    """Every kernel wrapper's launch count, by the wrapper's name."""
    from paddle_tpu_torch.ops import kernels
    return {fn.__name__: fn.launches for fn in kernels.KERNELS}


class StaticGraph:
    """``body(**inputs)`` bound to `inputs` (a dict of tensors, all on
    one device; the body reads them and may update them in place).

    `what` names the program in errors and in ``_build.frozen``;
    `generator` is the ``torch.Generator`` the body draws from, if any;
    `warmup` the eager runs before the capture (0 for a body of plain
    torch ops that makes no kernel buffer).  The warm-up runs on the
    inputs as given, so their initial values must make it harmless.
    ``seconds`` is the time the warm-up and the capture took."""

    def __init__(self, body: Callable, inputs: Dict[str, torch.Tensor],
                 what: str, generator: Optional[torch.Generator] = None,
                 warmup: int = 1):
        self.body = body
        self.inputs = inputs
        self.what = what
        self.graph = None
        self.out = None
        self.held = []
        self.launches: Dict[str, int] = {}
        self.replays = 0
        t0 = time.perf_counter()
        dev = next(iter(inputs.values())).device
        if dev.type == "cuda":
            self._capture(dev, generator, warmup)
        self.seconds = time.perf_counter() - t0

    def _capture(self, dev, gen, warmup):
        rng = gen.get_state() if gen is not None else None
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(warmup):
                self.body(**self.inputs)
        torch.cuda.current_stream(dev).wait_stream(side)
        if gen is not None:
            gen.set_state(rng)
        graph = torch.cuda.CUDAGraph()
        if gen is not None:
            graph.register_generator_state(gen)
        before = launch_counts()
        with _build.frozen(self.what) as held, torch.cuda.graph(graph):
            out = self.body(**self.inputs)
        after = launch_counts()
        torch.cuda.synchronize(dev)
        if gen is not None:
            gen.set_state(rng)
        self.graph, self.out, self.held = graph, out, list(held)
        self.launches = {k: after[k] - before[k] for k in after
                         if after[k] != before[k]}

    def __call__(self, **values):
        """Copy `values` (tensors or numpy arrays, by input name) into
        the inputs, then replay the graph (or run the body on the CPU);
        returns the body's result, which a later call overwrites."""
        if self.inputs is None:
            raise RuntimeError(f"{self.what}: the graph was closed")
        for name, value in values.items():
            dst = self.inputs[name]
            src = torch.as_tensor(value)
            if tuple(src.shape) != tuple(dst.shape) or \
                    src.dtype != dst.dtype:
                raise ValueError(
                    f"{self.what}: {name} is {tuple(src.shape)} "
                    f"{src.dtype}, captured as {tuple(dst.shape)} "
                    f"{dst.dtype}")
            dst.copy_(src)
        if self.graph is None:
            return self.body(**self.inputs)
        self.graph.replay()
        self.replays += 1
        return self.out

    def close(self):
        """Drop the graph, its result and every buffer it held."""
        self.graph = self.out = self.inputs = None
        self.held = []
