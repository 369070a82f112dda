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
launches; ``replays`` counts the replays).  ``warmup_s`` and
``capture_s`` time the two phases, and ``capture_bytes`` is the memory
the graph's private pool reserved during the capture, which the graph
keeps while it lives (:func:`pool_bytes`; the allocator's process-wide
peak is left alone, since a caller may be measuring over a larger
window); ``device_profiler.compile_static`` reports them as the JAX
package's lower and compile phases."""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, Optional

import torch

from paddle_tpu_torch.ops.kernels import _build

__all__ = ["StaticGraph", "pool_bytes"]


def launch_counts() -> Dict[str, int]:
    """Every kernel wrapper's launch count, by the wrapper's name."""
    from paddle_tpu_torch.ops import kernels
    return {fn.__name__: fn.launches for fn in kernels.KERNELS}


def pool_bytes(dev: torch.device, base: Optional[int] = None) -> int:
    """Without `base`: the bytes the allocator reserves on `dev` once its
    cache is emptied, as ``torch.cuda.graph`` empties it on entry.  With
    `base` (that first reading): what a capture since then reserved —
    its private pool, which the graph keeps as long as it lives."""
    torch.cuda.synchronize(dev)
    if base is None:
        torch.cuda.empty_cache()
        return torch.cuda.memory_reserved(dev)
    return max(0, torch.cuda.memory_reserved(dev) - base)


class StaticGraph:
    """``body(**inputs)`` bound to `inputs` (a dict of tensors, all on
    one device; the body reads them and may update them in place).

    `what` names the program in errors and in ``_build.frozen``;
    `generator` is the ``torch.Generator`` the body draws from, if any;
    `warmup` the eager runs before the capture (0 for a body of plain
    torch ops that makes no kernel buffer, or one a caller has already
    run).  The warm-up runs on the inputs as given, so their initial
    values must make it harmless.  ``seconds`` is the time the warm-up
    and the capture took; `phase`, if given, is called with ``"warmup"``
    (where there is a warm-up) and ``"capture"`` and returns the context
    each phase runs in (a tracing span)."""

    def __init__(self, body: Callable, inputs: Dict[str, torch.Tensor],
                 what: str, generator: Optional[torch.Generator] = None,
                 warmup: int = 1, phase: Optional[Callable] = None):
        self.body = body
        self.inputs = inputs
        self.what = what
        self.graph = None
        self.out = None
        self.held = []
        self.launches: Dict[str, int] = {}
        self.replays = 0
        self.warmup_s = self.capture_s = 0.0
        self.capture_bytes = 0
        phase = phase or (lambda name: contextlib.nullcontext())
        t0 = time.perf_counter()
        dev = next(iter(inputs.values())).device
        if dev.type == "cuda":
            self._capture(dev, generator, warmup, phase)
        else:
            with phase("capture"):
                pass
        self.seconds = time.perf_counter() - t0

    def _capture(self, dev, gen, warmup, phase):
        rng = gen.get_state() if gen is not None else None
        t0 = time.perf_counter()
        if warmup > 0:
            with phase("warmup"):
                side = torch.cuda.Stream(dev)
                side.wait_stream(torch.cuda.current_stream(dev))
                with torch.cuda.stream(side):
                    for _ in range(warmup):
                        self.body(**self.inputs)
                torch.cuda.current_stream(dev).wait_stream(side)
                torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
        if gen is not None:
            gen.set_state(rng)
        graph = torch.cuda.CUDAGraph()
        if gen is not None:
            graph.register_generator_state(gen)
        before = launch_counts()
        with phase("capture"):
            base = pool_bytes(dev)
            with _build.frozen(self.what) as held, torch.cuda.graph(graph):
                out = self.body(**self.inputs)
            self.capture_bytes = pool_bytes(dev, base)
        after = launch_counts()
        self.warmup_s, self.capture_s = t1 - t0, time.perf_counter() - t1
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
