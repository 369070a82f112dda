"""Device-time profiler and roofline-gap attribution
(``paddle_tpu/observability/device_profiler.py``).

The host spans (tracing.py) stop at the dispatch boundary:
``train.dispatch`` says the step took 212 ms, not which op group inside
it did.  Four pieces close that gap, under the JAX package's names:

* **Compile observability** — :func:`compile_static` (and
  :func:`aot_compile` over a function and its arguments) binds a program
  to static buffers (``jit/static_graph.py``: a CUDA graph on the card)
  under the JAX package's ``compile.lower`` (the warm-up, whose first
  run the cost model counts) and ``compile.xla`` (the capture) spans,
  counts compiles per target
  (``paddle_tpu_compile_total{target}``) and records a
  :class:`CompileInfo`: its FLOPs and bytes are the cost model's count of
  one run, its peak bytes what the capture's memory pool reserved, and
  they land in the ``paddle_tpu_xla_flops`` / ``_xla_bytes_accessed`` /
  ``_xla_peak_bytes`` gauges (the JAX package's names, which the
  watchdog reads).  ``TrainStep.compile`` records its own through
  :func:`observe_compile`; the serving engine's ``aot_warmup`` and
  ``generate``'s runs capture through :func:`compile_static`.

* **Device timing** — :class:`DeviceProfiler` captures named segments of
  a step (op groups: rmsnorm, attention, MLP, lm-head + CE, ...) through
  :func:`aot_compile` and times their replays with CUDA events (the
  minimum of ``reps``); on the CPU it times the same bodies with the host
  clock, and every report names its device.  A segment that cannot be
  captured is listed with its error in ``AttributionResult.skipped``.
  :func:`capture_xla_trace` (the JAX package's name) records a
  ``torch.profiler`` chrome trace.  Each timed segment is a
  ``device.<name>`` child span of the enclosing step span.

* **Roofline-gap attribution** — each segment's measured time against
  the cost model's roofline ``max(flops / peak, bytes / bw)``: the
  **gap** (measured / predicted) ranks the fusion targets.  The count's
  bytes are unfused, so a memory-bound segment whose intermediates stay
  in the L2 cache can read a gap below 1.

* **Memory accounting** — :class:`DeviceMemoryMonitor` samples live
  bytes (``torch.cuda.memory_allocated`` on the card, which needs no
  sync; the live tensors ``gc`` finds on the CPU) into
  ``paddle_tpu_device_live_bytes`` and a monotone watermark gauge,
  groups live tensors by shape and dtype (:meth:`census`) and fires
  ``paddle_tpu_device_memory_leak_total`` when live bytes grow strictly
  for a whole window.

Rooflines: an NVIDIA H100 is (989e12 bf16 FLOP/s, 3.35e12 B/s);
``PADDLE_TPU_PEAK_FLOPS`` / ``PADDLE_TPU_HBM_BW`` override; another
card with no override raises; the CPU gets a host roofline, named as
such.  ``PADDLE_TPU_DEVICE_WATERMARK`` (default on for a model on the
card, off on the CPU, where a sample walks the heap) and
``PADDLE_TPU_WATERMARK_INTERVAL`` (default 1) control the per-step
sampling ``TrainStep`` does."""

from __future__ import annotations

import dataclasses
import gc
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from paddle_tpu_torch.core.state import resolve_device

__all__ = ["ExecutableStats", "CompileInfo", "aot_compile", "compile_static",
           "compiled_stats",
           "compile_records", "record_compile_info", "observe_compile",
           "signature_of", "detect_roofline", "roofline_source",
           "Segment", "SegmentReport", "AttributionResult", "DeviceProfiler",
           "segment_records", "record_segment_report",
           "DeviceMemoryMonitor", "device_memory_monitor",
           "llama_step_segments", "capture_xla_trace"]

# dense bf16 peak FLOP/s and HBM bytes/s by card (NVIDIA data sheets),
# matched against torch.cuda.get_device_name in lower case
GPU_ROOFLINES: Dict[str, Tuple[float, float]] = {
    "h100": (989e12, 3.35e12),
}
# the CPU: a laptop-class core; what a CPU run can rank is which group is
# furthest from ITS roofline, never a device utilisation
_HOST_ROOFLINE = (2e11, 5e10)


def _env_roofline():
    peak = os.environ.get("PADDLE_TPU_PEAK_FLOPS")
    bw = os.environ.get("PADDLE_TPU_HBM_BW")
    return (float(peak) if peak else None, float(bw) if bw else None)


def detect_roofline(device=None, fallback: Optional[Tuple[float, float]]
                    = None) -> Tuple[float, float]:
    """(peak_flops, hbm_bytes_per_s) of `device` (default: the CUDA
    card; a CPU device gets the host roofline).  The environment
    overrides either number; `fallback` answers for a card not in the
    table.  A CUDA card not in the table, with neither overrides for both
    numbers nor a fallback, raises: its roofline is unknown."""
    dev = resolve_device(device)
    env_peak, env_bw = _env_roofline()
    if dev.type == "cuda":
        name = torch.cuda.get_device_name(dev).lower()
        found = next((v for k, v in GPU_ROOFLINES.items() if k in name),
                     None)
        if found is None:
            found = fallback
        if found is None:
            if env_peak is None or env_bw is None:
                raise RuntimeError(
                    f"no roofline for {torch.cuda.get_device_name(dev)!r}: "
                    "set PADDLE_TPU_PEAK_FLOPS and PADDLE_TPU_HBM_BW")
            found = (env_peak, env_bw)
    else:
        found = _HOST_ROOFLINE
    peak = env_peak if env_peak is not None else found[0]
    bw = env_bw if env_bw is not None else found[1]
    return float(peak), float(bw)


def roofline_source(device=None) -> str:
    """What :func:`detect_roofline` read the numbers for: the card's name,
    or ``"host (not a device roofline)"`` for the CPU."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return "host (not a device roofline)"


def device_name(device) -> str:
    """The name a report carries: the card's, or ``"cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return dev.type


# -- compile records ----------------------------------------------------------
@dataclasses.dataclass
class ExecutableStats:
    """What is known of a compiled program: the cost model's FLOPs and
    bytes of one run (``flops``, ``bytes_accessed``) and the memory its
    capture's private pool reserved (``peak_allocated``,
    ``static_graph.pool_bytes``).  The JAX package's XLA buffer fields
    stay, at 0."""

    flops: float = 0.0
    bytes_accessed: float = 0.0
    transcendentals: float = 0.0
    argument_bytes: int = 0
    output_bytes: int = 0
    temp_bytes: int = 0
    alias_bytes: int = 0
    code_bytes: int = 0
    peak_allocated: int = 0

    @property
    def peak_bytes(self) -> int:
        """The capture's pool (JAX: arguments + outputs + temporaries,
        aliased bytes once)."""
        if self.peak_allocated:
            return int(self.peak_allocated)
        return max(0, self.argument_bytes + self.output_bytes
                   + self.temp_bytes - self.alias_bytes)


def compiled_stats(compiled, cost=None) -> ExecutableStats:
    """The :class:`ExecutableStats` of a ``StaticGraph`` (what
    :func:`compile_static` and :func:`aot_compile` return): `cost`'s
    FLOPs and bytes (the cost model's count of one run, a counter or its
    summary; zeros without one) and the memory its capture reserved."""
    return ExecutableStats(
        flops=float(cost.total_flops) if cost else 0.0,
        bytes_accessed=float(cost.total_bytes) if cost else 0.0,
        peak_allocated=int(compiled.capture_bytes))


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _structure(tree) -> str:
    if isinstance(tree, dict):
        return "{" + ",".join(f"{k}:{_structure(tree[k])}"
                              for k in sorted(tree)) + "}"
    if isinstance(tree, tuple):
        return "(" + ",".join(_structure(t) for t in tree) + ")"
    if isinstance(tree, list):
        return "[" + ",".join(_structure(t) for t in tree) + "]"
    return "*"


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _leaves(t)
    else:
        yield tree


def signature_of(tree) -> str:
    """The tree's structure and each leaf's ``dtype[shape]`` — what a
    compiled program is fixed to (the JAX package's executable-cache
    key)."""
    parts = []
    for leaf in _leaves(tree):
        if hasattr(leaf, "shape") and hasattr(leaf, "dtype"):
            parts.append(f"{_dtype_name(leaf.dtype)}{list(leaf.shape)}")
        else:
            try:
                parts.append(f"{np.result_type(leaf)}{list(np.shape(leaf))}")
            except Exception:
                parts.append(type(leaf).__name__)
    return f"{_structure(tree)}|{';'.join(parts)}"


@dataclasses.dataclass
class CompileInfo:
    """One compile: its target, the argument signature, the phases'
    seconds (``lower_s``: the count and the warm-up; ``compile_s``: the
    capture) and the program's :class:`ExecutableStats`; whether a CUDA
    graph was captured and the kernel launches one replay makes, by
    wrapper.  ``cached`` is the persistent compile cache's hit flag
    (``compile_cache.py``: the program was captured from its entry,
    without the counted warm-up; ``compile_s`` is the load-and-capture
    wall time)."""

    target: str
    signature: str
    lower_s: float
    compile_s: float
    stats: ExecutableStats
    cached: bool = False
    graph: bool = False
    launches: Dict[str, int] = dataclasses.field(default_factory=dict)
    cost: Any = None

    @property
    def total_s(self) -> float:
        return self.lower_s + self.compile_s

    @property
    def seconds(self) -> float:
        """Both phases' seconds (``total_s``)."""
        return self.total_s


_COMPILE_LOG: deque = deque(maxlen=512)
_COMPILE_LOCK = threading.Lock()


def record_compile_info(info: CompileInfo):
    """Append a record to the compile log without moving the compile
    counter (the JAX package's cache-hit path)."""
    with _COMPILE_LOCK:
        _COMPILE_LOG.append(info)


def compile_records(target: Optional[str] = None) -> List[CompileInfo]:
    """Recent :class:`CompileInfo` entries (optionally one target's)."""
    with _COMPILE_LOCK:
        records = list(_COMPILE_LOG)
    if target is not None:
        records = [r for r in records if r.target == target]
    return records


def _compile_metrics(registry=None):
    if registry is None:
        from paddle_tpu_torch.observability.metrics import default_registry
        registry = default_registry()
    return {
        "compiles": registry.counter(
            "paddle_tpu_compile_total",
            "explicit XLA compiles (trace+lower+compile) per target",
            labelnames=("target",)),
        "seconds": registry.histogram(
            "paddle_tpu_compile_seconds",
            "wall time of compile phases (lower = trace+StableHLO, "
            "xla = backend compile)", labelnames=("phase",)),
        "flops": registry.gauge(
            "paddle_tpu_xla_flops",
            "XLA cost_analysis FLOPs of the most recent compile of this "
            "executable", labelnames=("executable",)),
        "bytes": registry.gauge(
            "paddle_tpu_xla_bytes_accessed",
            "XLA cost_analysis bytes accessed (post-fusion HBM traffic)",
            labelnames=("executable",)),
        "peak": registry.gauge(
            "paddle_tpu_xla_peak_bytes",
            "peak device-memory footprint (args + outputs + temps) of "
            "this executable", labelnames=("executable",)),
    }


def observe_compile(info: CompileInfo, registry=None):
    """Log `info` and move the compile series: the counter under its
    target, the phase histogram (``lower``, ``xla``), the FLOPs / bytes /
    peak gauges, and a ``compile`` flight-recorder event."""
    metrics = _compile_metrics(registry)
    record_compile_info(info)
    metrics["compiles"].labels(target=info.target).inc()
    metrics["seconds"].labels(phase="lower").observe(info.lower_s)
    metrics["seconds"].labels(phase="xla").observe(info.compile_s)
    st = info.stats
    if st.flops:
        metrics["flops"].labels(executable=info.target).set(st.flops)
    if st.bytes_accessed:
        metrics["bytes"].labels(executable=info.target).set(
            st.bytes_accessed)
    if st.peak_bytes:
        metrics["peak"].labels(executable=info.target).set(st.peak_bytes)
    from paddle_tpu_torch.observability.recorder import flight_recorder
    flight_recorder().record("compile", target=info.target,
                             lower_s=round(info.lower_s, 4),
                             compile_s=round(info.compile_s, 4),
                             flops=st.flops)


def _bind(args, kwargs):
    """The tensor leaves of (args, kwargs) as named inputs, and a
    function that rebuilds (args, kwargs) from such inputs."""
    inputs: Dict[str, torch.Tensor] = {}

    def walk(tree, path):
        if isinstance(tree, torch.Tensor):
            inputs[path] = tree
            return lambda got: got[path]
        if isinstance(tree, dict):
            parts = {k: walk(v, f"{path}.{k}") for k, v in tree.items()}
            return lambda got: {k: f(got) for k, f in parts.items()}
        if isinstance(tree, (list, tuple)):
            parts = [walk(v, f"{path}.{i}") for i, v in enumerate(tree)]
            kind = type(tree)
            return lambda got: kind(f(got) for f in parts)
        return lambda got: tree
    rebuild = walk((tuple(args), dict(kwargs)), "a")
    return inputs, rebuild


def compile_static(body: Callable, inputs: Dict[str, torch.Tensor],
                   target: str, generator=None, warmup: int = 1,
                   registry=None, signature: Optional[str] = None,
                   what: Optional[str] = None):
    """``StaticGraph(body, inputs)`` (``jit/static_graph.py``) under the
    JAX package's compile spans: ``compile`` > ``compile.lower`` (the
    warm-up: its first run, on the card and on the CPU, is one eager run
    counted by the cost model, the generator's state put back after it)
    and ``compile.xla`` (the capture).  Records its :class:`CompileInfo`
    under `target` and moves the compile series (:func:`observe_compile`).
    A program with no warm-up (``warmup=0``) is not counted: its stats
    are zeros.  `what` names the graph in errors (default: the target's
    capture).  Returns ``(StaticGraph, CompileInfo)``."""
    from paddle_tpu_torch.analysis.passes.cost_model import count_cost
    from paddle_tpu_torch.jit.static_graph import StaticGraph
    from paddle_tpu_torch.observability.tracing import tracer
    tr = tracer()
    phases = {"warmup": "compile.lower", "capture": "compile.xla"}
    run = None
    with tr.span("compile", target=target):
        t0 = time.perf_counter()
        if warmup > 0:
            with tr.span("compile.lower", target=target):
                rng = generator.get_state() if generator is not None \
                    else None
                _, run = count_cost(body, **inputs)
                if generator is not None:
                    generator.set_state(rng)
        counted_s = time.perf_counter() - t0
        graph = StaticGraph(body, inputs, what or f"{target}'s capture",
                            generator=generator, warmup=max(0, warmup - 1),
                            phase=lambda p: tr.span(phases[p],
                                                    target=target))
    info = CompileInfo(target=target,
                       signature=signature or signature_of(inputs),
                       lower_s=counted_s + graph.warmup_s,
                       compile_s=graph.capture_s,
                       stats=compiled_stats(graph, run),
                       graph=graph.graph is not None,
                       launches=dict(graph.launches),
                       cost=run.summary() if run else None)
    observe_compile(info, registry)
    return graph, info


def aot_compile(fn: Callable, *args, target: str = "fn", registry=None,
                warmup: int = 1, generator=None, **kwargs):
    """Count, warm up and capture ``fn(*args, **kwargs)``
    (:func:`compile_static`, with at least one warm-up so the program is
    counted): the tensor leaves of the arguments become the graph's
    inputs, the count's FLOPs and bytes the record's stats.  Returns
    ``(StaticGraph, CompileInfo)``; call the first with no argument to
    replay (or, on the CPU, run) the program on the same arguments."""
    inputs, rebuild = _bind(args, kwargs)
    if not inputs:
        raise ValueError(f"aot_compile {target}: no tensor argument")

    def body(**got):
        a, kw = rebuild(got)
        return fn(*a, **kw)

    return compile_static(
        body, inputs, target, generator=generator, warmup=max(1, warmup),
        registry=registry, signature=signature_of((tuple(args), kwargs)))


def capture_xla_trace(fn: Callable[[], Any],
                      logdir: Optional[str] = None) -> Optional[str]:
    """A ``torch.profiler`` chrome trace of ``fn()`` (the CPU activity,
    and the card's where ``fn`` runs there), written to
    ``<logdir>/trace.json``; returns `logdir` (a new temporary directory
    by default).  The JAX package's name for its XPlane capture."""
    import tempfile
    from torch.profiler import ProfilerActivity, profile
    if logdir is None:
        logdir = tempfile.mkdtemp(prefix="paddle_tpu_trace_")
    os.makedirs(logdir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    return logdir


# -- segment timing + roofline-gap attribution -------------------------------
@dataclasses.dataclass
class Segment:
    """One instrumented segment of a step: a function and the arguments
    it runs on.  ``count`` is how often the op group occurs in a full
    step (L attention calls a forward, ...)."""

    name: str
    fn: Callable
    args: tuple
    kwargs: dict = dataclasses.field(default_factory=dict)
    count: int = 1
    group: str = "op"


@dataclasses.dataclass
class SegmentReport:
    """Measured against predicted roofline of one segment.  ``flops`` /
    ``bytes_accessed`` and ``model_flops`` / ``model_bytes`` are both the
    cost model's count here (the JAX package's first pair is XLA's);
    ``device`` names where it ran; ``heaviest`` is the operator or
    kernel the count charged the most bytes."""

    name: str
    count: int
    group: str
    device_s: float
    compile_s: float
    flops: float
    bytes_accessed: float
    peak_bytes: int
    model_flops: float
    model_bytes: float
    predicted_s: float
    gap: float
    bound: str
    device: str = ""
    heaviest: str = ""

    @property
    def total_device_s(self) -> float:
        return self.device_s * self.count

    @property
    def excess_s(self) -> float:
        """Time above roofline across all occurrences."""
        return max(0.0, self.device_s - self.predicted_s) * self.count

    def to_dict(self) -> dict:
        return {"name": self.name, "count": self.count, "group": self.group,
                "device_ms": self.device_s * 1e3,
                "predicted_ms": self.predicted_s * 1e3,
                "gap": self.gap, "bound": self.bound,
                "excess_ms": self.excess_s * 1e3,
                "flops": self.flops, "bytes_accessed": self.bytes_accessed,
                "peak_bytes": self.peak_bytes,
                "compile_s": self.compile_s, "device": self.device,
                "heaviest": self.heaviest}


@dataclasses.dataclass
class AttributionResult:
    """Every profiled segment with its measured time, roofline time and
    gap; ``skipped`` the segments that could not be captured, with their
    errors; ``device`` where they ran."""

    segments: List[SegmentReport]
    peak_flops: float
    hbm_bw: float
    xla_trace_dir: Optional[str] = None
    skipped: List[Tuple[str, str]] = dataclasses.field(default_factory=list)
    device: str = ""
    roofline: str = ""

    def ranked(self) -> List[SegmentReport]:
        """Furthest below roofline first: the fusion target list."""
        return sorted(self.segments, key=lambda s: -s.gap)

    def to_dicts(self, top: Optional[int] = None) -> List[dict]:
        rows = [s.to_dict() for s in self.ranked()]
        return rows[:top] if top else rows

    def table(self) -> str:
        lines = [
            "-- roofline-gap attribution (measured device time vs "
            "predicted roofline) --",
            f"{'segment':20s} {'n':>3s} {'device(ms)':>11s} "
            f"{'roofline(ms)':>13s} {'gap':>8s} {'bound':>8s} "
            f"{'excess(ms)':>11s}"]
        for s in self.ranked():
            gap = f"{s.gap:8.2f}" if s.gap != float("inf") else "     inf"
            lines.append(
                f"{s.name:20s} {s.count:3d} {s.device_s * 1e3:11.3f} "
                f"{s.predicted_s * 1e3:13.4f} {gap} {s.bound:>8s} "
                f"{s.excess_s * 1e3:11.3f}")
        for name, err in self.skipped:
            lines.append(f"{name:20s} skipped: {err}")
        lines.append(
            f"device: {self.device}; roofline ({self.roofline}): "
            f"{self.peak_flops / 1e12:.1f} TFLOP/s, "
            f"{self.hbm_bw / 1e9:.0f} GB/s; gap = measured/roofline "
            "(unfused model bytes -> predicted is conservative); rank "
            "order = fusion target list")
        return "\n".join(lines)


_SEGMENT_BUCKETS = (1e-5, 2.5e-5, 1e-4, 2.5e-4, 1e-3, 2.5e-3, 1e-2,
                    2.5e-2, 0.1, 0.25, 1.0, 2.5, 10.0)

_SEGMENT_LOG: deque = deque(maxlen=512)
_SEGMENT_LOCK = threading.Lock()


def record_segment_report(report: SegmentReport):
    """Append a row to the process-wide segment log."""
    with _SEGMENT_LOCK:
        _SEGMENT_LOG.append(report)


def segment_records(name: Optional[str] = None) -> List[SegmentReport]:
    """Recent :class:`SegmentReport` rows of every profiler in the
    process (optionally one segment's)."""
    with _SEGMENT_LOCK:
        records = list(_SEGMENT_LOG)
    if name is not None:
        records = [r for r in records if r.name == name]
    return records


def _primary_shape_dtype(args) -> Tuple[tuple, str]:
    """The ledger key's shape and dtype of a segment: its highest-rank
    tensor leaf (ties: the larger), as the JAX package picks it."""
    best = None
    for leaf in _leaves(args):
        shape = getattr(leaf, "shape", None)
        dtype = getattr(leaf, "dtype", None)
        if shape is None or dtype is None:
            continue
        size = 1
        for dim in shape:
            size *= max(1, int(dim))
        rank = len(shape)
        if best is None or (rank, size) > (best[0], best[1]):
            best = (rank, size, tuple(int(d) for d in shape),
                    _dtype_name(dtype))
    if best is None:
        return (), ""
    return best[2], best[3]


def _device_of(args) -> torch.device:
    for leaf in _leaves(args):
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    raise ValueError("a segment needs a tensor argument")


class DeviceProfiler:
    """Times segments of a step on the device and attributes the
    roofline gap per op group.

        prof = DeviceProfiler()                 # the card's roofline
        for seg in llama_step_segments(model, batch):
            prof.add(seg)
        result = prof.profile(reps=3)
        print(result.table())

    `device` picks the roofline (``cuda`` unless given; ``"cpu"`` the
    host's); each segment runs where its tensors are."""

    def __init__(self, peak_flops: Optional[float] = None,
                 hbm_bw: Optional[float] = None, registry=None, device=None):
        self.device = resolve_device(device)
        if not (peak_flops and hbm_bw):
            det_peak, det_bw = detect_roofline(self.device)
            peak_flops = peak_flops or det_peak
            hbm_bw = hbm_bw or det_bw
        self.peak_flops = float(peak_flops)
        self.hbm_bw = float(hbm_bw)
        self._segments: List[Segment] = []
        if registry is None:
            from paddle_tpu_torch.observability.metrics import \
                default_registry
            registry = default_registry()
        self._registry = registry
        self._records: List[SegmentReport] = []
        self._seg_hist = registry.histogram(
            "paddle_tpu_device_segment_seconds",
            "measured per-call device time of profiled step segments",
            labelnames=("segment",), buckets=_SEGMENT_BUCKETS)

    def add(self, segment: Segment) -> "DeviceProfiler":
        self._segments.append(segment)
        return self

    def add_segment(self, name: str, fn: Callable, *args, count: int = 1,
                    group: str = "op", **kwargs) -> "DeviceProfiler":
        return self.add(Segment(name, fn, args, kwargs, count, group))

    def records(self, name: Optional[str] = None) -> List[SegmentReport]:
        """Every row this profiler measured (optionally one segment's)."""
        records = list(self._records)
        if name is not None:
            records = [r for r in records if r.name == name]
        return records

    def _feed_ledger(self, seg: Segment, report: SegmentReport):
        """With ``PADDLE_TPU_CALIBRATION=1`` every measured segment lands
        in the measurement ledger with its roofline prediction, keyed by
        its activation shape and the fusion tier active when it was
        measured (``tier=<fused_block_tier()>``), so ``decoder_block``
        under ``segments`` and ``decoder_block_fused`` under ``decoder``
        are separate populations the ``measured`` tier compares."""
        from paddle_tpu_torch.observability import calibration
        if not calibration.enabled():
            return
        from paddle_tpu_torch.ops.kernels.fused_block import \
            fused_block_tier
        shape, dtype = _primary_shape_dtype(seg.args)
        calibration.ledger().record(
            seg.name, shape, dtype, measured_s=report.device_s,
            predicted_s=report.predicted_s,
            layout=f"tier={fused_block_tier()}",
            provenance="device_profiler", save=False)

    @staticmethod
    def _time(compiled, dev, reps: int, warmup: int) -> float:
        """The fastest of `reps` runs: CUDA events around each replay on
        the card, the host clock on the CPU."""
        for _ in range(max(0, warmup)):
            compiled()
        times = []
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            for _ in range(max(1, reps)):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                compiled()
                e1.record()
                e1.synchronize()
                times.append(e0.elapsed_time(e1) * 1e-3)
        else:
            for _ in range(max(1, reps)):
                t0 = time.perf_counter()
                compiled()
                times.append(time.perf_counter() - t0)
        return min(times)

    def profile(self, reps: int = 3, warmup: int = 1,
                parent_span: str = "train.step",
                capture_xla: bool = False) -> AttributionResult:
        """Capture and time every registered segment, one at a time (each
        segment's graph is freed before the next is captured).  The pass
        runs under a span named `parent_span` (``phase=device_profile``)
        with a ``device.<name>`` child per segment."""
        from paddle_tpu_torch.observability import calibration
        from paddle_tpu_torch.observability.tracing import tracer
        tr = tracer()
        reports: List[SegmentReport] = []
        skipped: List[Tuple[str, str]] = []
        trace_dir = None
        devices = set()
        with tr.span(parent_span, phase="device_profile"):
            for seg in self._segments:
                dev = _device_of(seg.args)
                devices.add(device_name(dev))
                try:
                    compiled, info = aot_compile(
                        seg.fn, *seg.args, target=seg.name,
                        registry=self._registry, **seg.kwargs)
                except Exception as e:   # listed, so a caller can refuse
                    skipped.append((seg.name, f"{type(e).__name__}: {e}"))
                    continue
                try:
                    with tr.span(f"device.{seg.name}", reps=reps,
                                 count=seg.count) as sp:
                        device_s = self._time(compiled, dev, reps, warmup)
                        sp.set_attribute("device_ms", device_s * 1e3)
                finally:
                    compiled.close()
                    del compiled
                    if dev.type == "cuda":
                        torch.cuda.empty_cache()
                self._seg_hist.labels(segment=seg.name).observe(device_s)
                st = info.stats
                pred = max(st.flops / self.peak_flops,
                           st.bytes_accessed / self.hbm_bw)
                compute = st.bytes_accessed == 0 or \
                    st.flops / st.bytes_accessed >= \
                    self.peak_flops / self.hbm_bw
                report = SegmentReport(
                    name=seg.name, count=seg.count, group=seg.group,
                    device_s=device_s, compile_s=info.total_s,
                    flops=st.flops, bytes_accessed=st.bytes_accessed,
                    peak_bytes=st.peak_bytes, model_flops=st.flops,
                    model_bytes=st.bytes_accessed, predicted_s=pred,
                    gap=device_s / pred if pred > 0 else float("inf"),
                    bound="compute" if compute else "memory",
                    device=device_name(dev),
                    heaviest=info.cost.heaviest_bytes()[0])
                reports.append(report)
                self._records.append(report)
                record_segment_report(report)
                self._feed_ledger(seg, report)
            if capture_xla and self._segments:
                seg = self._segments[0]
                trace_dir = capture_xla_trace(
                    lambda: seg.fn(*seg.args, **seg.kwargs))
        if reports and calibration.enabled():
            calibration.ledger().save()
        return AttributionResult(segments=reports,
                                 peak_flops=self.peak_flops,
                                 hbm_bw=self.hbm_bw, xla_trace_dir=trace_dir,
                                 skipped=skipped,
                                 device=", ".join(sorted(devices)),
                                 roofline=roofline_source(self.device))


def llama_step_segments(model, batch: Dict[str, Any], grad: bool = True,
                        x: Optional[torch.Tensor] = None) -> List[Segment]:
    """A Llama-family CausalLM step as its op groups (the JAX package's
    ten segments, names, counts and groups): embed, rmsnorm,
    rmsnorm_qkv, attention, mlp, a whole decoder block, the block as
    routed at the decoder tier, and lm-head + CE; ``grad=True`` adds the
    fwd+bwd variants of attention and the MLP (``torch.autograd.grad``
    of the fp32 sum of the output in the layer's parameters and x).

    Each segment's first argument is the parameters it reads (the
    layer's own tensors, which the ledger key and the gradients see);
    the forward segments run without autograd.  `x` is the activation
    ``[b, s, d]`` (default: unit normal from a generator seeded 0, in
    the parameters' dtype)."""
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops.kernels import fused_block as FB

    inner = getattr(model, "model", None)
    layers = getattr(inner, "layers", None)
    if inner is None or not layers:
        raise ValueError(
            f"{type(model).__name__} is not a Llama-family CausalLM "
            "(need .model.layers); build Segments by hand instead")
    cfg = model.config
    layer0 = layers[0]
    dev = layer0.self_attn.q_proj.weight.device
    ids = torch.as_tensor(np.asarray(batch["input_ids"]),
                          dtype=torch.long).to(dev)
    labels = torch.as_tensor(np.asarray(batch["labels"]),
                             dtype=torch.long).to(dev)
    b, s = ids.shape
    d = cfg.hidden_size
    L = cfg.num_hidden_layers

    def params(layer):
        return dict(layer.named_parameters())

    attn_p = params(layer0.self_attn)
    dtype = next(iter(attn_p.values())).dtype
    if x is None:
        g = torch.Generator(device=dev).manual_seed(0)
        x = torch.randn((b, s, d), generator=g, device=dev).to(dtype)
    x = x.to(device=dev, dtype=dtype)
    cos, sin = inner.rope_cos, inner.rope_sin
    embed_p = params(inner.embed_tokens)
    norm_p = params(layer0.input_layernorm)
    mlp_p = params(layer0.mlp)
    block_p = params(layer0)
    if model.lm_head is not None:
        head_p = params(model.lm_head)

        def w_of(p):
            return p["weight"]
    else:                       # tied embeddings: the lm-head is embed^T
        head_p = {"weight": inner.embed_tokens.weight}

        def w_of(p):
            return p["weight"].t()

    @torch.no_grad()
    def embed_fn(p, i):
        return inner.embed_tokens(i)

    @torch.no_grad()
    def rmsnorm_fn(p, h):
        return layer0.input_layernorm(h)

    def attn(h, c, si):
        return layer0.self_attn(h, c, si)

    @torch.no_grad()
    def attn_fn(p, h, c, si):
        return attn(h, c, si)

    @torch.no_grad()
    def mlp_fn(p, h):
        return layer0.mlp(h)

    @torch.no_grad()
    def norm_qkv_fn(ps, h):
        # the fusion boundary: input rmsnorm + the three projections, as
        # the decoder layer runs them
        pn, pa = ps
        return F.fused_rmsnorm_qkv(
            h, pn["weight"], pa["q_proj.weight"], pa["k_proj.weight"],
            pa["v_proj.weight"], epsilon=layer0.input_layernorm._epsilon)

    @torch.no_grad()
    def block_fn(p, h, c, si):
        return layer0(h, c, si)

    @torch.no_grad()
    def block_fused_fn(p, h):
        # the whole-block boundary, routed as LlamaDecoderLayer.forward at
        # the decoder tier: one launch of the block kernel where the gate
        # takes the shape, else the layer's own route
        nh, nkvh = cfg.num_attention_heads, cfg.num_key_value_heads
        hd = cfg.head_dim
        fcols = int(p["mlp.gate_proj.weight"].shape[-1])
        if FB.fused_block_tier() == "decoder" and FB.fused_decoder_eligible(
                int(h.shape[0]), int(h.shape[1]), int(h.shape[-1]),
                nh * hd, nkvh * hd, hd, fcols, h.dtype) and \
                int(cos.shape[0]) >= int(h.shape[1]):
            return F.fused_decoder_block(
                h, p["input_layernorm.weight"],
                p["self_attn.q_proj.weight"], p["self_attn.k_proj.weight"],
                p["self_attn.v_proj.weight"], cos, sin,
                p["self_attn.o_proj.weight"],
                p["post_attention_layernorm.weight"],
                p["mlp.gate_proj.weight"], p["mlp.up_proj.weight"],
                p["mlp.down_proj.weight"], num_heads=nh, num_kv_heads=nkvh,
                epsilon=layer0.input_layernorm._epsilon)
        return layer0(h, cos, sin)

    @torch.no_grad()
    def head_fn(p, h, lbl):
        return F.fused_linear_cross_entropy(h.reshape(-1, d), w_of(p),
                                            lbl.reshape(-1))

    segs = [
        Segment("embed", embed_fn, (embed_p, ids), count=1, group="memory"),
        Segment("rmsnorm", rmsnorm_fn, (norm_p, x), count=2 * L + 1),
        Segment("rmsnorm_qkv", norm_qkv_fn, ((norm_p, attn_p), x),
                count=L, group="fused_boundary"),
        Segment("attention", attn_fn, (attn_p, x, cos, sin), count=L),
        Segment("mlp", mlp_fn, (mlp_p, x), count=L),
        Segment("decoder_block", block_fn, (block_p, x, cos, sin),
                count=L, group="composite"),
        Segment("decoder_block_fused", block_fused_fn, (block_p, x),
                count=L, group="fused_boundary"),
        Segment("lm_head_ce", head_fn, (head_p, x, labels), count=1),
    ]
    if grad:
        xg = x.detach().clone().requires_grad_(True)

        def value_and_grad(f):
            def vg(p, h, *rest):
                with torch.enable_grad():
                    out = f(h, *rest).float().sum()
                    grads = torch.autograd.grad(out, [*p.values(), h])
                return out.detach(), grads
            return vg

        segs += [
            Segment("attention_fwdbwd", value_and_grad(attn),
                    (attn_p, xg, cos, sin), count=L, group="fwdbwd"),
            Segment("mlp_fwdbwd", value_and_grad(layer0.mlp), (mlp_p, xg),
                    count=L, group="fwdbwd"),
        ]
    return segs


# -- live-memory census + watermark ------------------------------------------
def _live_tensors(device: torch.device) -> List[torch.Tensor]:
    """The tensors ``gc`` can reach on `device`."""
    out = []
    for obj in gc.get_objects():
        try:
            if isinstance(obj, torch.Tensor) and obj.device == device:
                out.append(obj)
        except Exception:      # objects mid-teardown
            continue
    return out


class DeviceMemoryMonitor:
    """Live memory accounting: ``sample()`` reads the live bytes, updates
    the live / watermark gauges and runs leak detection — live bytes
    growing strictly for a whole window of samples by at least
    ``leak_min_bytes`` fires the leak counter and a flight-recorder
    event.  On the card the live bytes are the allocator's
    (``torch.cuda.memory_allocated``, no sync) and the buffers its active
    blocks; on the CPU the storages of the live tensors ``gc`` finds.
    ``census()`` groups live tensors by dtype and shape, largest first.
    `device` is what it measures (``cuda`` unless given; a sample may
    name another)."""

    def __init__(self, registry=None, leak_window: int = 16,
                 leak_min_bytes: int = 16 << 20, device=None):
        if registry is None:
            from paddle_tpu_torch.observability.metrics import \
                default_registry
            registry = default_registry()
        self.device = device
        self._live = registry.gauge(
            "paddle_tpu_device_live_bytes",
            "bytes currently held by live device buffers")
        self._buffers = registry.gauge(
            "paddle_tpu_device_live_buffers",
            "count of live device buffers")
        self._watermark_g = registry.gauge(
            "paddle_tpu_device_hbm_watermark_bytes",
            "high-water mark of live device bytes seen by sampling")
        self._leaks = registry.counter(
            "paddle_tpu_device_memory_leak_total",
            "leak-detector firings: live bytes grew strictly for a "
            "whole sampling window")
        self.leak_window = max(2, int(leak_window))
        self.leak_min_bytes = int(leak_min_bytes)
        self._window: deque = deque(maxlen=self.leak_window)
        self._watermark = 0
        self._lock = threading.Lock()

    def _resolve(self, device):
        return resolve_device(device if device is not None else self.device)

    def measure(self, device=None) -> Tuple[int, int]:
        """(live_bytes, buffer_count) on `device`."""
        dev = self._resolve(device)
        if dev.type == "cuda":
            stats = torch.cuda.memory_stats(dev)
            return (torch.cuda.memory_allocated(dev),
                    int(stats.get("active.all.current", 0)))
        seen = {}
        for t in _live_tensors(dev):
            st = t.untyped_storage()
            seen[st.data_ptr()] = st.nbytes()
        return sum(seen.values()), len(seen)

    @property
    def watermark(self) -> int:
        return self._watermark

    def sample(self, live_bytes: Optional[int] = None,
               buffers: Optional[int] = None, step=None,
               device=None) -> int:
        """One sampling tick (``TrainStep`` calls this per step).  The
        ``live_bytes`` override is for tests and callers that already
        measured."""
        if live_bytes is None:
            live_bytes, buffers = self.measure(device)
        with self._lock:
            self._live.set(float(live_bytes))
            if buffers is not None:
                self._buffers.set(float(buffers))
            if live_bytes > self._watermark:
                self._watermark = live_bytes
                self._watermark_g.set(float(live_bytes))
            self._window.append(int(live_bytes))
            if len(self._window) == self.leak_window:
                w = list(self._window)
                grew = all(b > a for a, b in zip(w, w[1:]))
                if grew and w[-1] - w[0] >= self.leak_min_bytes:
                    self._leaks.inc()
                    self._window.clear()
                    from paddle_tpu_torch.observability.recorder import \
                        flight_recorder
                    flight_recorder().record(
                        "device.memory_leak", step=step,
                        growth_bytes=w[-1] - w[0],
                        window=self.leak_window,
                        live_bytes=int(live_bytes))
        return int(live_bytes)

    def census(self, top: int = 10, device=None) -> List[dict]:
        """Live tensors on `device` grouped by (dtype, shape), largest
        total bytes first (a view counts its own elements)."""
        dev = self._resolve(device)
        groups: Dict[Tuple[str, tuple], List[int]] = {}
        for t in _live_tensors(dev):
            key = (_dtype_name(t.dtype), tuple(t.shape))
            g = groups.setdefault(key, [0, 0])
            g[0] += 1
            g[1] += t.numel() * t.element_size()
        rows = [{"dtype": k[0], "shape": list(k[1]), "count": c,
                 "bytes": b} for k, (c, b) in groups.items()]
        rows.sort(key=lambda r: -r["bytes"])
        return rows[:top]


_MONITOR: Optional[DeviceMemoryMonitor] = None
_MONITOR_LOCK = threading.Lock()


def device_memory_monitor() -> DeviceMemoryMonitor:
    """The process-wide monitor (``TrainStep``'s per-step sampling
    writes here, naming its device; tests may build their own)."""
    global _MONITOR
    if _MONITOR is None:
        with _MONITOR_LOCK:
            if _MONITOR is None:
                _MONITOR = DeviceMemoryMonitor()
    return _MONITOR
