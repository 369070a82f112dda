"""Cost model: FLOPs, bytes and arithmetic intensity of one run
(``paddle_tpu/analysis/passes/cost_model.py``).

The JAX package counts a jaxpr's equations.  Here :class:`CostCounter`,
a ``TorchDispatchMode``, counts the operators of one real eager run of
the program (never inside a CUDA graph's capture, which the mode would
break), with the JAX package's rules:

* matrix products (``mm``, ``bmm``, ``addmm``, ``baddbmm``, what
  ``matmul`` and ``linear`` decompose into, convolutions, attention)
  cost exactly 2 M N K, as the dot rule does; ``addmm``'s bias add is
  one more operation an element, as JAX's separate add;
* elementwise operators one operation an output element,
  transcendentals ten, reductions one an input element; data movement
  none;
* bytes are unfused: every operator is charged its tensor operands and
  results.  A view moves nothing and is free.

A hand-written kernel charges itself: each wrapper of
``ops/kernels`` tells the counter its kernel's operations and bytes (each
input read once, each output written once: ``ops/kernels/costs.py``)
where it launches it, or where a CPU tensor sends it to its plain
version, whose operators are then not counted.  The ``ptt::`` dispatcher
ops (the fused kernels under autograd) are counted once, through the
wrapper inside them, never by their operators.  The intensity is a lower
bound: real traffic is lower where an intermediate stays on chip.

Defaults are an NVIDIA H100's: 989e12 bf16 FLOP/s and 3.35e12 B/s; pass
``options={"peak_flops": ..., "hbm_bw": ...}`` to ``analysis.check`` for
another roofline."""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from paddle_tpu_torch.analysis.diagnostics import Diagnostic, Severity
from paddle_tpu_torch.analysis.passes import PassContext, register_pass
from paddle_tpu_torch.ops.kernels import _build

__all__ = ["DEFAULT_PEAK_FLOPS", "DEFAULT_HBM_BW", "EqnCost", "CostSummary",
           "CostCounter", "count_cost"]

DEFAULT_PEAK_FLOPS = 989e12          # H100 SXM, dense bf16
DEFAULT_HBM_BW = 3.35e12             # bytes/s

_TRANSCENDENTAL = {
    "exp", "exp2", "log", "log2", "log10", "log1p", "expm1", "tanh", "erf",
    "erfc", "erfinv", "sigmoid", "sin", "cos", "tan", "asin", "acos",
    "atan", "atan2", "sinh", "cosh", "pow", "rsqrt", "lgamma", "digamma",
}
# composites JAX writes as several equations: silu = x * logistic(x);
# gelu's erf, multiplies and adds; softmax's max, subtract, exp, sum and
# divide
_COMPOSITE = {"silu": 11, "gelu": 14, "_softmax": 14, "softmax": 14,
              "_log_softmax": 14, "log_softmax": 14, "logsumexp": 12}
_DATA_MOVEMENT = {
    "_to_copy", "copy", "clone", "cat", "stack", "index_select", "gather",
    "embedding", "index", "_unsafe_index", "slice_scatter",
    "select_scatter", "repeat", "repeat_interleave", "constant_pad_nd",
    "pad", "where", "masked_fill", "fill", "zero", "zeros", "zeros_like",
    "ones", "ones_like", "full", "full_like", "arange", "tril", "triu",
    "flip", "roll", "new_zeros", "new_ones", "new_full", "scalar_tensor",
    "lift_fresh_copy", "randn", "rand", "randint", "uniform", "normal",
    "bernoulli", "randperm", "contiguous", "nonzero", "_pin_memory",
    "resize", "index_copy", "expand_copy", "view_copy", "masked_select",
}
_SCATTERS = {"scatter", "scatter_add", "scatter_reduce", "index_put",
             "index_add", "embedding_dense_backward"}
_REDUCTIONS = {
    "sum", "mean", "amax", "amin", "max", "min", "argmax", "argmin",
    "prod", "cumsum", "cumprod", "cummax", "cummin", "norm",
    "linalg_vector_norm", "var", "std", "var_mean", "std_mean", "all",
    "any", "count_nonzero", "nansum", "aminmax",
}
# no data moved: allocation, host reads, bookkeeping
_FREE = {"empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "_unsafe_view", "_local_scalar_dense",
         "alias", "lift_fresh", "resize_", "set_", "record_stream",
         "is_same_size", "_has_compatible_shallow_copy_type", "equal",
         "is_nonzero", "_resize_output", "sym_size", "sym_stride",
         "sym_numel", "sym_storage_offset"}
_PRODUCTS = {"mm", "bmm", "addmm", "baddbmm", "_int_mm", "_scaled_mm",
             "mv", "dot", "vdot", "addmv", "addbmm", "convolution",
             "_convolution", "convolution_backward"}
_SDPA = {"_scaled_dot_product_flash_attention",
         "_scaled_dot_product_flash_attention_for_cpu",
         "_scaled_dot_product_efficient_attention",
         "_scaled_dot_product_cudnn_attention",
         "_scaled_dot_product_attention_math"}


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _tensors(t)
    elif isinstance(tree, dict):
        for t in tree.values():
            yield from _tensors(t)


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def _product_flops(name, args, out) -> int:
    """2 M N K of a product operator (the flops of its products only)."""
    outs = list(_tensors(out))
    n_out = outs[0].numel() if outs else 0
    if name in ("mm", "_int_mm", "_scaled_mm", "bmm"):
        return 2 * n_out * args[0].shape[-1]
    if name in ("addmm", "baddbmm"):
        return 2 * n_out * args[1].shape[-1]
    if name == "addbmm":
        b, _, k = args[1].shape
        return 2 * n_out * b * k
    if name in ("mv", "addmv"):
        m = args[-2] if name == "addmv" else args[0]
        return 2 * m.numel()
    if name in ("dot", "vdot"):
        return 2 * args[0].numel()
    if name in ("convolution", "_convolution"):
        w = args[1]
        return 2 * n_out * (w.numel() // max(w.shape[0], 1))
    if name == "convolution_backward":
        # grad input and grad weight: two products of the forward's size
        w = args[2]
        n_in = args[1].numel()
        return 2 * 2 * n_in * (w.numel() // max(w.shape[1], 1))
    return 0


def _sdpa_flops(args) -> int:
    q, k = args[0], args[1]
    b, h, sq, d = q.shape
    return 4 * b * h * sq * k.shape[-2] * d


@dataclasses.dataclass
class EqnCost:
    """One counted operator call (or kernel launch): its name, FLOPs,
    bytes and where it came from (``"kernel"`` for a wrapper's
    charge)."""

    prim: str
    flops: int
    bytes: int
    where: str
    path: str = ""

    @property
    def intensity(self) -> float:
        return self.flops / self.bytes if self.bytes else float("inf")


@dataclasses.dataclass
class CostSummary:
    """The JAX package's roll-up.  ``by_prim`` maps an operator (``aten.
    mm``) or a kernel wrapper (``fused_mlp``) to ``(flops, bytes,
    calls)``; ``product_flops`` is the share of ``total_flops`` spent in
    matrix products."""

    total_flops: int
    total_bytes: int
    by_prim: Dict[str, Tuple[int, int, int]]
    top: List[EqnCost]
    peak_flops: float = DEFAULT_PEAK_FLOPS
    hbm_bw: float = DEFAULT_HBM_BW
    product_flops: int = 0

    @property
    def intensity(self) -> float:
        return self.total_flops / self.total_bytes if self.total_bytes \
            else float("inf")

    @property
    def ridge(self) -> float:
        return self.peak_flops / self.hbm_bw

    @property
    def compute_bound(self) -> bool:
        return self.intensity >= self.ridge

    def roofline_seconds(self) -> float:
        """The least time the device could take: the slower of the
        compute leg and the memory leg.  Bytes are unfused, so an
        intermediate that never reaches memory makes this pessimistic."""
        compute = self.total_flops / self.peak_flops if self.peak_flops \
            else 0.0
        memory = self.total_bytes / self.hbm_bw if self.hbm_bw else 0.0
        return max(compute, memory)

    def heaviest_bytes(self) -> Tuple[str, int]:
        """The operator or kernel charged the most bytes."""
        if not self.by_prim:
            return "", 0
        name, (_, by, _) = max(self.by_prim.items(), key=lambda kv: kv[1][1])
        return name, by

    def table(self, top_prims: int = 12) -> str:
        lines = [f"{'primitive':28s} {'count':>7s} {'GFLOPs':>12s} "
                 f"{'GB moved':>10s} {'flop/B':>8s}"]
        ranked = sorted(self.by_prim.items(), key=lambda kv: -kv[1][0])
        for prim, (fl, by, n) in ranked[:top_prims]:
            inten = fl / by if by else float("inf")
            lines.append(f"{prim:28s} {n:7d} {fl / 1e9:12.3f} "
                         f"{by / 1e9:10.3f} {inten:8.1f}")
        bound = "compute" if self.compute_bound else "memory"
        lines.append(
            f"{'TOTAL':28s} {sum(v[2] for v in self.by_prim.values()):7d} "
            f"{self.total_flops / 1e9:12.3f} "
            f"{self.total_bytes / 1e9:10.3f} {self.intensity:8.1f}")
        lines.append(
            f"arithmetic intensity {self.intensity:.1f} flop/B vs ridge "
            f"{self.ridge:.0f} → likely {bound}-bound "
            f"(unfused bytes; real traffic is lower)")
        return "\n".join(lines)

    def to_diagnostics(self) -> List[Diagnostic]:
        """The roll-up as Diagnostics (what the profiler renders)."""
        out = [Diagnostic(
            "cost-model", Severity.INFO,
            f"total {self.total_flops / 1e9:.2f} GFLOPs, "
            f"{self.total_bytes / 1e9:.2f} GB moved (unfused), "
            f"intensity {self.intensity:.1f} flop/B "
            f"(ridge {self.ridge:.0f})")]
        for prim, (fl, by, n) in sorted(self.by_prim.items(),
                                        key=lambda kv: -kv[1][0])[:6]:
            share = fl / self.total_flops if self.total_flops else 0.0
            out.append(Diagnostic(
                "cost-model", Severity.INFO,
                f"{prim}: {fl / 1e9:.2f} GFLOPs ({share:.0%}), "
                f"{by / 1e9:.2f} GB, ×{n}"))
        return out


class CostCounter(TorchDispatchMode):
    """Counts the operators that run inside ``with counter:`` and the
    kernels the wrappers charge (``_build.COUNTER``).  One counter
    counts at a time; it refuses to count inside a CUDA graph's
    capture."""

    def __init__(self):
        super().__init__()
        self.by_prim: Dict[str, List[int]] = {}
        self.records: List[EqnCost] = []
        self.total_flops = 0
        self.total_bytes = 0
        self.product_flops = 0
        self._paused = 0
        self._saved = None

    def __enter__(self):
        if torch.cuda.is_available() and \
                torch.cuda.is_current_stream_capturing():
            raise RuntimeError("the cost model counts an eager run, never "
                               "inside a CUDA graph's capture")
        if _build.COUNTER is not None:
            raise RuntimeError("another cost count is already running")
        _build.COUNTER = self
        return super().__enter__()

    def __exit__(self, *exc):
        _build.COUNTER = None
        return super().__exit__(*exc)

    @contextlib.contextmanager
    def paused(self):
        """Operators inside the block are not counted (a kernel's plain
        version, charged as the kernel)."""
        self._paused += 1
        try:
            yield
        finally:
            self._paused -= 1

    def add(self, prim: str, flops: int, nbytes: int, products: int = 0,
            path: str = ""):
        agg = self.by_prim.setdefault(prim, [0, 0, 0])
        agg[0] += flops
        agg[1] += nbytes
        agg[2] += 1
        self.total_flops += flops
        self.total_bytes += nbytes
        self.product_flops += products
        if flops:
            self.records.append(EqnCost(prim, flops, nbytes, prim, path))

    def kernel(self, what: str, flops: int, nbytes: int, products: bool):
        """A kernel wrapper's charge (``_build.charge``)."""
        self.add(what, int(flops), int(nbytes),
                 int(flops) if products else 0, "kernel")

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._paused or func.namespace == "ptt":
            # a ptt:: op is counted by the wrapper inside it
            return out
        name = func.overloadpacket.__name__
        if func.is_view or name in _FREE:
            return out
        base = name[:-1] if name.endswith("_") and \
            not name.startswith("_") else name
        nbytes = _nbytes(args) + _nbytes(kwargs) + _nbytes(out)
        outs = list(_tensors(out))
        n_out = sum(t.numel() for t in outs)
        products = 0
        if base in _PRODUCTS:
            products = _product_flops(base, args, out)
            flops = products + (n_out if base in ("addmm", "baddbmm",
                                                  "addmv", "addbmm") else 0)
        elif base in _SDPA:
            products = _sdpa_flops(args)
            flops = products + 14 * (products // (4 * args[0].shape[-1]))
        elif base in _DATA_MOVEMENT:
            flops = 0
        elif base in _SCATTERS:
            flops = list(_tensors(args))[-1].numel()
        elif base in _REDUCTIONS:
            first = next(_tensors(args), None)
            flops = first.numel() if first is not None else 0
        elif base in _TRANSCENDENTAL:
            flops = 10 * n_out
        elif base in _COMPOSITE:
            flops = _COMPOSITE[base] * n_out
        elif base in ("sort", "topk"):
            n = max((t.numel() for t in _tensors(args)), default=0)
            flops = int(n * max(math.log2(max(n, 2)), 1))
        else:
            flops = n_out                 # generic elementwise
        self.add(f"aten.{base}", flops, nbytes, products)
        return out

    def summary(self, peak_flops: float = DEFAULT_PEAK_FLOPS,
                hbm_bw: float = DEFAULT_HBM_BW) -> CostSummary:
        top = sorted(self.records, key=lambda c: -c.flops)[:16]
        return CostSummary(self.total_flops, self.total_bytes,
                           {k: tuple(v) for k, v in self.by_prim.items()},
                           top, peak_flops=peak_flops, hbm_bw=hbm_bw,
                           product_flops=self.product_flops)


def count_cost(fn, *args, **kwargs):
    """``(fn(*args, **kwargs), CostCounter)``: one eager run, counted."""
    counter = CostCounter()
    with counter:
        out = fn(*args, **kwargs)
    return out, counter


@register_pass("cost-model")
def cost_model(ctx: PassContext) -> List[Diagnostic]:
    peak = float(ctx.opt("peak_flops", DEFAULT_PEAK_FLOPS))
    bw = float(ctx.opt("hbm_bw", DEFAULT_HBM_BW))
    summary = ctx.run.summary(peak, bw)
    ctx.extras["cost"] = summary
    diags: List[Diagnostic] = []
    if summary.total_flops and not summary.compute_bound:
        est_ms = summary.roofline_seconds() * 1e3
        diags.append(Diagnostic(
            "cost-model", Severity.WARNING,
            f"likely memory-bound on the device: intensity "
            f"{summary.intensity:.1f} flop/B is below the ridge point "
            f"{summary.ridge:.0f} (lower bound ≈{est_ms:.2f} ms "
            f"on {peak / 1e12:.0f} TFLOP/s / {bw / 1e9:.0f} GB/s)",
            hint="batch more work per step, or quantize weights to cut "
                 "bytes"))
    return diags
