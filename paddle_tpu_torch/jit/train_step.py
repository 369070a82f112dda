"""TrainStep — one training step (``paddle_tpu/jit/train_step.py``).

The JAX package compiles forward, backward, the clip, the optimizer
update and the non-finite guard into one donated, jitted program.  Here
the step body runs eagerly, or is captured once as a CUDA graph by
:meth:`TrainStep.compile` and replayed; either way it is the same body:

1. the loss and the gradients (``torch.autograd.grad``); with
   ``accum_steps = n > 1`` the batch splits into n equal slices along its
   first axis, and the loss and gradients are the mean over the slices,
   each slice's gradient cast to fp32 and scaled by 1/n into an fp32
   accumulator (``train_step.py:507-537``);
2. the global gradient norm, fp32 (one multi-tensor launch on the card);
3. the guard's skip code on the device (``:552-567``): 0 applied, 1 a
   non-finite loss, 2 a finite loss but a non-finite gradient norm;
4. the optimizer's update at the device count + 1, reading lr from a
   device scalar the host writes before each call, with the clip and
   keep = (code == 0): a skipped step leaves parameters, optimizer state
   and the count bitwise as they were;
5. the count advanced by keep.

The host reads the skip code after the step, counts skips and raises
``NonFiniteStepError`` after K in a row; the LR scheduler steps after
every call.  ``remat`` wraps the loss in ``torch.utils.checkpoint``
(non-reentrant); ``remat_policy`` picks what the recompute may keep:
``"nothing"`` (the default under remat) saves only the inputs,
``"everything"`` every result, ``"dots"`` the outputs of the matrix
products (``mm``, ``bmm``, ``addmm``, ``baddbmm``) and of the fused
kernels registered as dispatcher ops (RMSNorm+QKV, the MLP and FFN, the
flash forward, the grouped expert FFN, the decoder block), and
``"dots_no_batch"`` those without a batch dimension (``mm``, ``addmm``,
QKV, the MLP, the FFN).

``state_dict()`` / ``set_state_dict()`` keep the reference's format
(``params``, ``opt_state``, ``step``, ``lr_scheduler``, ``rng_key``; numpy
arrays), and take a JAX step's state: its ``rng_key`` is a threefry key,
which no torch generator can continue, so only a torch generator state
is restored.  Values are copied into the step's own tensors, which keeps
a captured graph valid.

Telemetry, under the JAX package's names (``train_step.py:79-134``,
``:525-663``): the 13 ``paddle_tpu_train_*`` instruments (step seconds,
steps, tokens, tokens/s, loss and grad-norm gauges holding the device
scalar until a scrape reads it, recompiles, the accumulation histogram,
skipped updates by reason, MFU, productive and skipped seconds, the step
EMA); the spans ``train.step`` > ``train.h2d``, ``train.dispatch`` (>
``train.accum_microbatches``), ``train.guard``, and ``train.compile``;
the flight recorder's ``train.step`` crash coverage, ``train.recompile``
and ``train.step_skipped``; the fault points ``train.nonfinite_batch``
(NaN in the batch's float leaves) and ``train.straggler_delay``
(``PADDLE_TPU_STRAGGLER_DELAY_S``, default 0.05 s, inside the timed
region); and the memory watermark sampled every
``PADDLE_TPU_WATERMARK_INTERVAL`` steps: on the card by default
(``PADDLE_TPU_DEVICE_WATERMARK=0`` turns it off), on the CPU, where a
sample walks the heap, only with ``PADDLE_TPU_DEVICE_WATERMARK=1``.  A
step's seconds run from its dispatch to the guard's read of the skip
code, the one sync a step makes; telemetry adds none.  Without the
guard there is no sync, and the seconds are the host's.  The MFU gauge
is set once :meth:`TrainStep.compile` has counted the step: the cost
model's FLOPs of one eager run of the body (every kernel's charge
included) over the step's seconds times the device's peak
(``device_profiler.detect_roofline``, read in ``compile()``; a card it
does not know leaves the gauge unset, with one
``train.mfu_unavailable`` recorder event).

The persistent compile cache (``compile_cache.py``,
``PADDLE_TPU_COMPILE_CACHE=1``): :meth:`TrainStep.compile` looks the
step up under its batch signature and :meth:`_cache_extra` (the JAX
package's string) first; a hit captures the step without the counted
warm-up and returns ``CompileInfo(cached=True)`` with the entry's stats,
a miss compiles and stores the recipe.  The first plain call of a step
never compiled probes the cache the same way (``cache_only``): a hit
captures, a miss leaves the call eager.

``sdc_sentinel=`` (``robustness.recovery.SDCSentinel``) publishes and
verifies the parameters' digest every ``sdc_check_interval`` calls
(default: the sentinel's interval), reading the parameters in place on
the card (one ``multi_tensor_digest`` launch); the verdict is
``last_sdc_verdict``.

Restoring a state (:meth:`set_state_dict`) copies into the step's own
tensors and the device generator, so a captured graph stays valid and a
restored step continues bit for bit.

Meshes, ``param_specs`` and ``shardings`` wait (ROADMAP.md, queue 1,
item 8)."""

from __future__ import annotations

import inspect
import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from paddle_tpu_torch.core import functional as _func
from paddle_tpu_torch.core import state as _state
from paddle_tpu_torch.distributed.moe import router_metrics_paused
from paddle_tpu_torch.io.device_prefetch import as_tensor
from paddle_tpu_torch.jit.static_graph import launch_counts, pool_bytes
from paddle_tpu_torch.ops.kernels import _build
from paddle_tpu_torch.ops.kernels import multi_tensor as _mt
from paddle_tpu_torch.optimizer.optimizer import copy_into, to_numpy
from paddle_tpu_torch.observability.device_profiler import (
    CompileInfo, ExecutableStats, detect_roofline, device_memory_monitor,
    observe_compile, signature_of)
from paddle_tpu_torch.robustness.faults import (NonFiniteStepError,
                                                fault_fires)

__all__ = ["TrainStep", "CompileInfo", "REMAT_POLICIES"]

REMAT_POLICIES = ("dots", "dots_no_batch", "nothing", "everything")
# the capture's warm-up: runs of the body before it (PyTorch's recipe:
# on a side stream, so lazily made handles and buffers exist first)
_WARMUP = 2


def _has_lm_loss(model) -> bool:
    """True when ``model.loss`` has the LM contract ``loss(input_ids,
    labels)`` (two required positional parameters)."""
    fn = getattr(model, "loss", None)
    if fn is None or not callable(fn):
        return False
    try:
        params = [p for p in inspect.signature(fn).parameters.values()
                  if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]
    except (TypeError, ValueError):
        return False
    return len([p for p in params if p.default is p.empty]) == 2


def _loss_of(model, loss_fn, batch):
    """batch: a dict with ``input_ids``/``labels`` (LM) or an ``(x, y)``
    pair routed to ``loss_fn(model(x), y)``.  A model with
    ``.loss(input_ids, labels)`` owns its objective (Llama's fused
    chunked lm-head + CE)."""
    if loss_fn is None:
        if _has_lm_loss(model):
            return model.loss(batch["input_ids"], batch["labels"])
        from paddle_tpu_torch.nn.functional import cross_entropy
        logits = model(batch["input_ids"])
        v = logits.shape[-1]
        return cross_entropy(logits.reshape(-1, v),
                             batch["labels"].reshape(-1))
    x, y = batch
    return loss_fn(model(x), y)


def _map(fn, batch):
    if isinstance(batch, dict):
        return {k: fn(v) for k, v in batch.items()}
    return tuple(fn(v) for v in batch)


def _leaves(batch):
    return list(batch.values()) if isinstance(batch, dict) else list(batch)


def _signature(batch):
    """The batch's structure, shapes and dtypes (what a graph fixes)."""
    def sig(a):
        t = as_tensor(a)
        return tuple(t.shape), t.dtype
    if isinstance(batch, dict):
        return ("dict", tuple((k, sig(v)) for k, v in batch.items()))
    return ("tuple", tuple(sig(v) for v in batch))


_DOTS_NO_BATCH = ("aten.mm.", "aten.addmm.", "ptt.fused_rmsnorm_qkv.",
                  "ptt.fused_mlp.", "ptt.fused_ffn.")
_DOTS = _DOTS_NO_BATCH + ("aten.bmm.", "aten.baddbmm.",
                          "ptt.flash_attention_fwd.",
                          "ptt.grouped_expert_ffn.",
                          "ptt.fused_decoder_block.")


def _remat_context(policy: str):
    """The selective-checkpoint context of `policy` (None: save only the
    inputs, which checkpoint does by itself)."""
    if policy == "nothing":
        return None
    from functools import partial

    from torch.utils.checkpoint import (CheckpointPolicy,
                                        create_selective_checkpoint_contexts)
    saved = {"dots": _DOTS, "dots_no_batch": _DOTS_NO_BATCH}.get(policy)

    def choose(ctx, op, *args, **kwargs):
        if saved is None or str(op).startswith(saved):
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE
    return partial(create_selective_checkpoint_contexts, choose)


def _train_metrics():
    """The instruments on the default registry, shared by every
    ``TrainStep`` in the process (``train_step.py:79-134``)."""
    from paddle_tpu_torch.observability import default_registry
    reg = default_registry()
    return {
        "step": reg.histogram(
            "paddle_tpu_train_step_seconds",
            "wall time of one compiled train step (fwd+bwd+update)"),
        "steps": reg.counter("paddle_tpu_train_steps_total",
                             "train steps executed"),
        "tokens": reg.counter("paddle_tpu_train_tokens_total",
                              "tokens consumed by train steps"),
        "tps": reg.gauge("paddle_tpu_train_tokens_per_second",
                         "tokens/s of the most recent train step"),
        "loss": reg.gauge("paddle_tpu_train_loss",
                          "loss of the most recent train step"),
        "gnorm": reg.gauge("paddle_tpu_train_grad_norm",
                           "global gradient norm of the most recent "
                           "train step"),
        "recompiles": reg.counter(
            "paddle_tpu_train_recompiles_total",
            "novel call signatures after the first — each one is a "
            "silent retrace + XLA compile"),
        "accum": reg.histogram(
            "paddle_tpu_train_accum_microbatches",
            "microbatches accumulated per optimizer update",
            buckets=(1, 2, 4, 8, 16, 32, 64)),
        "skipped": reg.counter(
            "paddle_tpu_train_step_skipped_total",
            "optimizer updates skipped by the non-finite step-guard "
            "(params and optimizer state left unchanged)",
            labelnames=("reason",)),
        "mfu": reg.gauge(
            "paddle_tpu_train_mfu",
            "measured model-FLOPs utilisation of the most recent step "
            "(XLA executable FLOPs / step time / device peak; set once "
            "TrainStep.compile() has introspected the executable)"),
        "productive": reg.counter(
            "paddle_tpu_train_productive_seconds_total",
            "step wall seconds whose optimizer update was applied "
            "(the goodput numerator)"),
        "skipped_s": reg.counter(
            "paddle_tpu_train_skipped_seconds_total",
            "step wall seconds whose update the non-finite step-guard "
            "discarded (lost time, debited from goodput)"),
        "ema": reg.gauge(
            "paddle_tpu_train_step_ema_seconds",
            "EMA of step wall time — host-labeled after fleet "
            "federation, the series the straggler SLO rule compares "
            "against the fleet median"),
    }


def _poison(a):
    """`a` times NaN where it is floating point (the fault
    ``train.nonfinite_batch``), else `a`."""
    t = as_tensor(a)
    return t * float("nan") if t.is_floating_point() else a


class TrainStep:
    """One optimizer update per call.

        step = TrainStep(model, AdamW(learning_rate=1e-4,
                                      multi_precision=True))
        loss = step({"input_ids": ids, "labels": labels})
        step.compile(batch)     # CUDA: later calls of this signature
                                # replay one graph of the whole step

    The step runs on the model's device; batch arrays (numpy or tensors)
    are moved there.  The step updates the Layer's own parameters in
    place, so ``step.params`` are the model's parameters."""

    def __init__(self, model, optimizer, loss_fn: Optional[Callable] = None,
                 guard_nonfinite: Optional[bool] = None,
                 max_consecutive_skips: Optional[int] = None,
                 accum_steps: int = 1, remat: bool = False,
                 remat_policy: Optional[str] = None, mesh=None,
                 param_specs=None, shardings=None, sdc_sentinel=None,
                 sdc_check_interval: Optional[int] = None):
        if mesh is not None or param_specs is not None or \
                shardings is not None:
            raise NotImplementedError(
                "TrainStep meshes and shardings are not ported yet "
                "(ROADMAP.md, queue 1, item 8)")
        if int(accum_steps) < 1:
            raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
        if remat_policy is not None and remat_policy not in REMAT_POLICIES:
            raise ValueError(f"unknown remat_policy {remat_policy!r}; "
                             f"choose from {sorted(REMAT_POLICIES)}")
        if guard_nonfinite is None:
            guard_nonfinite = os.environ.get("PADDLE_TPU_STEP_GUARD",
                                             "1") != "0"
        if max_consecutive_skips is None:
            max_consecutive_skips = int(os.environ.get(
                "PADDLE_TPU_MAX_SKIP_STEPS", "25"))
        if max_consecutive_skips < 1:
            raise ValueError("max_consecutive_skips must be >= 1, got "
                             f"{max_consecutive_skips}")
        # the SDC sentinel hook (train_step.py:414-426)
        if sdc_check_interval is None:
            sdc_check_interval = getattr(sdc_sentinel, "interval", 1) \
                if sdc_sentinel is not None else 0
        if sdc_sentinel is not None and int(sdc_check_interval) < 1:
            raise ValueError("sdc_check_interval must be >= 1, got "
                             f"{sdc_check_interval}")
        self._sdc_sentinel = sdc_sentinel
        self._sdc_interval = int(sdc_check_interval or 0)
        self.last_sdc_verdict = None
        self.model = model
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self._accum_steps = int(accum_steps)
        self._remat = bool(remat)
        self._remat_policy = remat_policy or "nothing"
        self._remat_policy_name = remat_policy
        self._cache_probed = False
        self._guard_nonfinite = bool(guard_nonfinite)
        self._max_skips = int(max_consecutive_skips)
        self._skip_streak = 0
        self.skipped: Dict[str, int] = {"nonfinite_loss": 0,
                                        "nonfinite_grad": 0}
        self.step_count = 0
        self.replays = 0
        self.last_grad_norm: Optional[torch.Tensor] = None
        self._named = [(n, p) for n, p in model.named_parameters()
                       if p.requires_grad]
        self._device = self._named[0][1].device if self._named else \
            torch.device("cpu")
        # the device scalars a captured graph reads at replay time
        self._lr = torch.zeros((), dtype=torch.float32, device=self._device)
        self._count = torch.zeros((), dtype=torch.int32, device=self._device)
        self._graph = None
        self._static_batch = None
        self._static_out = None
        self._sig = None
        self._graph_tables = []
        optimizer._init_states(self._named)
        # telemetry (the JAX package's): metric writes are dict lookups
        # and float adds; the loss and grad-norm gauges keep the device
        # scalar, which a scrape reads
        from paddle_tpu_torch.analysis.recompile import SignatureMonitor
        from paddle_tpu_torch.observability import flight_recorder
        from paddle_tpu_torch.observability.tracing import tracer
        self._metrics = _train_metrics()
        self._recorder = flight_recorder()
        self._tracer = tracer()
        self._signature_monitor = SignatureMonitor(
            name=f"TrainStep({type(model).__name__})")
        self._host_steps = 0
        self._step_ema: Optional[float] = None
        self._step_flops: Optional[float] = None
        self._peak_flops: Optional[float] = None
        self._memmon = None
        self._watermark_every = max(1, int(os.environ.get(
            "PADDLE_TPU_WATERMARK_INTERVAL", "1")))
        # the card's sample is an allocator read; the CPU's walks the
        # heap, so there it is taken only when asked for
        default = "1" if self._device.type == "cuda" else "0"
        if os.environ.get("PADDLE_TPU_DEVICE_WATERMARK", default) != "0":
            self._memmon = device_memory_monitor()

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        """``{state-dict name: parameter}``, detached views of the
        model's own parameters."""
        return {n: p.detach() for n, p in self._named}

    def sync_to_model(self):
        """A no-op: the step updates the Layer's parameters in place (the
        JAX step keeps its own copies and writes them back here)."""

    # -- the body --------------------------------------------------------------
    def _place(self, a):
        return as_tensor(a).to(self._device)

    def _place_batch(self, batch):
        batch = _map(self._place, batch)
        n = self._accum_steps
        if n > 1:
            for leaf in _leaves(batch):
                if leaf.ndim and leaf.shape[0] % n:
                    raise ValueError(
                        f"batch leading dim {leaf.shape[0]} not divisible "
                        f"by accum_steps={n}")
        return batch

    def _loss(self, batch):
        if not self._remat:
            return _loss_of(self.model, self.loss_fn, batch)
        from torch.utils.checkpoint import checkpoint
        ctx = _remat_context(self._remat_policy)
        kw = {} if ctx is None else {"context_fn": ctx}
        return checkpoint(lambda b: _loss_of(self.model, self.loss_fn, b),
                          batch, use_reentrant=False, **kw)

    def _grads(self, loss, params):
        gs = torch.autograd.grad(loss, params, allow_unused=True)
        # an unused parameter's gradient is zero, as jax.grad gives it
        return [torch.zeros_like(p) if g is None else g
                for g, p in zip(gs, params)]

    def _body(self, batch, apply: bool = True):
        """The step on placed (or static) batch tensors: ``(loss, grad
        norm, skip code)``, all 0-d device tensors.  With ``apply``
        False the update keeps nothing (the capture's warm-up).  The MoE
        router metrics, which read the device on the host, record
        nothing in it (JAX skips them under its trace).  The body runs
        under the substitution flag (``core.functional``), so a sparse
        embedding takes its dense path, as under the JAX step's
        ``functional_call``."""
        with router_metrics_paused(), _func.substitute():
            return self._step(batch, apply)

    def _step(self, batch, apply):
        names = [n for n, _ in self._named]
        params = [p for _, p in self._named]
        n = self._accum_steps
        if n == 1:
            loss = self._loss(batch)
            grads = self._grads(loss, params)
            loss = loss.detach()
        else:
            inv = 1.0 / n
            size = _leaves(batch)[0].shape[0] // n
            loss, grads = None, None
            for i in range(n):
                mb = _map(lambda t: t[i * size:(i + 1) * size]
                          if t.ndim else t, batch)
                li = self._loss(mb)
                gi = self._grads(li, params)
                li = li.detach().float() * inv
                loss = li if loss is None else loss + li
                gi = [g.float() * inv for g in gi]
                grads = gi if grads is None else \
                    [a.add_(b) for a, b in zip(grads, gi)]
        with torch.no_grad():
            gnorm = _mt.multi_tensor_norm(grads)
            if self._guard_nonfinite:
                code = torch.where(torch.isfinite(loss),
                                   torch.where(torch.isfinite(gnorm), 0, 2),
                                   1).to(torch.int32)
                keep = code == 0
            else:
                code = torch.zeros((), dtype=torch.int32,
                                   device=self._device)
                keep = None
            if not apply:
                keep = torch.zeros((), dtype=torch.bool, device=self._device)
            self.optimizer._apply_gradients(names, params, grads,
                                            self._count + 1, self._lr,
                                            keep=keep, norm=gnorm)
            self._count.add_(1 if keep is None else keep.to(torch.int32))
        return loss, gnorm, code

    # -- the call ----------------------------------------------------------------
    def __call__(self, batch):
        # the step span: its children cover the batch's placement, the
        # dispatch (the accumulated microbatches a level below) and the
        # guard's read of the skip code
        with self._tracer.span("train.step", step=self._host_steps,
                               accum=self._accum_steps):
            return self._call_traced(batch)

    def _call_traced(self, batch):
        if fault_fires("train.nonfinite_batch", step=self._host_steps):
            batch = _map(_poison, batch)
        if self._sig is None and not self._cache_probed:
            self._probe_compile_cache(batch)
        self._lr.fill_(self.optimizer.get_lr())
        replay = self._sig is not None and _signature(batch) == self._sig
        with self._tracer.span("train.h2d"):
            if replay:
                for dst, src in zip(_leaves(self._static_batch),
                                    _leaves(batch)):
                    dst.copy_(as_tensor(src))
                placed = self._static_batch
            else:
                placed = self._place_batch(batch)
        # a novel signature after the first call: a compiled step would
        # recompile here, and this one runs off its captured graph
        novel = self._signature_monitor.record((placed,))
        if novel and self._signature_monitor.calls > 1:
            self._metrics["recompiles"].inc()
            self._recorder.record(
                "train.recompile", target=self._signature_monitor.name,
                distinct_signatures=len(self._signature_monitor.records))
        t0 = time.perf_counter()
        if fault_fires("train.straggler_delay", step=self._host_steps):
            time.sleep(float(os.environ.get("PADDLE_TPU_STRAGGLER_DELAY_S",
                                            "0.05")))
        with self._recorder.instrumented("train.step",
                                         step=self._host_steps), \
                self._tracer.span("train.dispatch",
                                  microbatches=self._accum_steps):
            if self._accum_steps > 1:
                with self._tracer.span("train.accum_microbatches",
                                       n=self._accum_steps):
                    loss, gnorm, code = self._run(placed, replay)
            else:
                loss, gnorm, code = self._run(placed, replay)
        sched = self.optimizer._lr_scheduler
        if sched is not None:
            sched.step()
        self.last_grad_norm = gnorm
        self._host_steps += 1
        m = self._metrics
        m["steps"].inc()
        m["accum"].observe(self._accum_steps)
        m["loss"].set(loss)          # the device scalar, read at scrape
        m["gnorm"].set(gnorm)
        if self._guard_nonfinite:
            # the guard's read of the skip code is the step's one sync;
            # the step's seconds end there
            with self._tracer.span("train.guard"):
                c = int(code)
                dt = time.perf_counter() - t0
                # the goodput split before _account_skip may raise
                m["productive" if c == 0 else "skipped_s"].inc(dt)
        else:
            c = 0
            dt = time.perf_counter() - t0
            m["productive"].inc(dt)
        m["step"].observe(dt)
        self._step_ema = dt if self._step_ema is None \
            else 0.8 * self._step_ema + 0.2 * dt
        m["ema"].set(self._step_ema)
        tokens = self._batch_tokens(placed)
        if tokens:
            m["tokens"].inc(tokens)
            if dt > 0:
                m["tps"].set(tokens / dt)
        if self._step_flops and self._peak_flops and dt > 0:
            m["mfu"].set(self._step_flops / dt / self._peak_flops)
        if self._memmon is not None and \
                self._host_steps % self._watermark_every == 0:
            self._memmon.sample(step=self._host_steps, device=self._device)
        if c == 0:
            self.step_count += 1
        # the SDC sentinel's cadence: publish this rank's digest and
        # judge it against the peers' (a bounded wait)
        if self._sdc_sentinel is not None and \
                self._host_steps % self._sdc_interval == 0:
            self._sdc_sentinel.publish(self._host_steps, self.params)
            self.last_sdc_verdict = self._sdc_sentinel.verify(
                self._host_steps)
        self._account_skip(c)
        return loss

    def _run(self, placed, replay):
        """``(loss, grad norm, skip code)`` of one step on placed (or
        static) batch tensors: a replay of the captured graph where there
        is one, else the body."""
        if replay and self._graph is not None:
            self._graph.replay()
            self.replays += 1
            return tuple(t.clone() for t in self._static_out)
        return self._body(placed)

    @staticmethod
    def _batch_tokens(batch) -> int:
        """Token count for throughput metrics: LM batches count
        input_ids elements, (x, y) batches count examples."""
        if isinstance(batch, dict) and "input_ids" in batch:
            return int(batch["input_ids"].numel())
        leaves = _leaves(batch)
        if leaves and leaves[0].ndim:
            return int(leaves[0].shape[0])
        return 0

    def _account_skip(self, code: int):
        if code == 0:
            self._skip_streak = 0
            return
        reason = "nonfinite_loss" if code == 1 else "nonfinite_grad"
        self.skipped[reason] += 1
        self._skip_streak += 1
        self._metrics["skipped"].labels(reason=reason).inc()
        self._recorder.record("train.step_skipped", reason=reason,
                              step=self._host_steps - 1,
                              streak=self._skip_streak)
        if self._skip_streak >= self._max_skips:
            self._recorder.dump(
                reason=f"step-guard: {self._skip_streak} consecutive "
                       f"non-finite steps ({reason})")
            raise NonFiniteStepError(
                f"{self._skip_streak} consecutive optimizer updates "
                f"skipped (last reason: {reason}) — persistent "
                "divergence, not a transient bad microbatch; params are "
                "unchanged since the last finite step")

    # -- compile -------------------------------------------------------------------
    def _cache_extra(self) -> str:
        """Compile-cache key discriminators the batch signature cannot
        see (``train_step.py:583-595``): the step's config and the model
        config."""
        from paddle_tpu_torch import compile_cache
        lf = getattr(self.loss_fn, "__name__", repr(self.loss_fn)) \
            if self.loss_fn is not None else ""
        return (f"model={compile_cache.model_config_tag(self.model)}"
                f"|opt={type(self.optimizer).__name__}"
                f"|loss={lf}|accum={self._accum_steps}"
                f"|remat={int(self._remat)}:{self._remat_policy_name}"
                f"|guard={int(self._guard_nonfinite)}"
                f"|ovl=0")

    def compile(self, batch) -> CompileInfo:
        """Fix this batch signature: later calls whose batch matches it
        copy the batch into static buffers and run the step on them.  On
        a CUDA model the whole step is captured as one CUDA graph (after
        a warm-up on a side stream that keeps no update) and each such
        call replays it; a capture that fails raises.  On the CPU there
        is no graph: the calls run the same body over the same static
        buffers.

        Under ``train.compile`` > ``compile``: ``compile.lower`` counts
        one run of the body that keeps no update with the cost model (the
        first warm-up on the card; its FLOPs arm the MFU gauge) and warms
        up, ``compile.xla`` captures.  Returns the
        :class:`~paddle_tpu_torch.observability.device_profiler.
        CompileInfo`, recorded under the target ``TrainStep(<model
        class>)`` with the compile counter and gauges moved.  With the
        persistent compile cache on, a hit skips the count (its stats
        come from the entry; ``cached=True``, the compile counter
        unmoved) and a miss stores the recipe."""
        return self._compile(batch)

    def _compile(self, batch, cache_only: bool = False
                 ) -> Optional[CompileInfo]:
        from paddle_tpu_torch import compile_cache
        target = f"TrainStep({type(self.model).__name__})"
        placed = self._place_batch(batch)
        signature = signature_of(placed)
        key = entry = None
        t_hit = time.perf_counter()
        if compile_cache.enabled():
            key = compile_cache.cache_key(target, signature,
                                          extra=self._cache_extra(),
                                          device=self._device)
            entry = compile_cache.lookup(key, target=target,
                                         device=self._device)
        if entry is None and cache_only:
            return None
        self._graph = self._static_out = self._sig = None
        self._graph_tables = []
        self._static_batch = _map(lambda t: t.clone(), placed)
        sig = _signature(placed)
        self._lr.fill_(self.optimizer.get_lr())
        tr = self._tracer
        counted = entry is None
        with tr.span("train.compile", target=target), \
                tr.span("compile", target=target):
            if self._device.type == "cuda":
                launches, run, times, peak = self._capture(target, counted)
            else:
                t0 = time.perf_counter()
                with tr.span("compile.lower", target=target):
                    run = self.count_cost(self._static_batch) if counted \
                        else None
                with tr.span("compile.xla", target=target):
                    pass
                launches, peak = {}, 0
                times = (time.perf_counter() - t0, 0.0)
        self._sig = sig
        self._peak_flops = self._resolve_peak(target)
        if not counted:
            info = compile_cache.hit_info(
                target, signature, entry, time.perf_counter() - t_hit,
                self._graph is not None, launches)
            self._step_flops = float(info.stats.flops) or None
            return info
        self._step_flops = float(run.total_flops) or None
        info = CompileInfo(
            target=target, signature=signature,
            lower_s=times[0], compile_s=times[1],
            stats=ExecutableStats(flops=float(run.total_flops),
                                  bytes_accessed=float(run.total_bytes),
                                  peak_allocated=peak),
            graph=self._graph is not None, launches=launches,
            cost=run.summary())
        observe_compile(info)
        if key is not None:
            compile_cache.store(key, info, target=target,
                                signature=signature,
                                extra=self._cache_extra(),
                                device=self._device)
        return info

    def _probe_compile_cache(self, batch):
        """The first plain call of a step never compiled: with the cache
        on, a hit for this batch signature captures the step, which the
        call then replays; a miss leaves the call eager.  Failures never
        escape (a stale cache must not break a boot)."""
        self._cache_probed = True
        try:
            from paddle_tpu_torch import compile_cache
            if compile_cache.enabled():
                self._compile(batch, cache_only=True)
        except Exception:
            self._graph = self._static_out = self._sig = None
            self._graph_tables = []

    def _resolve_peak(self, target) -> Optional[float]:
        """The MFU gauge's denominator: the device's peak FLOP/s, or None
        (one ``train.mfu_unavailable`` recorder event; the gauge stays
        unset) on a card :func:`detect_roofline` does not know."""
        try:
            return detect_roofline(self._device)[0]
        except RuntimeError as e:
            self._recorder.record("train.mfu_unavailable", target=target,
                                  reason=str(e))
            return None

    def count_cost(self, batch):
        """One run of the step body that keeps no update, counted by the
        cost model (``analysis.check(step, batch)`` calls this); the
        generator's state is put back after it.  Returns the
        ``CostCounter``."""
        from paddle_tpu_torch.analysis.passes.cost_model import count_cost
        gen = _state.generator(self._device)
        rng = gen.get_state()
        placed = batch if batch is self._static_batch else \
            self._place_batch(batch)
        try:
            _, run = count_cost(self._body, placed, apply=False)
        finally:
            gen.set_state(rng)
        return run

    def _capture(self, target, counted: bool = True):
        """Count (unless `counted` is False: a compile-cache hit), warm
        up and capture the body on the card: ``(launches a replay makes,
        the count or None, (lower seconds, capture seconds), the bytes
        the capture's memory pool reserved)``."""
        dev = self._device
        tr = self._tracer
        gen = _state.generator(dev)
        rng = gen.get_state()
        t0 = time.perf_counter()
        with tr.span("compile.lower", target=target):
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                run = self.count_cost(self._static_batch) if counted \
                    else None
                for _ in range(_WARMUP - counted):
                    self._body(self._static_batch, apply=False)
            torch.cuda.current_stream(dev).wait_stream(side)
            torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
        # the graph takes the port's generator only where the body draws
        # from it (dropout; the counted run puts its draws back, the
        # second warm-up's tell): a registered generator is left in
        # capture mode by a capture that fails
        drew = not torch.equal(gen.get_state(), rng)
        gen.set_state(rng)
        graph = torch.cuda.CUDAGraph()
        if drew:
            graph.register_generator_state(gen)
        before = launch_counts()
        # the multi-tensor tables: 96 bytes a tensor for the norm and the
        # update, each table rounded up to 64 bytes, and room to spare
        nbytes = 256 * len(self._named) + (1 << 16)
        with tr.span("compile.xla", target=target):
            base = pool_bytes(dev)
            try:
                with _build.frozen("TrainStep.compile's capture") as held, \
                        torch.cuda.graph(graph), \
                        _mt.capture_tables(dev, nbytes) as arena:
                    out = self._body(self._static_batch)
            except BaseException:
                if drew:
                    _state.renew_generator(dev, rng)
                raise
            finally:
                tables = _mt.finish_capture()
            pool = pool_bytes(dev, base)
        after = launch_counts()
        self._graph, self._static_out = graph, out
        # every buffer whose address the graph holds lives as long as it
        self._graph_tables = [arena] + tables + held
        launches = {k: after[k] - before[k] for k in after
                    if after[k] != before[k]}
        return launches, run, (t1 - t0, time.perf_counter() - t1), pool

    # -- state ---------------------------------------------------------------------
    def state_dict(self):
        """``params`` and ``opt_state`` by parameter name (numpy arrays;
        bf16 as ``ml_dtypes.bfloat16``), ``step``, ``lr_scheduler`` with
        a scheduler, and ``rng_key``: the state of the device's
        generator, the one dropout draws from."""
        opt = self.optimizer
        out = {"params": {n: to_numpy(p) for n, p in self._named},
               "opt_state": {n: {k: to_numpy(v)
                                 for k, v in opt._state_of(p, n).items()}
                             for n, p in self._named},
               "step": int(self.step_count),
               "rng_key": _state.generator(self._device).get_state()
               .numpy().copy()}
        if opt._lr_scheduler is not None:
            out["lr_scheduler"] = opt._lr_scheduler.state_dict()
        return out

    @torch.no_grad()
    def set_state_dict(self, state):
        """Load a state dict of this step's or of the JAX package's
        ``TrainStep``: every value is copied into the step's own tensors
        (names and shapes must agree), the count is set, and the
        scheduler restored.  A ``rng_key`` that is a torch generator
        state (uint8) is restored; a JAX key is not (no torch generator
        can continue threefry's stream)."""
        own = dict(self._named)
        for what in ("params", "opt_state"):
            missing = sorted(set(own) - set(state[what]))
            unexpected = sorted(set(state[what]) - set(own))
            if missing or unexpected:
                raise ValueError(f"{what} mismatch: missing {missing}, "
                                 f"unexpected {unexpected}")
        for n, p in self._named:
            copy_into(p, state["params"][n], n)
            self.optimizer._load_state(p, n, state["opt_state"][n])
        step = state["step"]
        self.step_count = int(step.item() if torch.is_tensor(step) else
                              np.asarray(step))
        self._count.fill_(self.step_count)
        key = state.get("rng_key")
        if torch.is_tensor(key):
            key = key.detach().to("cpu").numpy()
        if key is not None and np.asarray(key).dtype == np.uint8:
            _state.generator(self._device).set_state(
                torch.from_numpy(np.array(key, dtype=np.uint8)))
        sched = self.optimizer._lr_scheduler
        if sched is not None and "lr_scheduler" in state:
            sched.set_state_dict(state["lr_scheduler"])
