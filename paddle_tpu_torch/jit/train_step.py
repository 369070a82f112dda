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
a captured graph valid.  Meshes, ``param_specs`` and ``shardings`` wait
(ROADMAP.md, queue 1, item 8); the reference's compile spans, gauges and
persistent compile cache wait for item 9."""

from __future__ import annotations

import inspect
import os
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

import numpy as np
import torch

from paddle_tpu_torch.core import state as _state
from paddle_tpu_torch.distributed.moe import router_metrics_paused
from paddle_tpu_torch.io.device_prefetch import as_tensor
from paddle_tpu_torch.jit.static_graph import launch_counts
from paddle_tpu_torch.ops.kernels import _build
from paddle_tpu_torch.ops.kernels import multi_tensor as _mt
from paddle_tpu_torch.optimizer.optimizer import copy_into, to_numpy
from paddle_tpu_torch.robustness.faults import NonFiniteStepError

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


@dataclass
class CompileInfo:
    """What :meth:`TrainStep.compile` did: the batch signature it fixed,
    its seconds (the warm-up and the capture), whether a CUDA graph was
    captured, and the kernel launches the graph holds, by wrapper (each
    replay runs them again; the wrappers' counters do not move)."""
    signature: tuple
    seconds: float
    graph: bool
    launches: Dict[str, int] = field(default_factory=dict)


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
                 param_specs=None, shardings=None):
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
        self.model = model
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self._accum_steps = int(accum_steps)
        self._remat = bool(remat)
        self._remat_policy = remat_policy or "nothing"
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
        nothing in it (JAX skips them under its trace)."""
        with router_metrics_paused():
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
        self._lr.fill_(self.optimizer.get_lr())
        if self._sig is not None and _signature(batch) == self._sig:
            for dst, src in zip(_leaves(self._static_batch), _leaves(batch)):
                dst.copy_(as_tensor(src))
            if self._graph is not None:
                self._graph.replay()
                self.replays += 1
                loss, gnorm, code = (t.clone() for t in self._static_out)
            else:
                loss, gnorm, code = self._body(self._static_batch)
        else:
            loss, gnorm, code = self._body(self._place_batch(batch))
        sched = self.optimizer._lr_scheduler
        if sched is not None:
            sched.step()
        self.last_grad_norm = gnorm
        c = int(code) if self._guard_nonfinite else 0
        if c == 0:
            self.step_count += 1
        self._account_skip(c)
        return loss

    def _account_skip(self, code: int):
        if code == 0:
            self._skip_streak = 0
            return
        reason = "nonfinite_loss" if code == 1 else "nonfinite_grad"
        self.skipped[reason] += 1
        self._skip_streak += 1
        if self._skip_streak >= self._max_skips:
            raise NonFiniteStepError(
                f"{self._skip_streak} consecutive optimizer updates "
                f"skipped (last reason: {reason}) — persistent "
                "divergence, not a transient bad microbatch; params are "
                "unchanged since the last finite step")

    # -- compile -------------------------------------------------------------------
    def compile(self, batch) -> CompileInfo:
        """Fix this batch signature: later calls whose batch matches it
        copy the batch into static buffers and run the step on them.  On
        a CUDA model the whole step is captured as one CUDA graph (after
        a warm-up on a side stream that keeps no update) and each such
        call replays it; a capture that fails raises.  On the CPU there
        is no graph: the calls run the same body over the same static
        buffers.  Returns a :class:`CompileInfo`."""
        t0 = time.perf_counter()
        placed = self._place_batch(batch)
        self._graph = self._static_out = self._sig = None
        self._graph_tables = []
        self._static_batch = _map(lambda t: t.clone(), placed)
        sig = _signature(placed)
        self._lr.fill_(self.optimizer.get_lr())
        launches = {}
        if self._device.type == "cuda":
            launches = self._capture()
        self._sig = sig
        return CompileInfo(signature=sig,
                           seconds=time.perf_counter() - t0,
                           graph=self._graph is not None, launches=launches)

    def _capture(self):
        dev = self._device
        gen = _state.generator(dev)
        rng = gen.get_state()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(_WARMUP):
                self._body(self._static_batch, apply=False)
        torch.cuda.current_stream(dev).wait_stream(side)
        # the graph takes the port's generator only where the body draws
        # from it (dropout): a registered generator is left in capture
        # mode by a capture that fails
        drew = not torch.equal(gen.get_state(), rng)
        gen.set_state(rng)
        graph = torch.cuda.CUDAGraph()
        if drew:
            graph.register_generator_state(gen)
        before = launch_counts()
        # the multi-tensor tables: 96 bytes a tensor for the norm and the
        # update, each table rounded up to 64 bytes, and room to spare
        nbytes = 256 * len(self._named) + (1 << 16)
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
        after = launch_counts()
        torch.cuda.synchronize(dev)
        self._graph, self._static_out = graph, out
        # every buffer whose address the graph holds lives as long as it
        self._graph_tables = [arena] + tables + held
        return {k: after[k] - before[k] for k in after
                if after[k] != before[k]}

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
        self.step_count = int(np.asarray(state["step"]))
        self._count.fill_(self.step_count)
        key = state.get("rng_key")
        if key is not None and np.asarray(key).dtype == np.uint8:
            _state.generator(self._device).set_state(
                torch.from_numpy(np.array(key, dtype=np.uint8)))
        sched = self.optimizer._lr_scheduler
        if sched is not None and "lr_scheduler" in state:
            sched.set_state_dict(state["lr_scheduler"])
