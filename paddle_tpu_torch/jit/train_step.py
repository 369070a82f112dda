"""TrainStep — one training step (``paddle_tpu/jit/train_step.py``).

The JAX package compiles forward, backward and the optimizer update into
one donated, jitted function over parameter pytrees.  PyTorch runs
eagerly: the step is the model's forward, ``loss.backward()`` and the
optimizer's rule on the Layer's own parameters, updated in place, so
``step.params`` are the model's parameters and ``sync_to_model()`` has
nothing to do.

Kept from the JAX package: the loss dispatch of ``_loss_of``, the fp32
global gradient norm, and the non-finite step guard: a NaN/Inf loss or
gradient norm skips the update (parameters, optimizer state and step
count stay bitwise unchanged), counts the skip, and after K skips in a
row raises ``NonFiniteStepError``.  The guard's ``int()`` of the verdict
waits for the device each step, as in the JAX package; here the verdict
is taken before the update, so a skipped update is never computed.

Waiting (ROADMAP.md, queue 1, item 5): ``accum_steps > 1``, ``remat``,
meshes and shardings, ``compile()`` and ``state_dict()``."""

from __future__ import annotations

import inspect
import os
from typing import Callable, Dict, Optional

import numpy as np
import torch

from paddle_tpu_torch.robustness.faults import NonFiniteStepError

__all__ = ["TrainStep"]


def _unported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"TrainStep {what} is not ported yet (ROADMAP.md, queue 1, item 5)")


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


class TrainStep:
    """One optimizer update per call.

        step = TrainStep(model, AdamW(learning_rate=1e-4,
                                      multi_precision=True))
        loss = step({"input_ids": ids, "labels": labels})

    The step runs on the model's device; batch arrays (numpy or tensors)
    are moved there."""

    def __init__(self, model, optimizer, loss_fn: Optional[Callable] = None,
                 guard_nonfinite: Optional[bool] = None,
                 max_consecutive_skips: Optional[int] = None,
                 accum_steps: int = 1, remat: bool = False, mesh=None,
                 param_specs=None, shardings=None):
        if int(accum_steps) != 1:
            raise _unported("accum_steps > 1")
        if remat:
            raise _unported("remat")
        if mesh is not None or param_specs is not None or \
                shardings is not None:
            raise _unported("meshes and shardings")
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
        self._guard_nonfinite = bool(guard_nonfinite)
        self._max_skips = int(max_consecutive_skips)
        self._skip_streak = 0
        self.skipped: Dict[str, int] = {"nonfinite_loss": 0,
                                        "nonfinite_grad": 0}
        self.step_count = 0
        self.last_grad_norm: Optional[torch.Tensor] = None
        self._named = [(n, p) for n, p in model.named_parameters()
                       if p.requires_grad]
        self._device = self._named[0][1].device if self._named else \
            torch.device("cpu")
        optimizer._init_states(p for _, p in self._named)

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        """``{state-dict name: parameter}``, detached views of the
        model's own parameters."""
        return {n: p.detach() for n, p in self._named}

    def sync_to_model(self):
        """A no-op: the step updates the Layer's parameters in place (the
        JAX step keeps its own copies and writes them back here)."""

    def compile(self, batch):
        raise _unported("compile()")

    def state_dict(self):
        raise _unported("state_dict()")

    def set_state_dict(self, state):
        raise _unported("set_state_dict()")

    def _place(self, a):
        if torch.is_tensor(a):
            return a.to(self._device)
        return torch.as_tensor(np.asarray(a)).to(self._device)

    def _place_batch(self, batch):
        if isinstance(batch, dict):
            return {k: self._place(v) for k, v in batch.items()}
        return tuple(self._place(v) for v in batch)

    def _clear_grads(self):
        for _, p in self._named:
            p.grad = None

    def _grad_norm(self) -> torch.Tensor:
        """fp32 global L2 norm over every gradient."""
        sq = [torch.linalg.vector_norm(p.grad, dtype=torch.float32) ** 2
              for _, p in self._named if p.grad is not None]
        if not sq:
            return torch.zeros((), device=self._device)
        return torch.sqrt(torch.stack(sq).sum())

    def __call__(self, batch):
        batch = self._place_batch(batch)
        self._clear_grads()
        loss = _loss_of(self.model, self.loss_fn, batch)
        loss.backward()
        gnorm = self._grad_norm()
        self.last_grad_norm = gnorm
        if self._guard_nonfinite:
            # 0 applied, 1 non-finite loss, 2 finite loss but non-finite
            # grad norm (one NaN/Inf anywhere poisons the norm)
            code = int(torch.where(
                torch.isfinite(loss),
                torch.where(torch.isfinite(gnorm), 0, 2), 1))
            if code:
                self._clear_grads()
                self._account_skip(code)
                return loss.detach()
            self._skip_streak = 0
        self.optimizer._apply_gradients(
            [(n, p) for n, p in self._named if p.grad is not None],
            self.step_count + 1)
        self.step_count += 1
        self._clear_grads()
        return loss.detach()

    def _account_skip(self, code: int):
        reason = "nonfinite_loss" if code == 1 else "nonfinite_grad"
        self.skipped[reason] += 1
        self._skip_streak += 1
        if self._skip_streak >= self._max_skips:
            raise NonFiniteStepError(
                f"{self._skip_streak} consecutive optimizer updates "
                f"skipped (last reason: {reason}) — persistent "
                "divergence, not a transient bad microbatch; params are "
                "unchanged since the last finite step")
