"""Optimizer base (``paddle_tpu/optimizer/optimizer.py``).

Each optimizer defines one update rule, ``_update(param, grad, state, lr,
step, name)``.  The JAX package's rule is pure; here it updates the state's
tensors (moments, the fp32 master) in place and returns the new
parameter value, which saves a copy of every state tensor at each step
(12 bytes per parameter).  The eager
``step()`` walks the parameters' ``.grad``; ``TrainStep`` drives the same
rule through ``_apply_gradients`` with each parameter's state-dict name.

With ``multi_precision`` a bf16/fp16 parameter gets an fp32 master copy
in its state (``_master``): the rule runs on the master and the
parameter receives its cast."""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

import torch

__all__ = ["Optimizer"]

_LOW = (torch.bfloat16, torch.float16)


def _unported(what: str, where: str = "item 4") -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md, queue 1, {where})")


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=False):
        if not isinstance(learning_rate, (int, float)):
            raise _unported("an LR scheduler as learning_rate")
        if grad_clip is not None:
            raise _unported("grad_clip")
        self._base_lr = float(learning_rate)
        self._parameters = list(parameters) if parameters is not None \
            else None
        if weight_decay is None:
            self._weight_decay = 0.0
        elif isinstance(weight_decay, (int, float)):
            self._weight_decay = float(weight_decay)
        else:   # an L2Decay-like object with a coefficient
            self._weight_decay = float(getattr(
                weight_decay, "_coeff", getattr(weight_decay, "coeff", 0.0)))
        self._multi_precision = bool(multi_precision)
        self._accumulators: Dict[int, Dict[str, torch.Tensor]] = {}
        self._global_step = 0

    # -- LR ------------------------------------------------------------------
    def get_lr(self) -> float:
        return self._base_lr

    def set_lr(self, value: float):
        self._base_lr = float(value)

    # -- update rule (override) ----------------------------------------------
    def _init_state(self, param: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Per-parameter state (tensors on the parameter's device)."""
        return {}

    def _init_state_full(self, param: torch.Tensor):
        st = self._init_state(param)
        if self._multi_precision and param.dtype in _LOW:
            st["_master"] = param.detach().float()
        return st

    def _update(self, p, g, state, lr, step, name) -> torch.Tensor:
        """The rule for parameter `name`: updates `state`'s tensors in
        place and returns the new value of `p` (which may be `p` itself,
        updated in place)."""
        raise NotImplementedError

    def _apply_weight_decay(self, param, grad):
        """L2 regularisation folded into the gradient; AdamW overrides
        with decoupled decay."""
        if self._weight_decay:
            return grad + self._weight_decay * param
        return grad

    def _update_with_master(self, p, g, state, lr, step, name):
        """The fp32 master (when kept), the weight-decay policy, then the
        subclass rule; writes the result into `p`."""
        use_master = self._multi_precision and p.dtype in _LOW
        work = state["_master"] if use_master else p
        g = self._apply_weight_decay(work, g)
        new = self._update(work, g, state, lr, step, name)
        if new is not p:
            p.copy_(new)

    def _state_of(self, p):
        st = self._accumulators.get(id(p))
        if st is None:
            st = self._accumulators[id(p)] = self._init_state_full(p)
        return st

    # -- eager step ----------------------------------------------------------
    @torch.no_grad()
    def step(self):
        if self._parameters is None:
            raise ValueError("Optimizer created without parameters; pass "
                             "parameters=model.parameters()")
        named = [(getattr(p, "name", None) or f"param_{i}", p)
                 for i, p in enumerate(self._parameters)
                 if p.requires_grad and p.grad is not None]
        self._global_step += 1
        self._apply_gradients(named, self._global_step)

    @torch.no_grad()
    def _apply_gradients(self, named: Iterable[Tuple[str, torch.Tensor]],
                         step: int):
        """One update of every ``(name, param)`` from ``param.grad`` at
        update count `step` (1 for the first); grads are cast to fp32
        under ``multi_precision``."""
        lr = self.get_lr()
        for name, p in named:
            g = p.grad.float() if self._multi_precision else p.grad
            self._update_with_master(p, g, self._state_of(p), lr, step, name)

    def _init_states(self, params: Iterable[torch.Tensor]):
        """Create every parameter's state now (as the JAX TrainStep does
        at construction), so a step's memory does not grow at its
        first update."""
        for p in params:
            self._state_of(p)

    def clear_grad(self, set_to_zero=False):
        """Drop every parameter's gradient (``set_to_zero`` is accepted
        for the JAX package's signature and, as there, changes nothing)."""
        if self._parameters is not None:
            for p in self._parameters:
                p.grad = None

    clear_gradients = clear_grad

    def state_dict(self):
        raise _unported("Optimizer.state_dict")

    def set_state_dict(self, state):
        raise _unported("Optimizer.set_state_dict")

