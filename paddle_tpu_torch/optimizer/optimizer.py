"""Optimizer base (``paddle_tpu/optimizer/optimizer.py``).

Each optimizer defines one update rule, ``_update(param, grad, state,
lr, step) -> (new_param, new_state)``, pure as in the JAX package and on
fp32 tensors.  The base class applies it parameter by parameter: the
clip (``grad_clip``) first, then the fp32 cast of the gradient under
``multi_precision``, the L2 weight decay folded into the gradient (not
for the decoupled optimizers, AdamW and Lamb), the rule on the fp32
master where one is kept (``_master``: a bf16/fp16 parameter under
``multi_precision``), and the result written in place into the state's
tensors and the parameter, so their addresses never change (a captured
CUDA graph holds them).  Adam and AdamW hand every parameter to one
multi-tensor update instead (``ops/kernels/multi_tensor.py``: the kernel
on the card, this same rule on the CPU).

``lr`` and ``step`` may be numbers or 0-d device tensors (the training
step's, which a captured graph reads at replay time); the bias
corrections are fp32 from the count, as the reference's traced step
takes them.  A 0-d bool ``keep`` (the step guard's verdict) selects on
the device between the new values and the old: with keep False nothing
changes.  ``learning_rate`` may be an ``LRScheduler``; the eager
``step()`` reads it on the host, ``TrainStep`` writes it into its device
scalar before each call.  The eager ``step`` skips a parameter whose
``stop_gradient`` is set (``requires_grad`` False) and, when one of its
parameters has ``need_clip`` False, clips through the clip's own call,
which leaves that gradient alone.

A row-sparse gradient (an embedding's with ``sparse=True``; a sparse COO
tensor or a ``RowSparseGrad``) takes :meth:`Optimizer._update_sparse`
(``optimizer.py:79-88, 121-148``): on the fp32 master where one is kept,
with no weight decay folded into the gradient.  The default densifies
the gradient and runs the dense rule; SGD, Adam and AdamW override it
with rows-touched rules, gathers and scatters that never build a
``[vocab, d]`` gradient.  Adam and AdamW still put every dense
parameter in their one multi-tensor launch.  The step guard's ``keep``
(``TrainStep``, which never meets a sparse gradient) is refused with
one."""

from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

import numpy as np
import torch

from paddle_tpu_torch.core.sparse_grad import RowSparseGrad, is_row_sparse
from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm, scaled

__all__ = ["Optimizer"]

_LOW = (torch.bfloat16, torch.float16)


class Optimizer:
    _decoupled = False      # AdamW and Lamb decay the weights themselves

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=False):
        from paddle_tpu_torch.optimizer.lr import LRScheduler
        self._lr_scheduler = None
        self._base_lr = None
        if isinstance(learning_rate, LRScheduler):
            self._lr_scheduler = learning_rate
        else:
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
        self._grad_clip = grad_clip
        self._multi_precision = bool(multi_precision)
        self._accumulators: Dict[int, Dict[str, torch.Tensor]] = {}
        self._registered: Dict[int, Tuple[str, torch.Tensor]] = {}
        self._global_step = 0
        self._current_param_name = None

    # -- LR ------------------------------------------------------------------
    def get_lr(self) -> float:
        if self._lr_scheduler is not None:
            return float(self._lr_scheduler())
        return self._base_lr

    def set_lr(self, value: float):
        if self._lr_scheduler is not None:
            raise RuntimeError("optimizer's learning rate is a scheduler; "
                               "call scheduler.step()/set attrs instead")
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

    def _update(self, p, g, state, lr, step):
        """The rule: the new value of `p` and the new state, computed
        from fp32 (or the parameter's dtype) without touching `state`."""
        raise NotImplementedError

    def _apply_weight_decay(self, param, grad):
        """L2 regularisation folded into the gradient; the decoupled
        optimizers decay in their rule instead."""
        if self._weight_decay:
            return grad + param * self._weight_decay
        return grad

    def _state_of(self, p, name=None):
        key = id(p)
        st = self._accumulators.get(key)
        if st is None:
            st = self._accumulators[key] = self._init_state_full(p)
        if name is not None or key not in self._registered:
            self._registered[key] = (name or f"param_{len(self._registered)}",
                                     p)
        return st

    def _init_states(self, named: Iterable[Tuple[str, torch.Tensor]]):
        """Create every parameter's state now, under its state-dict name
        (as the JAX TrainStep does at construction), so a step's memory
        does not grow at its first update."""
        for name, p in named:
            self._state_of(p, name)

    # -- the update ----------------------------------------------------------
    @torch.no_grad()
    def _apply_gradients(self, names: List[str], params, grads, step, lr,
                         keep=None, norm=None, clip=True):
        """One update of `params` from `grads` at update count `step`
        (1 for the first), clip first unless `clip` is False.  `norm`:
        the gradients' global norm where the caller has it (the global
        clip reads it)."""
        grads = [RowSparseGrad.of(g) if is_row_sparse(g) else g
                 for g in grads]
        if keep is not None and any(isinstance(g, RowSparseGrad)
                                    for g in grads):
            raise NotImplementedError(
                "the step guard's keep with a row-sparse gradient: "
                "TrainStep runs the embedding dense")
        scale = None
        if not clip:
            pass
        elif isinstance(self._grad_clip, ClipGradByGlobalNorm):
            grads = [g.coalesce() if isinstance(g, RowSparseGrad) else g
                     for g in grads]
            scale = self._grad_clip.scale(grads, norm)
        elif self._grad_clip is not None:
            grads = self._grad_clip.clip(grads)
        dense = [i for i, g in enumerate(grads)
                 if not isinstance(g, RowSparseGrad)]
        if dense:
            self._update_all([names[i] for i in dense],
                             [params[i] for i in dense],
                             [grads[i] for i in dense], lr, step, scale, keep)
        for i, g in enumerate(grads):
            if isinstance(g, RowSparseGrad):
                if scale is not None:
                    g = RowSparseGrad(g.rows, scaled(g.values, scale),
                                      g.shape, coalesced=g.coalesced)
                self._apply_sparse(names[i], params[i], g, lr, step)

    def _update_all(self, names, params, grads, lr, step, scale, keep):
        """The rule, parameter by parameter (see the module's docstring)."""
        for name, p, g in zip(names, params, grads):
            if scale is not None:
                g = scaled(g, scale)
            self._apply_rule(name, p, g, lr, step, keep)

    def _apply_rule(self, name, p, g, lr, step, keep=None, decay=True):
        """The dense rule on one parameter, written in place."""
        st = self._state_of(p, name)
        if self._multi_precision:
            g = g.float()
        master = st.get("_master")
        work = master if master is not None else p
        if decay and not self._decoupled:
            g = self._apply_weight_decay(work, g)
        inner = {k: v for k, v in st.items() if k != "_master"}
        self._current_param_name = name
        new_w, new_inner = self._update(work, g, inner, lr, step)
        pairs = [(inner[k], new_inner[k]) for k in inner]
        pairs.append((p, new_w))
        if master is not None:
            pairs.append((master, new_w))
        for dst, new in pairs:
            new = new.to(dst.dtype)
            if keep is not None:
                new = torch.where(keep, new, dst)
            dst.copy_(new)

    @torch.no_grad()
    def _apply_sparse(self, name, p, g: RowSparseGrad, lr, step):
        """A row-sparse gradient's update of `p`, in place."""
        st = self._state_of(p, name)
        master = st.get("_master")
        inner = {k: v for k, v in st.items() if k != "_master"}
        self._current_param_name = name
        self._update_sparse(p, master, g, inner, lr, step)

    def _update_sparse(self, p, master, g: RowSparseGrad, state, lr, step):
        """The rule for a row-sparse gradient (the reference's
        selected_rows kernel slot): by default the gradient densified
        through the dense rule, with no weight decay (the JAX package's
        decay under sparse gradients is the sparse rules' own).  SGD,
        Adam and AdamW override it with rows-touched rules."""
        self._apply_rule(self._current_param_name, p, g.to_dense(), lr, step,
                         decay=False)


    # -- eager step ----------------------------------------------------------
    @torch.no_grad()
    def step(self):
        if self._parameters is None:
            raise ValueError("Optimizer created without parameters; pass "
                             "parameters=model.parameters()")
        named = [(getattr(p, "name", None) or f"param_{i}", p)
                 for i, p in enumerate(self._parameters)
                 if p.requires_grad and p.grad is not None]
        grads = [p.grad for _, p in named]
        clip = True
        if self._grad_clip is not None and \
                not all(getattr(p, "need_clip", True) for _, p in named):
            # the clip's own call skips need_clip=False, as the JAX
            # package's eager step does (nn/clip.py:48-146)
            grads = [g for _, g in self._grad_clip(
                [(p, g) for (_, p), g in zip(named, grads)])]
            clip = False
        self._global_step += 1
        self._apply_gradients([n for n, _ in named], [p for _, p in named],
                              grads, self._global_step, self.get_lr(),
                              clip=clip)

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()
        self.clear_grad()

    def clear_grad(self, set_to_zero=False):
        """Drop every parameter's gradient (``set_to_zero`` is accepted
        for the JAX package's signature and, as there, changes nothing)."""
        if self._parameters is not None:
            for p in self._parameters:
                p.grad = None

    clear_gradients = clear_grad

    # -- state dict ----------------------------------------------------------
    def _named_params(self):
        if self._parameters is not None:
            return [(getattr(p, "name", None) or f"param_{i}", p)
                    for i, p in enumerate(self._parameters)]
        return list(self._registered.values())

    def state_dict(self):
        """``global_step``, ``LR_Scheduler`` (with a scheduler) and
        ``accumulators``: by parameter name, each state tensor (moments,
        ``_master``) as a numpy array (``optimizer.py:205-216``)."""
        out = {"global_step": self._global_step}
        if self._lr_scheduler is not None:
            out["LR_Scheduler"] = self._lr_scheduler.state_dict()
        accum = {}
        for name, p in self._named_params():
            st = self._accumulators.get(id(p))
            if st is not None:
                accum[name] = {k: to_numpy(v) for k, v in st.items()}
        out["accumulators"] = accum
        return out

    @torch.no_grad()
    def set_state_dict(self, state):
        """The inverse of :meth:`state_dict` (a JAX optimizer's too):
        every value is copied into this optimizer's own tensors."""
        self._global_step = int(state.get("global_step", 0))
        if self._lr_scheduler is not None and "LR_Scheduler" in state:
            self._lr_scheduler.set_state_dict(state["LR_Scheduler"])
        accum = state.get("accumulators", {})
        for name, p in self._named_params():
            if name in accum:
                self._load_state(p, name, accum[name])

    def _load_state(self, p, name, values):
        st = self._state_of(p, name)
        for k, v in values.items():
            if k not in st:
                raise KeyError(f"optimizer state of '{name}' has no '{k}' "
                               f"(it holds {sorted(st)})")
            copy_into(st[k], v, f"{name}.{k}")


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor's values as numpy, bf16 as ``ml_dtypes.bfloat16`` (what a
    JAX bf16 array becomes under ``np.asarray``); where ml_dtypes is not
    installed a bf16 tensor comes back as a CPU tensor.  Always a copy,
    never a view of `t` (a state dict is a snapshot)."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        try:
            import ml_dtypes
        except ImportError:
            return t
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def copy_into(dst: torch.Tensor, value, what: str):
    """Copy `value` (numpy, ml_dtypes or a tensor) into `dst` in place,
    converted to its dtype; the shapes must agree."""
    from paddle_tpu_torch.nn.layer import _from_numpy
    src = value.detach() if torch.is_tensor(value) else \
        _from_numpy(np.asarray(value))
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"shape mismatch for '{what}': state "
                         f"{tuple(src.shape)} vs {tuple(dst.shape)}")
    dst.copy_(src.to(dst.dtype))
