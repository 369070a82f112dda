"""The optimizers (``paddle_tpu/optimizer/optimizers.py``): SGD, Momentum,
Adam, AdamW, Adagrad, RMSProp, Adadelta, Adamax and Lamb, each rule the
reference's operations in its order, in fp32 (a bf16 parameter without a
master keeps the reference's bf16 roundings where its rule has them:
Momentum's velocity, the L2 decay).

Adam and AdamW update every dense parameter in one multi-tensor launch
on the card (``multi_tensor_adam``); the other rules run parameter by
parameter, on the card too.  A row-sparse gradient takes its own rule
(``paddle_tpu/optimizer/optimizers.py:19-30, 75-110``), as eager gather /
rule / scatter ops: SGD scatter-adds ``-lr`` times the rows (each
touched row decayed once where there is an L2 decay); Adam and AdamW
with ``lazy_mode=True`` move the moments and the weights of the touched
rows only, and without it decay the moments everywhere and move every
row, as dense Adam does.  Adam folds its L2 decay into the sparse
gradient's rows; AdamW's decay stays decoupled.  ``Adam(lazy_mode=True)``
changes nothing on dense gradients.  AdamW takes ``lr_ratio`` and, as
the reference does, never reads it."""

from __future__ import annotations

import torch

from paddle_tpu_torch.ops.kernels.multi_tensor import (bias_correction,
                                                       multi_tensor_adam)
from paddle_tpu_torch.optimizer.optimizer import Optimizer

__all__ = ["SGD", "Momentum", "Adam", "AdamW", "Adagrad", "RMSProp",
           "Adadelta", "Adamax", "Lamb"]


def _zeros(p):
    return torch.zeros_like(p, dtype=torch.float32)


class SGD(Optimizer):
    def _update(self, p, g, s, lr, step):
        return p.float() - g.to(p.dtype).float() * lr, s

    def _update_sparse(self, p, master, g, s, lr, step):
        """Rows-touched scatter-add (``optimizers.py:19-30``)."""
        work = master if master is not None else p
        if self._weight_decay:
            g = g.coalesce()   # the decay hits each touched row once
            vals = g.values.to(work.dtype) + \
                work[g.rows] * self._weight_decay
        else:
            vals = g.values.to(work.dtype)
        work.index_add_(0, g.rows, vals * (-lr))
        if master is not None:
            p.index_copy_(0, g.rows, master[g.rows].to(p.dtype))


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def _init_state(self, p):
        return {"velocity": torch.zeros_like(p)}

    def _update(self, p, g, s, lr, step):
        g = g.to(p.dtype)
        v = s["velocity"] * self._momentum + g
        upd = g + v * self._momentum if self._nesterov else v
        return p.float() - upd.float() * lr, {"velocity": v}


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon
        self._lazy = bool(lazy_mode)

    def _init_state(self, p):
        return {"moment1": _zeros(p), "moment2": _zeros(p)}

    def _decoupled_wd(self, name: str):
        """The decoupled decay coefficient of parameter `name`; None for
        Adam, whose weight decay is L2 folded into the gradient."""
        return None

    def _update_sparse(self, p, master, g, s, lr, step):
        """The reference's selected_rows Adam (``optimizers.py:75-110``):
        moments and weights of the touched rows only under
        ``lazy_mode``, else moments decayed everywhere and every row
        moved.  The bias corrections are the JAX sparse rule's (Python
        floats, rounded to fp32 where they meet a tensor)."""
        g = g.coalesce()
        r = g.rows
        work = master if master is not None else p
        gf = g.values.float()
        if not self._decoupled and self._weight_decay:
            gf = gf + work[r].float() * self._weight_decay
        m, v = s["moment1"], s["moment2"]
        b1, b2, eps = self._beta1, self._beta2, self._eps
        bc1 = 1 - b1 ** step
        bc2 = 1 - b2 ** step
        wd = self._decoupled_wd(self._current_param_name) \
            if self._decoupled else None
        if self._lazy:
            pr = work[r].float()
            m_r = m[r] * b1 + gf * (1 - b1)
            v_r = v[r] * b2 + torch.square(gf) * (1 - b2)
            upd = (m_r / bc1) / (torch.sqrt(v_r / bc2) + eps)
            if wd:
                upd = upd + pr * wd
            m.index_copy_(0, r, m_r)
            v.index_copy_(0, r, v_r)
            new = pr - upd * lr
            if master is not None:
                master.index_copy_(0, r, new)
            p.index_copy_(0, r, new.to(p.dtype))
            return
        m.mul_(b1).index_add_(0, r, gf * (1 - b1))
        v.mul_(b2).index_add_(0, r, torch.square(gf) * (1 - b2))
        pf = work.float()
        upd = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        if wd:
            upd = upd + pf * wd
        new = pf - upd * lr
        if master is not None:
            master.copy_(new)
        p.copy_(new.to(p.dtype))

    def _update_all(self, names, params, grads, lr, step, scale, keep):
        """Every dense parameter in one ``multi_tensor_adam`` call."""
        states = [self._state_of(p, n) for n, p in zip(names, params)]
        if self._decoupled:
            wds = [self._decoupled_wd(n) for n in names]
        else:
            wds = [self._weight_decay] * len(names)
        multi_tensor_adam(
            params, grads, [s["moment1"] for s in states],
            [s["moment2"] for s in states], [s.get("_master") for s in states],
            lr=lr, step=step, beta1=self._beta1, beta2=self._beta2,
            epsilon=self._eps, weight_decays=wds, decoupled=self._decoupled,
            multi_precision=self._multi_precision, scale=scale, keep=keep)


class AdamW(Adam):
    """Adam with decoupled weight decay (default 0.01) on every
    parameter unless ``apply_decay_param_fun(name)`` says otherwise; the
    name is the parameter's state-dict name under ``TrainStep``."""

    _decoupled = True

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode, multi_precision, name)
        self._weight_decay = float(weight_decay) if weight_decay else 0.0
        self._apply_decay_param_fun = apply_decay_param_fun

    def _decoupled_wd(self, name: str) -> float:
        wd = self._weight_decay
        if wd and self._apply_decay_param_fun is not None and \
                not self._apply_decay_param_fun(name or ""):
            return 0.0
        return wd


class Adagrad(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._eps = epsilon
        self._init_val = initial_accumulator_value

    def _init_state(self, p):
        return {"moment": torch.full_like(p, self._init_val,
                                          dtype=torch.float32)}

    def _update(self, p, g, s, lr, step):
        gf = g.float()
        acc = s["moment"] + gf.square()
        upd = gf / (acc.sqrt() + self._eps)
        return p.float() - upd * lr, {"moment": acc}


class RMSProp(Optimizer):
    def __init__(self, learning_rate=0.001, rho=0.95, epsilon=1e-6,
                 momentum=0.0, centered=False, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._rho, self._eps = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _init_state(self, p):
        st = {"mean_square": _zeros(p), "momentum": _zeros(p)}
        if self._centered:
            st["mean_grad"] = _zeros(p)
        return st

    def _update(self, p, g, s, lr, step):
        gf = g.float()
        rho = self._rho
        ms = s["mean_square"] * rho + gf.square() * (1 - rho)
        out = {"mean_square": ms}
        if self._centered:
            mg = s["mean_grad"] * rho + gf * (1 - rho)
            denom = (ms - mg.square() + self._eps).sqrt()
            out["mean_grad"] = mg
        else:
            denom = (ms + self._eps).sqrt()
        mom = s["momentum"] * self._momentum + (gf * lr) / denom
        out["momentum"] = mom
        return p.float() - mom, out


class Adadelta(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._eps, self._rho = epsilon, rho

    def _init_state(self, p):
        return {"avg_squared_grad": _zeros(p),
                "avg_squared_update": _zeros(p)}

    def _update(self, p, g, s, lr, step):
        gf = g.float()
        rho, eps = self._rho, self._eps
        asg = s["avg_squared_grad"] * rho + gf.square() * (1 - rho)
        upd = gf * (s["avg_squared_update"] + eps).sqrt() / (asg + eps).sqrt()
        asu = s["avg_squared_update"] * rho + upd.square() * (1 - rho)
        return p.float() - upd * lr, {"avg_squared_grad": asg,
                                      "avg_squared_update": asu}


class Adamax(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon

    def _init_state(self, p):
        return {"moment": _zeros(p), "inf_norm": _zeros(p)}

    def _update(self, p, g, s, lr, step):
        gf = g.float()
        b1 = self._beta1
        m = s["moment"] * b1 + gf * (1 - b1)
        u = torch.maximum(s["inf_norm"] * self._beta2, gf.abs())
        upd = m / (bias_correction(b1, step, p.device) * (u + self._eps))
        return p.float() - upd * lr, {"moment": m, "inf_norm": u}


class Lamb(Optimizer):
    _decoupled = True

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip, name,
                         multi_precision)
        self._weight_decay = lamb_weight_decay
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon
        self._exclude_fn = exclude_from_weight_decay_fn

    def _init_state(self, p):
        return {"moment1": _zeros(p), "moment2": _zeros(p)}

    def _update(self, p, g, s, lr, step):
        gf = g.float()
        b1, b2 = self._beta1, self._beta2
        m = s["moment1"] * b1 + gf * (1 - b1)
        v = s["moment2"] * b2 + gf.square() * (1 - b2)
        mhat = m / bias_correction(b1, step, p.device)
        vhat = v / bias_correction(b2, step, p.device)
        pf = p.float()
        wd = self._weight_decay
        if wd and self._exclude_fn is not None and \
                self._exclude_fn(self._current_param_name or ""):
            wd = 0.0
        r = mhat / (vhat.sqrt() + self._eps) + pf * wd
        w_norm = torch.linalg.vector_norm(pf)
        r_norm = torch.linalg.vector_norm(r)
        trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            torch.ones_like(w_norm))
        return pf - r * (trust * lr), {"moment1": m, "moment2": v}
