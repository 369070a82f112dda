"""The optimizers (``paddle_tpu/optimizer/optimizers.py``): SGD, Momentum,
Adam, AdamW, Adagrad, RMSProp, Adadelta, Adamax and Lamb, each rule the
reference's operations in its order, in fp32 (a bf16 parameter without a
master keeps the reference's bf16 roundings where its rule has them:
Momentum's velocity, the L2 decay).

Adam and AdamW update every parameter in one multi-tensor launch on the
card (``multi_tensor_adam``); the other rules run parameter by parameter,
on the card too.  ``Adam(lazy_mode=True)`` changes only the reference's
row-sparse rule, so on dense gradients it is the same update; a
row-sparse gradient waits (ROADMAP.md, queue 1, item 7).  AdamW takes
``lr_ratio`` and, as the reference does, never reads it."""

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

    def _update_all(self, names, params, grads, lr, step, scale, keep):
        """Every parameter in one ``multi_tensor_adam`` call."""
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
