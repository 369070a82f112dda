"""Adam and AdamW (``paddle_tpu/optimizer/optimizers.py:53-154``): fp32
moments, bias correction, AdamW's decoupled weight decay.  The other
optimizers of the JAX package wait (ROADMAP.md, queue 1, item 4)."""

from __future__ import annotations

import torch

from paddle_tpu_torch.optimizer.optimizer import Optimizer, _unported

__all__ = ["Adam", "AdamW"]


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 name=None):
        if lazy_mode:
            raise _unported("lazy_mode (row-sparse Adam)")
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon

    def _init_state(self, p):
        return {"moment1": torch.zeros_like(p, dtype=torch.float32),
                "moment2": torch.zeros_like(p, dtype=torch.float32)}

    def _decoupled_wd(self, name: str) -> float:
        """The decoupled decay coefficient of parameter `name`: none in
        Adam, whose weight decay is L2 folded into the gradient."""
        return 0.0

    def _update(self, p, g, s, lr, step, name):
        # the JAX rule's operations in its order, each rounded to fp32:
        # m = b1 m + (1 - b1) g; v = b2 v + (1 - b2) g^2;
        # p - lr * (m / bc1 / (sqrt(v / bc2) + eps) + wd p)
        b1, b2 = self._beta1, self._beta2
        gf = g.float()
        m, v = s["moment1"], s["moment2"]
        m.mul_(b1).add_(gf * (1 - b1))
        v.mul_(b2).add_(gf.square().mul_(1 - b2))
        denom = (v / (1 - b2 ** step)).sqrt_().add_(self._eps)
        upd = (m / (1 - b1 ** step)).div_(denom)
        del denom
        pf = p if p.dtype == torch.float32 else p.float()
        wd = self._decoupled_wd(name)
        if wd:
            upd.add_(pf * wd)
        pf.sub_(upd.mul_(lr))
        return pf


class AdamW(Adam):
    """Adam with decoupled weight decay (default 0.01) on every
    parameter unless ``apply_decay_param_fun(name)`` says otherwise; the
    name is the parameter's state-dict name under ``TrainStep``."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None):
        if lr_ratio is not None:
            raise _unported("lr_ratio")
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode, multi_precision, name)
        self._weight_decay = float(weight_decay) if weight_decay else 0.0
        self._apply_decay_param_fun = apply_decay_param_fun

    def _apply_weight_decay(self, param, grad):
        return grad                     # decayed in the rule instead

    def _decoupled_wd(self, name: str) -> float:
        wd = self._weight_decay
        if wd and self._apply_decay_param_fun is not None and \
                not self._apply_decay_param_fun(name):
            return 0.0
        return wd
