"""LR schedulers (``paddle_tpu/optimizer/lr.py``), copied from the JAX
package, which writes them in plain Python.

Each scheduler stays on the host: ``scheduler()`` returns the current
lr and ``.step()`` advances it.  ``TrainStep`` writes that value into a
device scalar before each call, so a captured CUDA graph reads it at
replay time; ``.lr_at(step)`` evaluates the schedule at any step."""

from __future__ import annotations

import math

__all__ = ["LRScheduler", "NoamDecay", "ExponentialDecay", "NaturalExpDecay",
           "InverseTimeDecay", "PolynomialDecay", "LinearWarmup",
           "PiecewiseDecay", "CosineAnnealingDecay", "StepDecay",
           "MultiStepDecay", "LambdaDecay", "ReduceOnPlateau",
           "MultiplicativeDecay", "OneCycleLR", "CyclicLR",
           "CosineAnnealingWarmRestarts"]


class LRScheduler:
    def __init__(self, learning_rate=0.1, last_epoch=-1, verbose=False):
        self.base_lr = float(learning_rate)
        self.last_epoch = last_epoch
        self.verbose = verbose
        self.last_lr = self.base_lr
        self.step()

    def __call__(self):
        return self.last_lr

    def get_lr(self):
        raise NotImplementedError

    def lr_at(self, step):
        """Pure schedule for jitted loops; defaults to host formula."""
        saved = self.last_epoch
        self.last_epoch = int(step)
        try:
            return self.get_lr()
        finally:
            self.last_epoch = saved

    def step(self, epoch=None):
        if epoch is None:
            self.last_epoch += 1
        else:
            self.last_epoch = epoch
        self.last_lr = self.get_lr()

    def state_dict(self):
        return {"last_epoch": self.last_epoch, "last_lr": self.last_lr}

    def set_state_dict(self, state):
        self.last_epoch = state["last_epoch"]
        self.last_lr = state["last_lr"]

    set_dict = set_state_dict
    state_keys = state_dict


class NoamDecay(LRScheduler):
    def __init__(self, d_model, warmup_steps, learning_rate=1.0,
                 last_epoch=-1, verbose=False):
        self.d_model = d_model
        self.warmup_steps = warmup_steps
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        step = max(self.last_epoch, 1)
        a = step ** -0.5
        b = step * (self.warmup_steps ** -1.5)
        return self.base_lr * (self.d_model ** -0.5) * min(a, b)


class ExponentialDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * self.gamma ** max(self.last_epoch, 0)


class NaturalExpDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * math.exp(-self.gamma * max(self.last_epoch, 0))


class InverseTimeDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr / (1 + self.gamma * max(self.last_epoch, 0))


class PolynomialDecay(LRScheduler):
    def __init__(self, learning_rate, decay_steps, end_lr=0.0001, power=1.0,
                 cycle=False, last_epoch=-1, verbose=False):
        self.decay_steps = decay_steps
        self.end_lr = end_lr
        self.power = power
        self.cycle = cycle
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        step = max(self.last_epoch, 0)
        if self.cycle:
            div = math.ceil(step / self.decay_steps) or 1
            decay = self.decay_steps * div
        else:
            decay = self.decay_steps
            step = min(step, decay)
        frac = (1 - step / decay) ** self.power
        return (self.base_lr - self.end_lr) * frac + self.end_lr


class LinearWarmup(LRScheduler):
    def __init__(self, learning_rate, warmup_steps, start_lr, end_lr,
                 last_epoch=-1, verbose=False):
        self.lr_sched = learning_rate if isinstance(learning_rate,
                                                    LRScheduler) else None
        self.target = learning_rate if not self.lr_sched else None
        self.warmup_steps = warmup_steps
        self.start_lr = start_lr
        self.end_lr = end_lr
        super().__init__(end_lr, last_epoch, verbose)

    def get_lr(self):
        step = max(self.last_epoch, 0)
        if step < self.warmup_steps:
            return self.start_lr + (self.end_lr - self.start_lr) * \
                step / self.warmup_steps
        if self.lr_sched is not None:
            self.lr_sched.last_epoch = step - self.warmup_steps
            return self.lr_sched.get_lr()
        return float(self.target)


class PiecewiseDecay(LRScheduler):
    def __init__(self, boundaries, values, last_epoch=-1, verbose=False):
        self.boundaries = boundaries
        self.values = values
        super().__init__(values[0], last_epoch, verbose)

    def get_lr(self):
        step = max(self.last_epoch, 0)
        for b, v in zip(self.boundaries, self.values):
            if step < b:
                return v
        return self.values[len(self.boundaries)]


class CosineAnnealingDecay(LRScheduler):
    def __init__(self, learning_rate, T_max, eta_min=0, last_epoch=-1,
                 verbose=False):
        self.T_max = T_max
        self.eta_min = eta_min
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        step = max(self.last_epoch, 0)
        return self.eta_min + (self.base_lr - self.eta_min) * \
            (1 + math.cos(math.pi * step / self.T_max)) / 2


class CosineAnnealingWarmRestarts(LRScheduler):
    def __init__(self, learning_rate, T_0, T_mult=1, eta_min=0,
                 last_epoch=-1, verbose=False):
        self.T_0, self.T_mult, self.eta_min = T_0, T_mult, eta_min
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        step = max(self.last_epoch, 0)
        t_i = self.T_0
        t_cur = step
        while t_cur >= t_i:
            t_cur -= t_i
            t_i *= self.T_mult
        return self.eta_min + (self.base_lr - self.eta_min) * \
            (1 + math.cos(math.pi * t_cur / t_i)) / 2


class StepDecay(LRScheduler):
    def __init__(self, learning_rate, step_size, gamma=0.1, last_epoch=-1,
                 verbose=False):
        self.step_size = step_size
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * self.gamma ** (max(self.last_epoch, 0) //
                                             self.step_size)


class MultiStepDecay(LRScheduler):
    def __init__(self, learning_rate, milestones, gamma=0.1, last_epoch=-1,
                 verbose=False):
        self.milestones = milestones
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        step = max(self.last_epoch, 0)
        n = sum(1 for m in self.milestones if step >= m)
        return self.base_lr * self.gamma ** n


class LambdaDecay(LRScheduler):
    def __init__(self, learning_rate, lr_lambda, last_epoch=-1, verbose=False):
        self.lr_lambda = lr_lambda
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * self.lr_lambda(max(self.last_epoch, 0))


class MultiplicativeDecay(LRScheduler):
    def __init__(self, learning_rate, lr_lambda, last_epoch=-1, verbose=False):
        self.lr_lambda = lr_lambda
        self._cur = float(learning_rate)
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        if self.last_epoch > 0:
            self._cur = self._cur * self.lr_lambda(self.last_epoch)
        return self._cur


class ReduceOnPlateau(LRScheduler):
    def __init__(self, learning_rate, mode="min", factor=0.1, patience=10,
                 threshold=1e-4, threshold_mode="rel", cooldown=0, min_lr=0,
                 epsilon=1e-8, verbose=False):
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.threshold_mode = threshold_mode
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.best = None
        self.num_bad = 0
        self.cooldown_counter = 0
        self._lr = float(learning_rate)
        self.base_lr = float(learning_rate)
        self.last_epoch = 0
        self.last_lr = self._lr
        self.verbose = verbose

    def get_lr(self):
        return self._lr

    def step(self, metrics=None, epoch=None):
        if metrics is None:
            return
        import numpy as np
        value = float(np.asarray(metrics).reshape(-1)[0])
        if self.best is None:
            self.best = value
        else:
            better = value < self.best - (abs(self.best) * self.threshold
                                          if self.threshold_mode == "rel"
                                          else self.threshold) \
                if self.mode == "min" else \
                value > self.best + (abs(self.best) * self.threshold
                                     if self.threshold_mode == "rel"
                                     else self.threshold)
            if better:
                self.best = value
                self.num_bad = 0
            else:
                self.num_bad += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad = 0
        elif self.num_bad > self.patience:
            self._lr = max(self._lr * self.factor, self.min_lr)
            self.cooldown_counter = self.cooldown
            self.num_bad = 0
        self.last_lr = self._lr


class OneCycleLR(LRScheduler):
    def __init__(self, max_learning_rate, total_steps, divide_factor=25.0,
                 end_learning_rate=0.0001, phase_pct=0.3,
                 anneal_strategy="cos", three_phase=False, last_epoch=-1,
                 verbose=False):
        self.max_lr = max_learning_rate
        self.total_steps = total_steps
        self.initial_lr = max_learning_rate / divide_factor
        self.end_lr = end_learning_rate
        self.phase_pct = phase_pct
        self.anneal = anneal_strategy
        super().__init__(self.initial_lr, last_epoch, verbose)

    def _anneal(self, start, end, pct):
        if self.anneal == "cos":
            return end + (start - end) * (1 + math.cos(math.pi * pct)) / 2
        return start + (end - start) * pct

    def get_lr(self):
        step = max(self.last_epoch, 0)
        up = self.phase_pct * self.total_steps
        if step <= up:
            return self._anneal(self.initial_lr, self.max_lr,
                                step / max(up, 1))
        pct = (step - up) / max(self.total_steps - up, 1)
        return self._anneal(self.max_lr, self.end_lr, min(pct, 1.0))


class CyclicLR(LRScheduler):
    def __init__(self, base_learning_rate, max_learning_rate,
                 step_size_up=2000, step_size_down=None, mode="triangular",
                 exp_gamma=1.0, scale_fn=None, scale_mode="cycle",
                 last_epoch=-1, verbose=False):
        self.base_lr_ = base_learning_rate
        self.max_lr = max_learning_rate
        self.up = step_size_up
        self.down = step_size_down or step_size_up
        self.mode = mode
        self.exp_gamma = exp_gamma
        super().__init__(base_learning_rate, last_epoch, verbose)

    def get_lr(self):
        step = max(self.last_epoch, 0)
        cycle_len = self.up + self.down
        cycle = step // cycle_len
        x = step - cycle * cycle_len
        if x < self.up:
            pct = x / self.up
        else:
            pct = 1 - (x - self.up) / self.down
        amp = self.max_lr - self.base_lr_
        if self.mode == "triangular2":
            amp = amp / (2 ** cycle)
        elif self.mode == "exp_range":
            amp = amp * (self.exp_gamma ** step)
        return self.base_lr_ + amp * pct
