"""hapi callbacks (``paddle_tpu/hapi/callbacks.py``): the JAX
package's, host-side Python.  ``ModelCheckpoint`` writes
``<save_dir>/<epoch>`` and ``<save_dir>/final`` through ``Model.save``
(``.pdparams``, ``.pdopt``); ``LRScheduler`` steps the optimizer's
scheduler only where ``TrainStep`` does not (it does after every
call)."""

from __future__ import annotations

import os
import time
from typing import List, Optional

import numpy as np

__all__ = ["Callback", "ProgBarLogger", "ModelCheckpoint", "EarlyStopping",
           "LRScheduler", "config_callbacks"]


class Callback:
    def __init__(self):
        self.model = None
        self.params = {}

    def set_model(self, model):
        self.model = model

    def set_params(self, params):
        self.params = params or {}

    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_eval_begin(self, logs=None):
        pass

    def on_eval_end(self, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_train_batch_begin(self, step, logs=None):
        pass

    def on_train_batch_end(self, step, logs=None):
        pass

    def on_eval_batch_begin(self, step, logs=None):
        pass

    def on_eval_batch_end(self, step, logs=None):
        pass


class CallbackList:
    def __init__(self, callbacks: List[Callback]):
        self.callbacks = callbacks

    def set_model(self, model):
        for c in self.callbacks:
            c.set_model(model)

    def set_params(self, params):
        for c in self.callbacks:
            c.set_params(params)

    def __getattr__(self, name):
        if name.startswith("on_"):
            def fanout(*args, **kwargs):
                for c in self.callbacks:
                    getattr(c, name)(*args, **kwargs)
            return fanout
        raise AttributeError(name)


class ProgBarLogger(Callback):
    def __init__(self, log_freq: int = 10, verbose: int = 1):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch
        self.steps = self.params.get("steps")
        self._t0 = time.time()
        if self.verbose:
            print(f"Epoch {epoch + 1}/{self.params.get('epochs', '?')}")

    def on_train_batch_end(self, step, logs=None):
        if self.verbose and step % self.log_freq == 0:
            logs = logs or {}
            items = " - ".join(
                f"{k}: {np.asarray(v).item():.4f}"
                if np.ndim(v) == 0 else f"{k}: {v}"
                for k, v in logs.items())
            dt = (time.time() - self._t0) / max(step, 1)
            print(f"step {step}/{self.steps or '?'} - {items} "
                  f"- {dt * 1000:.0f}ms/step")

    def on_eval_end(self, logs=None):
        if self.verbose and logs:
            items = " - ".join(f"{k}: {v}" for k, v in logs.items())
            print(f"Eval - {items}")


class ModelCheckpoint(Callback):
    def __init__(self, save_freq: int = 1, save_dir: str = "checkpoint"):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.model is not None and epoch % self.save_freq == 0:
            path = os.path.join(self.save_dir, str(epoch))
            self.model.save(path)

    def on_train_end(self, logs=None):
        if self.model is not None:
            self.model.save(os.path.join(self.save_dir, "final"))


class EarlyStopping(Callback):
    def __init__(self, monitor="loss", mode="auto", patience=0,
                 verbose=1, min_delta=0, baseline=None,
                 save_best_model=True):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.min_delta = abs(min_delta)
        self.baseline = baseline
        self.wait = 0
        self.stopped_epoch = 0
        if mode == "auto":
            mode = "min" if "loss" in monitor or "err" in monitor else "max"
        self.mode = mode
        self.best = np.inf if mode == "min" else -np.inf
        self.stop_training = False

    def _better(self, cur):
        if self.mode == "min":
            return cur < self.best - self.min_delta
        return cur > self.best + self.min_delta

    def on_eval_end(self, logs=None):
        logs = logs or {}
        if self.monitor not in logs:
            return
        cur = float(np.asarray(logs[self.monitor]).ravel()[0])
        if self._better(cur):
            self.best = cur
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.stop_training = True


class LRScheduler(Callback):
    """Step the optimizer's LR scheduler per epoch or per batch
    (reference hapi/callbacks.py LRScheduler)."""

    def __init__(self, by_step: bool = True, by_epoch: bool = False):
        super().__init__()
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        opt = getattr(self.model, "_optimizer", None)
        return getattr(opt, "_lr_scheduler", None) if opt else None

    def on_train_batch_end(self, step, logs=None):
        s = self._sched()
        if self.by_step and s is not None and \
                not getattr(self.model, "_step_handles_lr", False):
            s.step()

    def on_epoch_end(self, epoch, logs=None):
        s = self._sched()
        if self.by_epoch and s is not None:
            s.step()


def config_callbacks(callbacks=None, model=None, epochs=None, steps=None,
                     log_freq=10, verbose=1, save_freq=1, save_dir=None,
                     metrics=None, mode="train"):
    cbks = list(callbacks or [])
    if not any(isinstance(c, ProgBarLogger) for c in cbks) and verbose:
        cbks = [ProgBarLogger(log_freq, verbose=verbose)] + cbks
    if save_dir and not any(isinstance(c, ModelCheckpoint) for c in cbks):
        cbks.append(ModelCheckpoint(save_freq, save_dir))
    lst = CallbackList(cbks)
    lst.set_model(model)
    lst.set_params({"epochs": epochs, "steps": steps, "verbose": verbose,
                    "metrics": metrics or []})
    return lst
