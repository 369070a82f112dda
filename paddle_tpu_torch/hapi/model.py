"""hapi's ``Model`` (``paddle_tpu/hapi/model.py``): the Keras-like train
loop over ``TrainStep``, fed by ``io.DataLoader``, with callbacks and
metrics on the host.

* ``prepare(optimizer, loss, metrics)`` builds the port's ``TrainStep``
  with ``loss_fn=loss`` (``:42-54``); ``mesh=``, ``param_specs=`` and
  ``batch_spec=`` wait for meshes (ROADMAP.md, queue 1, item 8).
* Each batch (numpy from the loader, or tensors) is put on the
  network's device by the model before the step; ``train_batch`` reads
  the loss as a Python float, one host sync a step, as JAX's ``:95``.
* ``predict_batch`` / ``evaluate`` / ``predict`` run the network under
  ``no_grad`` with the substitution flag of ``core.functional`` set, in
  the network's current mode: the JAX package runs a jitted
  ``functional_call`` (``:56-74``), so a BatchNorm left in training
  mode by ``fit`` normalises with the batch's statistics and leaves its
  running statistics as they were, here as there.  The evaluation loss
  is computed on the device output; metrics and ``predict`` get numpy,
  a bfloat16 / float8 output widened to float32 (exact; numpy has no
  bfloat16 without ``ml_dtypes``).
* ``save(path)`` writes ``path.pdparams`` (the network's state dict) and
  ``path.pdopt`` (the step's state dict) with ``framework.save``;
  ``load`` reads them onto the network's device, in place.

``last_fit_stats`` keeps the last ``fit``'s host seconds a train step:
``data_s`` (waiting on the loader), ``h2d_s`` (placing the batch) and
``step_s`` (the step, through the loss's read)."""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from paddle_tpu_torch.hapi.callbacks import config_callbacks

__all__ = ["Model"]

_WIDEN = (torch.bfloat16, torch.float8_e4m3fn, torch.float8_e5m2)


def _as_list(x):
    if x is None:
        return []
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _numpy(out):
    """A network output as numpy (a tuple or list of them, each)."""
    if isinstance(out, (tuple, list)):
        return type(out)(_numpy(o) for o in out)
    t = out.detach().to("cpu")
    return (t.float() if t.dtype in _WIDEN else t).numpy()


class Model:
    def __init__(self, network, inputs=None, labels=None):
        self.network = network
        self._inputs = inputs
        self._labels = labels
        self._optimizer = None
        self._loss = None
        self._metrics = []
        self._train_step = None
        self._step_handles_lr = True  # TrainStep steps the scheduler
        self.stop_training = False
        self.last_fit_stats = None

    @property
    def device(self) -> torch.device:
        """The device of the network's first parameter (the port's
        default device for a network without one)."""
        for p in self.network.parameters():
            return p.device
        from paddle_tpu_torch.core.state import resolve_device
        return resolve_device()

    # -- configuration -------------------------------------------------------
    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None, mesh=None, param_specs=None,
                batch_spec=None):
        if mesh is not None or param_specs is not None or \
                batch_spec is not None:
            raise NotImplementedError(
                "Model.prepare's mesh=, param_specs= and batch_spec= are "
                "not ported yet (ROADMAP.md, queue 1, item 8)")
        self._optimizer = optimizer
        self._loss = loss
        self._metrics = _as_list(metrics)
        if optimizer is not None and loss is not None:
            from paddle_tpu_torch.jit import TrainStep
            self._train_step = TrainStep(
                self.network, optimizer,
                loss_fn=loss if callable(loss) else None)
        return self

    def _place(self, a):
        """`a` (numpy, a tensor, or a tuple / list / dict of them) on the
        network's device."""
        if isinstance(a, dict):
            return {k: self._place(v) for k, v in a.items()}
        if isinstance(a, (tuple, list)):
            return type(a)(self._place(v) for v in a)
        from paddle_tpu_torch.io.device_prefetch import as_tensor
        return as_tensor(a).to(self.device)

    def _forward(self, inputs):
        """The network on the first input, no gradient, the running
        statistics untouched (module docstring)."""
        from paddle_tpu_torch.core import functional as _func
        x = self._place(_as_list(inputs)[0])
        with torch.no_grad(), _func.substitute():
            return self.network(x)

    # -- single-batch APIs ---------------------------------------------------
    def train_batch(self, inputs, labels=None):
        if self._train_step is None:
            raise RuntimeError("call prepare(optimizer, loss) first")
        inputs = _as_list(inputs)
        labels = _as_list(labels)
        if self._loss is None or (labels and not callable(self._loss)):
            raise RuntimeError("prepare() needs a callable loss")
        batch = (inputs[0] if len(inputs) == 1 else tuple(inputs),
                 labels[0] if len(labels) == 1 else tuple(labels))
        loss = self._train_step(self._place(batch))
        return float(loss)

    def eval_batch(self, inputs, labels=None):
        out = self._forward(inputs)
        if labels is None or self._loss is None:
            return _numpy(out)
        y = self._place(_as_list(labels)[0])
        return float(self._loss(out, y))

    def predict_batch(self, inputs):
        return _numpy(self._forward(inputs))

    # -- loops ---------------------------------------------------------------
    def _make_loader(self, data, batch_size, shuffle, num_workers,
                     drop_last=False):
        from paddle_tpu_torch.io import DataLoader
        if data is None or isinstance(data, DataLoader):
            return data
        return DataLoader(data, batch_size=batch_size, shuffle=shuffle,
                          num_workers=num_workers, drop_last=drop_last)

    def fit(self, train_data=None, eval_data=None, batch_size=1,
            epochs=1, eval_freq=1, log_freq=10, save_dir=None, save_freq=1,
            verbose=1, drop_last=False, shuffle=True, num_workers=0,
            callbacks=None):
        loader = self._make_loader(train_data, batch_size, shuffle,
                                   num_workers, drop_last)
        eval_loader = self._make_loader(eval_data, batch_size, False,
                                        num_workers)
        try:
            steps = len(loader)
        except TypeError:
            steps = None
        cbks = config_callbacks(callbacks, model=self, epochs=epochs,
                                steps=steps, log_freq=log_freq,
                                verbose=verbose, save_freq=save_freq,
                                save_dir=save_dir,
                                metrics=[m.name() for m in self._metrics])
        stats = self.last_fit_stats = {"data_s": [], "h2d_s": [],
                                       "step_s": []}
        cbks.on_train_begin()
        history = {"loss": []}
        for epoch in range(epochs):
            cbks.on_epoch_begin(epoch)
            if hasattr(loader, "batch_sampler") and hasattr(
                    loader.batch_sampler, "set_epoch"):
                loader.batch_sampler.set_epoch(epoch)
            epoch_losses = []
            it = iter(loader)
            step = 0
            while True:
                t0 = time.perf_counter()
                batch = next(it, None)
                if batch is None:
                    break
                t1 = time.perf_counter()
                cbks.on_train_batch_begin(step)
                x, y = self._split_batch(batch)
                x, y = self._place(x), self._place(y)
                t2 = time.perf_counter()
                loss = self.train_batch(x, y)
                stats["data_s"].append(t1 - t0)
                stats["h2d_s"].append(t2 - t1)
                stats["step_s"].append(time.perf_counter() - t2)
                epoch_losses.append(loss)
                cbks.on_train_batch_end(step, {"loss": loss})
                step += 1
            logs = {"loss": float(np.mean(epoch_losses))
                    if epoch_losses else 0.0}
            history["loss"].append(logs["loss"])
            cbks.on_epoch_end(epoch, logs)
            if eval_loader is not None and (epoch + 1) % eval_freq == 0:
                self.evaluate(eval_loader, verbose=0, _cbks=cbks)
                for c in cbks.callbacks:
                    if getattr(c, "stop_training", False):
                        self.stop_training = True
            if self.stop_training:
                break
        cbks.on_train_end()
        return history

    def _split_batch(self, batch):
        if isinstance(batch, dict):
            return batch, None
        if isinstance(batch, (list, tuple)) and len(batch) >= 2:
            return list(batch[:-1]), [batch[-1]]
        return [batch], None

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=1,
                 num_workers=0, callbacks=None, _cbks=None):
        loader = self._make_loader(eval_data, batch_size, False, num_workers)
        for m in self._metrics:
            m.reset()
        losses = []
        cbks = _cbks
        if cbks is not None:
            cbks.on_eval_begin()
        for batch in loader:
            x, y = self._split_batch(batch)
            out_dev = self._forward(x)
            out = _numpy(out_dev)
            if y is not None and self._loss is not None:
                lv = self._loss(out_dev, self._place(y[0]))
                losses.append(float(lv))
            for m in self._metrics:
                if y is not None:
                    # compute may return (pred, label) for the update
                    outs = m.compute(out, np.asarray(y[0]))
                    m.update(*(outs if isinstance(outs, tuple) else (outs,)))
        logs = {}
        if losses:
            logs["loss"] = float(np.mean(losses))
        for m in self._metrics:
            name = m.name()
            acc = m.accumulate()
            if isinstance(name, list):
                logs.update(dict(zip(name, acc)))
            else:
                logs[name] = acc
        if cbks is not None:
            cbks.on_eval_end(logs)
        return logs

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, verbose=0, callbacks=None):
        loader = self._make_loader(test_data, batch_size, False, num_workers)
        outs = []
        for batch in loader:
            x, _ = self._split_batch(batch)
            outs.append(self.predict_batch(x))
        if stack_outputs:
            return np.concatenate(outs, axis=0)
        return outs

    # -- persistence ---------------------------------------------------------
    def save(self, path, training=True):
        from paddle_tpu_torch.framework import save
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        save(self.network.state_dict(), path + ".pdparams")
        if training and self._train_step is not None:
            save(self._train_step.state_dict(), path + ".pdopt")

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        from paddle_tpu_torch.framework import load
        self.network.set_state_dict(load(path + ".pdparams",
                                         device=self.device))
        if not reset_optimizer and self._train_step is not None and \
                os.path.exists(path + ".pdopt"):
            self._train_step.set_state_dict(load(path + ".pdopt",
                                                 device=self.device))

    def parameters(self, *args, **kwargs):
        return self.network.parameters(*args, **kwargs)

    def summary(self, input_size=None, dtype=None):
        total = 0
        lines = []
        for name, p in self.network.named_parameters():
            n = int(np.prod(p.shape))
            total += n
            lines.append(f"  {name:60s} {str(tuple(p.shape)):20s} {n}")
        text = "\n".join(lines)
        print(f"Total params: {total}\n{text}")
        return {"total_params": total}
