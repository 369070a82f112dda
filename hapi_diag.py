#!/usr/bin/env python3
"""Where a hapi-ResNet-50 step goes, on one NVIDIA GPU.

    python3 hapi_diag.py

ResNet-50 in fp32 at b=64, 224 x 224, Momentum(0.1, 0.9, weight_decay
1e-4), the seeded images of ``chip_smoke.py``'s hapi phase:

* the eager step (``chip_smoke.py``'s resnet50 loop) and ``TrainStep``
  with ``loss_fn=CrossEntropyLoss()`` on one batch already on the card,
  6 steps each, and one profiled step of each (the device's busy share);
* ``Model.fit`` over the same 6 batches fed four ways: numpy arrays in
  memory, the seeded dataset in the loop's process, and 2 loader workers
  with their batches through the pool's pipe (``use_shared_memory=
  False``) and through ``/dev/shm``: the median host seconds of steps
  2-6, split into the loader wait, the host-to-device copy and the step.

Prints one JSON line per part, the card's name and power limit first.
Needs the kernels' build (``chip_smoke.py`` does it on first use)."""

import json
import sys
import time

import numpy as np
import torch

import chip_smoke as cs

B, STEPS = 64, 6


class Arrays:
    """Samples from numpy arrays held in memory."""

    def __init__(self, x, y):
        self.x, self.y = x, y

    def __getitem__(self, i):
        return self.x[i], self.y[i]

    def __len__(self):
        return len(self.x)


def timed(fn, n=STEPS):
    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return out


def main():
    if not torch.cuda.is_available():
        print("hapi_diag: CUDA is not available", file=sys.stderr)
        return 2
    from paddle_tpu_torch import Model, nn, seed
    from paddle_tpu_torch.io import DataLoader
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision import models
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.nvidia_smi(), flush=True)
    _build.build_all()
    ds = cs.SeededImages(STEPS * B, 1)
    xs = np.stack([ds[i][0] for i in range(len(ds))])
    ys = np.array([ds[i][1] for i in range(len(ds))])
    xb = torch.from_numpy(xs[:B]).to(dev)
    yb = torch.from_numpy(ys[:B]).to(dev)

    def opt(net):
        return Momentum(learning_rate=0.1, momentum=0.9, weight_decay=1e-4,
                        parameters=net.parameters())

    seed(0)
    net = models.resnet50(device=dev)
    o = opt(net)

    def eager():
        loss = F.cross_entropy(net(xb), yb)
        loss.backward()
        o.step()
        o.clear_grad()
        return float(loss.detach())
    steps = {"eager": timed(eager)}
    cs.profile_call(eager, "hapi_diag_eager_profile", ("ce_fwd_kernel",), 8)
    del net, o
    seed(0)
    net = models.resnet50(device=dev)
    step = TrainStep(net, opt(net), loss_fn=nn.CrossEntropyLoss())
    steps["trainstep"] = timed(lambda: float(step((xb, yb))))
    cs.profile_call(lambda: float(step((xb, yb))),
                    "hapi_diag_trainstep_profile", ("ce_fwd_kernel",), 8)
    del step, net
    cs.emit("hapi_diag_steps", batch=B, step_s=steps,
            median_s={k: float(np.median(v[1:])) for k, v in steps.items()})
    feeds = (("arrays", lambda: Arrays(xs, ys)),
             ("seeded_one_process", lambda: ds),
             ("seeded_2_workers_pipe", lambda: DataLoader(
                 ds, batch_size=B, num_workers=2, use_shared_memory=False)),
             ("seeded_2_workers_shm", lambda: DataLoader(
                 ds, batch_size=B, num_workers=2)))
    for name, make in feeds:
        seed(0)
        net = models.resnet50(device=dev)
        m = Model(net)
        m.prepare(opt(net), nn.CrossEntropyLoss())
        data = make()
        t0 = time.perf_counter()
        m.fit(data, batch_size=B, epochs=1, shuffle=False, verbose=0)
        fit_s = time.perf_counter() - t0
        if isinstance(data, DataLoader):
            data.close()
        st = m.last_fit_stats
        cs.emit("hapi_diag_fit", feed=name, fit_s=fit_s, **st,
                median_s={k: float(np.median(v[1:])) for k, v in st.items()})
        del m, net
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
