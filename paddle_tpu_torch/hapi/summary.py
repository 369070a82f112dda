"""``paddle.summary`` and ``paddle.flops`` (``paddle_tpu/hapi/
summary.py``).

``summary`` lists the parameters and, given an input size or an input,
runs one forward for the output shape: under ``no_grad`` with the
substitution flag of ``core.functional`` set, so a BatchNorm in training
mode leaves its running statistics as they were (the JAX package's
eager probe moves them).

``flops`` counts the forward's operations with the port's cost model
(``analysis/passes/cost_model.py``'s ``count_cost``: one eager run under
a dispatch mode, matrix products and convolutions 2 M N K, elementwise
operators one an output element, transcendentals ten, reductions one an
input element, a kernel wrapper its own charge) where the JAX package
asks XLA's cost analysis of the compiled forward (``:72-103``).  The
two agree on the products and count elementwise work differently:
XLA's count follows its fused program."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["summary", "flops"]


def _layer_of(net):
    from paddle_tpu_torch.nn.layer import Layer
    if not isinstance(net, Layer):
        raise TypeError(f"summary/flops expects a Layer, got {type(net)}")
    return net


def _device_of(net):
    for p in net.parameters():
        return p.device
    from paddle_tpu_torch.core.state import resolve_device
    return resolve_device()


def _probe(net, x):
    from paddle_tpu_torch.core import functional as _func
    with torch.no_grad(), _func.substitute():
        return net(x)


def summary(net, input_size=None, dtypes=None, input=None):
    """Per-parameter table and totals.  With `input_size` (or an example
    `input`) the forward runs once and the output shape is reported.
    Returns ``{'total_params', 'trainable_params'[, 'output_shape']}``."""
    net = _layer_of(net)
    out_shape = None
    if input is not None or input_size is not None:
        if input is None:
            from paddle_tpu_torch.core.dtypes import to_torch
            dt = to_torch(dtypes) if isinstance(dtypes, str) else \
                torch.float32
            input = torch.zeros(tuple(input_size), dtype=dt,
                                device=_device_of(net))
        probe = _probe(net, input)
        first = probe[0] if isinstance(probe, (tuple, list)) else probe
        out_shape = tuple(first.shape)
    total = 0
    trainable = 0
    rows = []
    for name, p in net.named_parameters():
        n = int(np.prod(p.shape)) if len(p.shape) else 1
        total += n
        if p.requires_grad:
            trainable += n
        rows.append((name, tuple(p.shape), n))

    width = max((len(r[0]) for r in rows), default=20) + 2
    lines = [f"{'Layer (parameter)':{width}s} {'Shape':22s} {'Param #':>12s}",
             "-" * (width + 36)]
    for name, shape, n in rows:
        lines.append(f"{name:{width}s} {str(shape):22s} {n:>12,d}")
    lines.append("-" * (width + 36))
    lines.append(f"Total params: {total:,d}")
    lines.append(f"Trainable params: {trainable:,d}")
    lines.append(f"Non-trainable params: {total - trainable:,d}")
    if out_shape is not None:
        lines.append(f"Output shape: {out_shape}")
    print("\n".join(lines))
    info = {"total_params": total, "trainable_params": trainable}
    if out_shape is not None:
        info["output_shape"] = out_shape
    return info


def flops(net, input_size, custom_ops=None, print_detail: bool = False):
    """The forward's operations on zeros of `input_size` (one input's
    shape, e.g. ``[1, 3, 224, 224]``) in the parameters' dtype, counted
    by the cost model (module docstring)."""
    from paddle_tpu_torch.analysis.passes.cost_model import count_cost
    net = _layer_of(net)
    params = list(net.parameters())
    dtype = params[0].dtype if params else torch.float32
    x = torch.zeros(tuple(input_size), dtype=dtype, device=_device_of(net))
    _, counter = count_cost(_probe, net, x)
    n = int(counter.total_flops)
    if print_detail:
        total_p = sum(p.numel() for p in params)
        print(f"FLOPs: {n:,d}  (params: {total_p:,d}, "
              f"input: {tuple(input_size)})")
    return n
