"""The eager backward pass (``paddle_tpu/autograd/backward_engine.py``).

The JAX package walks its own tape of ``GradNode`` pullbacks; torch's
autograd engine is the port's tape, so :func:`run_backward` and
:func:`calc_gradients` are ``torch.autograd.backward`` / ``grad`` with
the JAX package's argument rules:

- ``retain_graph`` defaults to ``create_graph`` (:func:`calc_gradients`
  through ``autograd.grad``; ``backward`` frees the graph unless asked);
- an entry of ``grad_tensors`` / ``grad_outputs`` may be None: ones for
  a one-element output, an error for any other;
- ``allow_unused`` gives None for an input the outputs do not reach,
  and without it such an input raises ``RuntimeError``;
- :func:`run_backward` accumulates into ``.grad`` of the leaves.

Accumulation of a row-sparse gradient (an embedding's with ``sparse=
True``) is torch's ``AccumulateGrad`` on sparse COO tensors, which keeps
the JAX package's rules (``backward_engine.py:39-60, 225-240``): sparse
plus sparse concatenates the rows without coalescing them, sparse plus
dense is dense."""

from __future__ import annotations

from typing import List

import torch

__all__ = ["run_backward", "calc_gradients"]


def _seeds(outputs, grads, create_graph):
    if grads is None:
        grads = [None] * len(outputs)
    out = []
    for t, g in zip(outputs, grads):
        if not t.requires_grad:
            raise RuntimeError("backward() on a tensor with stop_gradient="
                               "True and no grad history")
        if g is None:
            if t.numel() != 1:
                raise RuntimeError(
                    "grad can be implicitly created only for scalar "
                    f"outputs; got shape {list(t.shape)}")
            g = torch.ones_like(t)
        elif not torch.is_tensor(g):
            g = torch.as_tensor(g, dtype=t.dtype, device=t.device)
        elif not create_graph:
            g = g.detach()
        out.append(g)
    return out


def run_backward(tensors: List[torch.Tensor], grad_tensors=None,
                 retain_graph: bool = False, create_graph: bool = False):
    """``.backward()`` of several outputs at once: the gradients land in
    ``.grad`` of the leaves that require them (and of non-leaves that
    called ``retain_grad()``)."""
    seeds = _seeds(tensors, grad_tensors, create_graph)
    torch.autograd.backward(list(tensors), seeds,
                            retain_graph=retain_graph or create_graph,
                            create_graph=create_graph)


def calc_gradients(outputs, inputs, grad_outputs=None, retain_graph=False,
                   allow_unused=False, create_graph=False):
    """The gradients of `outputs` with respect to `inputs`, without
    touching ``.grad``; with ``create_graph`` they carry their own
    history, so they can be differentiated again."""
    seeds = _seeds(outputs, grad_outputs, create_graph)
    inputs = list(inputs)
    # an input that requires no gradient is not in any graph: None
    live = [i for i, t in enumerate(inputs) if t.requires_grad]
    got = torch.autograd.grad(list(outputs), [inputs[i] for i in live],
                              seeds, retain_graph=retain_graph or create_graph,
                              create_graph=create_graph, allow_unused=True) \
        if live else ()
    grads = [None] * len(inputs)
    for i, g in zip(live, got):
        grads[i] = g
    if not allow_unused and any(g is None for g in grads):
        raise RuntimeError(
            "One of the differentiated tensors appears to not have been "
            "used in the graph. Set allow_unused=True if this is desired.")
    return grads
