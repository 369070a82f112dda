"""The autograd API (``paddle_tpu/autograd/__init__.py``).

:func:`backward` and :func:`grad` run torch's autograd engine under the
JAX package's argument rules (``backward_engine.py``).  :class:`PyLayer`
is the custom-VJP extension point (``:46-143``) as a
``torch.autograd.Function`` built once per subclass:

- ``forward(ctx, *args, **kwargs)`` runs under ``no_grad``;
- ``backward(ctx, *grads)`` returns one gradient per tensor input (those
  of inputs that need none are dropped) or one per input that needs a
  gradient, in order; any other count raises;
- ``ctx`` is a :class:`PyLayerContext`: ``save_for_backward``, the
  ``saved_tensor`` property and the ``saved_tensors()`` method (torch's
  saved-tensor slots underneath, so a saved input keeps its history);
- under ``grad(..., create_graph=True)`` the user's backward runs taped,
  so its gradients can be differentiated again.

:func:`jacobian` (``batch_axis`` None or 0, lists of ys and xs) and
:func:`hessian` (cross blocks included) have the JAX package's shapes
and seeding (``:145-252``): one backward per output element, or per
output element of a row under ``batch_axis=0``."""

from __future__ import annotations

import numpy as np
import torch

from paddle_tpu_torch.autograd.backward_engine import (calc_gradients,
                                                       run_backward)
from paddle_tpu_torch.core.tensor import (enable_grad, is_grad_enabled,
                                          no_grad, set_grad_enabled)

__all__ = ["backward", "grad", "PyLayer", "PyLayerContext", "no_grad",
           "enable_grad", "is_grad_enabled", "set_grad_enabled", "hessian",
           "jacobian"]


def backward(tensors, grad_tensors=None, retain_graph=False):
    if torch.is_tensor(tensors):
        tensors = [tensors]
    if torch.is_tensor(grad_tensors):
        grad_tensors = [grad_tensors]
    run_backward(list(tensors), grad_tensors, retain_graph=retain_graph)


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, only_inputs=True, allow_unused=False,
         no_grad_vars=None):
    if torch.is_tensor(outputs):
        outputs = [outputs]
    if torch.is_tensor(inputs):
        inputs = [inputs]
    if torch.is_tensor(grad_outputs):
        grad_outputs = [grad_outputs]
    retain = bool(retain_graph) if retain_graph is not None \
        else bool(create_graph)
    return calc_gradients(list(outputs), list(inputs), grad_outputs,
                          retain_graph=retain, allow_unused=allow_unused,
                          create_graph=create_graph)


class PyLayerContext:
    def __init__(self):
        self._saved = ()
        self.materialize_grads = True

    def save_for_backward(self, *tensors):
        self._saved = tensors

    @property
    def saved_tensor(self):
        return self._saved

    def saved_tensors(self):
        return self._saved


def _function_of(cls):
    """The ``torch.autograd.Function`` standing for PyLayer subclass
    `cls` (made on first use, kept on the class)."""
    fn = cls.__dict__.get("_torch_function")
    if fn is not None:
        return fn

    class _Fn(torch.autograd.Function):
        @staticmethod
        def forward(ctx, kwargs, *args):
            pctx = PyLayerContext()
            out = cls.forward(pctx, *args, **kwargs)
            saved = pctx._saved
            # tensors go to torch's slots (their history survives for a
            # taped backward); anything else stays on the context
            slots = [i for i, t in enumerate(saved) if torch.is_tensor(t)]
            ctx.save_for_backward(*[saved[i] for i in slots])
            ctx.pctx, ctx.slots, ctx.n_saved = pctx, slots, len(saved)
            ctx.tensor_pos = [i for i, a in enumerate(args)
                              if torch.is_tensor(a)]
            ctx.diff_pos = [i for i in ctx.tensor_pos
                            if args[i].requires_grad]
            ctx.n_args = len(args)
            return out

        @staticmethod
        def backward(ctx, *grads):
            pctx = ctx.pctx
            saved = list(pctx._saved)
            for i, t in zip(ctx.slots, ctx.saved_tensors):
                saved[i] = t
            pctx._saved = tuple(saved)
            got = cls.backward(pctx, *grads)
            if not isinstance(got, (tuple, list)):
                got = (got,)
            got = list(got)
            if len(got) == len(ctx.diff_pos):
                pos = ctx.diff_pos
            elif len(got) == len(ctx.tensor_pos):
                pos = ctx.tensor_pos
            else:
                raise RuntimeError(
                    f"PyLayer.backward returned {len(got)} grads, "
                    f"expected {len(ctx.diff_pos)}")
            out = [None] * ctx.n_args
            for i, g in zip(pos, got):
                if i in ctx.diff_pos:
                    out[i] = g
            return (None, *out)

    _Fn.__name__ = _Fn.__qualname__ = cls.__name__
    cls._torch_function = _Fn
    return _Fn


class PyLayer:
    """User-defined forward/backward (reference: python/paddle/autograd/
    py_layer.py:29): subclass with ``@staticmethod forward(ctx, *args)``
    and ``backward(ctx, *grads)``, call ``apply``."""

    @staticmethod
    def forward(ctx, *args, **kwargs):
        raise NotImplementedError

    @staticmethod
    def backward(ctx, *args):
        raise NotImplementedError

    @classmethod
    def apply(cls, *args, **kwargs):
        return _function_of(cls).apply(kwargs, *args)


def _seeded_grads(y, x, seeds, create_graph):
    """``d(seed . y)/dx`` for each seed: zeros where y does not reach x."""
    out = []
    for seed in seeds:
        g = None
        if y.requires_grad:
            g = grad([y], [x], grad_outputs=[seed], retain_graph=True,
                     create_graph=create_graph, allow_unused=True)[0]
        out.append(torch.zeros_like(x) if g is None else g)
    return out


def _dense_jacobian(y, x, create_graph=False):
    """``y.shape + x.shape``: one seeded backward per element of y."""
    n = max(1, y.numel())
    eye = torch.eye(n, dtype=y.dtype, device=y.device)
    rows = _seeded_grads(y, x, [eye[i].reshape(y.shape) for i in range(n)],
                         create_graph)
    return torch.stack(rows, 0).reshape(list(y.shape) + list(x.shape))


def _batched_jacobian(y, x, create_graph=False):
    """``(B, *y.shape[1:], *x.shape[1:])`` under ``batch_axis=0``: rows
    independent, so seeding element m of every row at once gives
    ``J[:, m]`` in one backward."""
    b = y.shape[0]
    per = max(1, int(np.prod(y.shape[1:])))
    seeds = []
    for m in range(per):
        s = torch.zeros((b, per), dtype=y.dtype, device=y.device)
        s[:, m] = 1.0
        seeds.append(s.reshape(y.shape))
    rows = _seeded_grads(y, x, seeds, create_graph)
    out = torch.stack(rows, 1)
    return out.reshape([b] + list(y.shape[1:]) + list(x.shape[1:]))


def jacobian(ys, xs, batch_axis=None):
    """Dense Jacobian of ys with respect to xs: ``ys.shape + xs.shape``,
    or with ``batch_axis=0`` the batched one.  Lists of ys and / or xs
    give nested lists ``[y][x]`` (a single one drops its level)."""
    if batch_axis not in (None, 0):
        raise ValueError("jacobian: batch_axis must be None or 0")
    jac = _dense_jacobian if batch_axis is None else _batched_jacobian
    multi_y = not torch.is_tensor(ys)
    multi_x = not torch.is_tensor(xs)
    ys_l = list(ys) if multi_y else [ys]
    xs_l = list(xs) if multi_x else [xs]
    out = [[jac(y, x) for x in xs_l] for y in ys_l]
    if not multi_y and not multi_x:
        return out[0][0]
    if not multi_y:
        return out[0]
    if not multi_x:
        return [row[0] for row in out]
    return out


def hessian(ys, xs, batch_axis=None):
    """Dense Hessian of a scalar ys: ``xs.shape + xs.shape``, or for a
    list of xs the blocks ``H[i][j] = d2 ys / (dx_i dx_j)``."""
    if not torch.is_tensor(ys):
        raise ValueError("hessian expects a scalar Tensor output")
    if batch_axis is not None:
        raise ValueError("hessian: batch_axis is not supported for a scalar "
                         "output; take jacobian(grad, x, batch_axis=0)")
    multi_x = not torch.is_tensor(xs)
    xs_l = list(xs) if multi_x else [xs]
    firsts = grad([ys], xs_l, create_graph=True, allow_unused=True)
    out = []
    for g1, xi in zip(firsts, xs_l):
        row = []
        for xj in xs_l:
            if g1 is None:
                row.append(torch.zeros(list(xi.shape) + list(xj.shape),
                                       dtype=xi.dtype, device=xi.device))
            else:
                row.append(_dense_jacobian(g1, xj))
        out.append(row)
    return out if multi_x else out[0][0]
