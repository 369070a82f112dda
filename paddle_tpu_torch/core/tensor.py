"""Grad mode and ``Parameter`` (``paddle_tpu/core/tensor.py:52-86,
417-432``).

Torch tensors are the port's tensors, so the JAX package's ``Tensor``
wrapper and its ``GradNode`` tape have no counterpart here: torch's
autograd is the tape (``autograd/``), and the op surface's methods are
installed on ``torch.Tensor`` where torch lacks the name
(``core/tensor_methods.py``).  Grad mode is torch's:
:func:`no_grad` and :func:`enable_grad` are context managers,
:func:`set_grad_enabled` sets it (and, as torch's, also works as a
context manager), :func:`is_grad_enabled` reads it.

:class:`Parameter` is an ``nn.Parameter`` with the JAX package's
attributes: ``stop_gradient`` is ``not requires_grad`` (setting one sets
the other), ``trainable`` (kept apart, as there), ``optimize_attr``
(``{"learning_rate": 1.0}``), ``regularizer``, ``need_clip`` (read by the
clips of an optimizer's eager ``step``), ``is_distributed`` and ``name``.  The
optimizers skip a parameter whose ``stop_gradient`` is set."""

from __future__ import annotations

import copy

import torch
from torch import nn

__all__ = ["Parameter", "no_grad", "enable_grad", "is_grad_enabled",
           "set_grad_enabled"]


def is_grad_enabled() -> bool:
    return torch.is_grad_enabled()


def set_grad_enabled(mode: bool):
    return torch.set_grad_enabled(bool(mode))


def no_grad():
    return torch.no_grad()


def enable_grad():
    return torch.enable_grad()


class Parameter(nn.Parameter):
    """A trainable tensor as a Layer registers it (``stop_gradient``
    False unless ``trainable`` is False).  ``Parameter(data,
    requires_grad)`` is torch's signature, which torch's own copies
    call."""

    def __new__(cls, data=None, requires_grad: bool = True, *,
                trainable=None, name=None):
        if data is None:
            data = torch.empty(0)
        if trainable is not None:
            requires_grad = bool(trainable)
        self = super().__new__(cls, data, requires_grad=requires_grad)
        self.trainable = bool(requires_grad)
        self.optimize_attr = {"learning_rate": 1.0}
        self.regularizer = None
        self.need_clip = True
        self.is_distributed = False
        self.persistable = True
        if name is not None:
            self.name = name
        return self

    def __init__(self, *args, **kwargs):
        pass

    @property
    def name(self):
        """The parameter's name (None unless given); kept in the
        instance, since torch's ``Tensor.name`` cannot be written."""
        return self.__dict__.get("_ptt_name")

    @name.setter
    def name(self, value):
        self.__dict__["_ptt_name"] = value

    @property
    def stop_gradient(self) -> bool:
        return not self.requires_grad

    @stop_gradient.setter
    def stop_gradient(self, value: bool):
        self.requires_grad_(not value)

    def __deepcopy__(self, memo):
        if id(self) in memo:
            return memo[id(self)]
        out = type(self)(self.data.clone(memory_format=torch.preserve_format),
                         self.requires_grad)
        memo[id(self)] = out
        for k, v in self.__dict__.items():
            setattr(out, k, copy.deepcopy(v, memo))
        return out
