"""The op surface as ``torch.Tensor`` methods
(``paddle_tpu/core/tensor_methods.py:79-112``).

The JAX package installs every name of its op modules' ``__all__``
(math, linalg, manipulation, logic, search, stat; ``is_tensor`` and
``where`` skipped), then ``zeros_like`` / ``ones_like`` / ``full_like``
/ ``tril`` / ``triu`` / ``diag`` / ``where`` and ``rank``, on its own
``Tensor``.  The port's tensors are torch's, so the same table is read
over the port's op modules, and a name is installed only where
``torch.Tensor`` has no attribute of that name: no torch method,
property or operator is replaced, so torch's own code behaves as
before.  ``x.concat(...)``, ``x.cast("float16")`` or ``x.rank()`` call
the port's ops; ``x.add(y)``, ``x.T`` and ``x + y`` stay torch's (the
operators do not pass the op hook: ROADMAP.md, queue 3)."""

from __future__ import annotations

from typing import Dict

import torch

from paddle_tpu_torch.ops import (creation, linalg, logic, manipulation,
                                  math, search, stat)

__all__ = ["INSTALLED", "install"]

_METHOD_SOURCES = [math, linalg, manipulation, logic, search, stat]

# names that clash with tensor internals or builtins (JAX's list)
_SKIP = {"is_tensor", "where"}

_EXTRA_METHODS = {
    "zeros_like": creation.zeros_like,
    "ones_like": creation.ones_like,
    "full_like": creation.full_like,
    "tril": creation.tril,
    "triu": creation.triu,
    "diag": creation.diag,
    "where": manipulation.where,
    "rank": lambda self: self.ndim,
}

# name -> the function installed on torch.Tensor by this module
INSTALLED: Dict[str, object] = {}


def install():
    """Put every table name torch.Tensor lacks on it (idempotent)."""
    table = {}
    for mod in _METHOD_SOURCES:
        for name in getattr(mod, "__all__", []):
            fn = getattr(mod, name, None)
            if name not in _SKIP and callable(fn):
                table.setdefault(name, fn)
    for name, fn in _EXTRA_METHODS.items():
        table.setdefault(name, fn)
    # JAX's rank is the ndim lambda whatever the modules hold
    table["rank"] = _EXTRA_METHODS["rank"]
    for name, fn in table.items():
        if name in INSTALLED or hasattr(torch.Tensor, name):
            continue
        setattr(torch.Tensor, name, fn)
        INSTALLED[name] = fn


install()
