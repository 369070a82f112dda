"""Normalization layers (``paddle_tpu/nn/norm_layers.py``): LayerNorm,
RMSNorm and the conv side, ``BatchNorm`` / ``BatchNorm1D/2D/3D``,
``SyncBatchNorm``, ``GroupNorm``, ``InstanceNorm1D/2D/3D``,
``LocalResponseNorm`` and ``SpectralNorm``, with the JAX package's
parameter and buffer names (``weight`` / ``bias``, the running
statistics ``_mean`` / ``_variance``, InstanceNorm's ``scale`` /
``bias``, SpectralNorm's ``weight_u`` / ``weight_v``).

A BatchNorm layer in training mode (and not ``use_global_stats``)
updates its running statistics in place from the batch's, outside the
graph, with the JAX package's convention (``:90-106``): ``running =
momentum * running + (1 - momentum) * batch`` (momentum 0.9), the
variance biased; inside a ``functional_call`` (the substitution flag)
they stay as they are, as under the JAX package's.  ``SyncBatchNorm`` in
one process is ``BatchNorm``; its several processes wait for the
distributed slice (ROADMAP.md, queue 1, item 8)."""

from __future__ import annotations

import numpy as np
import torch

from paddle_tpu_torch.core import functional as _cfunc
from paddle_tpu_torch.core.dispatch import eager_op
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn import initializer as I
from paddle_tpu_torch.nn.layer import Layer

__all__ = ["LayerNorm", "RMSNorm", "BatchNorm", "BatchNorm1D", "BatchNorm2D",
           "BatchNorm3D", "SyncBatchNorm", "GroupNorm", "InstanceNorm1D",
           "InstanceNorm2D", "InstanceNorm3D", "LocalResponseNorm",
           "SpectralNorm"]


class LayerNorm(Layer):
    """``F.layer_norm`` over the trailing ``normalized_shape`` axes with
    a weight of ones and a bias of zeros (``:24-46``); ``weight_attr`` /
    ``bias_attr`` False drop them, any other attr is read by
    ``create_parameter``."""

    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None, dtype="float32", device=None):
        super().__init__(dtype=dtype, device=device)
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        self.weight = None if weight_attr is False else \
            self.create_parameter(self._normalized_shape, attr=weight_attr,
                                  default_initializer=I.Constant(1.0))
        self.bias = None if bias_attr is False else \
            self.create_parameter(self._normalized_shape, attr=bias_attr,
                                  is_bias=True)

    def forward(self, x):
        return F.layer_norm(x, self._normalized_shape, self.weight,
                            self.bias, self._epsilon)


class RMSNorm(Layer):
    def __init__(self, hidden_size, epsilon=1e-6, weight_attr=None,
                 name=None, dtype="float32", device=None):
        super().__init__(dtype=dtype, device=device)
        self._epsilon = epsilon
        self.weight = self.create_parameter(
            [hidden_size], attr=weight_attr,
            default_initializer=I.Constant(1.0))

    def forward(self, x):
        return F.rms_norm(x, self.weight, self._epsilon)


class _BatchNormBase(Layer):
    _default_format = "NCHW"

    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format=None,
                 use_global_stats=None, name=None, dtype="float32",
                 device=None):
        super().__init__(dtype=dtype, device=device)
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format or self._default_format
        self._use_global_stats = use_global_stats
        self.weight = None if weight_attr is False else \
            self.create_parameter([num_features], attr=weight_attr,
                                  default_initializer=I.Constant(1.0))
        self.bias = None if bias_attr is False else \
            self.create_parameter([num_features], attr=bias_attr,
                                  is_bias=True)
        self.register_buffer("_mean", torch.zeros(
            num_features, dtype=torch.float32, device=self._device))
        self.register_buffer("_variance", torch.ones(
            num_features, dtype=torch.float32, device=self._device))

    def forward(self, x):
        training = self.training and not self._use_global_stats
        if training and not _cfunc.substitution_active():
            with torch.no_grad():
                mean, var = F.batch_norm_stats(x.detach(), self._data_format)
                m = self._momentum
                self._mean.copy_(self._mean * m + mean * (1 - m))
                self._variance.copy_(self._variance * m + var * (1 - m))
        return F.batch_norm(x, self._mean, self._variance, self.weight,
                            self.bias, training=training,
                            momentum=self._momentum, epsilon=self._epsilon,
                            data_format=self._data_format,
                            use_global_stats=self._use_global_stats)


class BatchNorm(_BatchNormBase):
    pass


class BatchNorm1D(_BatchNormBase):
    _default_format = "NCL"


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    _default_format = "NCDHW"


class SyncBatchNorm(_BatchNormBase):
    """Cross-replica BatchNorm; in one process it is BatchNorm."""

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        """`layer` with every BatchNorm below it replaced by a
        SyncBatchNorm holding the same parameters and statistics."""
        out = layer
        if isinstance(layer, _BatchNormBase) and \
                not isinstance(layer, SyncBatchNorm):
            out = SyncBatchNorm(
                layer._mean.shape[0], layer._momentum, layer._epsilon,
                weight_attr=False if layer.weight is None else None,
                bias_attr=False if layer.bias is None else None,
                data_format=layer._data_format,
                use_global_stats=layer._use_global_stats,
                dtype=layer._dtype, device=layer._mean.device)
            with torch.no_grad():
                for name in ("weight", "bias", "_mean", "_variance"):
                    src = getattr(layer, name)
                    if src is not None:
                        getattr(out, name).copy_(src)
        for name, sub in list(layer.named_children()):
            setattr(out, name, cls.convert_sync_batchnorm(sub))
        return out


class GroupNorm(Layer):
    def __init__(self, num_groups, num_channels, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, dtype="float32", device=None):
        super().__init__(dtype=dtype, device=device)
        self._num_groups = num_groups
        self._epsilon = epsilon
        self._data_format = data_format
        self.weight = None if weight_attr is False else \
            self.create_parameter([num_channels], attr=weight_attr,
                                  default_initializer=I.Constant(1.0))
        self.bias = None if bias_attr is False else \
            self.create_parameter([num_channels], attr=bias_attr,
                                  is_bias=True)

    def forward(self, x):
        return F.group_norm(x, self._num_groups, self._epsilon, self.weight,
                            self.bias, self._data_format)


class _InstanceNormBase(Layer):
    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, dtype="float32", device=None):
        super().__init__(dtype=dtype, device=device)
        self._epsilon = epsilon
        self.scale = None if weight_attr is False else \
            self.create_parameter([num_features], attr=weight_attr,
                                  default_initializer=I.Constant(1.0))
        self.bias = None if bias_attr is False else \
            self.create_parameter([num_features], attr=bias_attr,
                                  is_bias=True)

    def forward(self, x):
        return F.instance_norm(x, weight=self.scale, bias=self.bias,
                               eps=self._epsilon)


class InstanceNorm1D(_InstanceNormBase):
    pass


class InstanceNorm2D(_InstanceNormBase):
    pass


class InstanceNorm3D(_InstanceNormBase):
    pass


class LocalResponseNorm(Layer):
    def __init__(self, size, alpha=1e-4, beta=0.75, k=1.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self.args = (size, alpha, beta, k, data_format)

    def forward(self, x):
        return F.local_response_norm(x, *self.args)


class SpectralNorm(Layer):
    """`weight` divided by its largest singular value, estimated by
    ``power_iters`` power iterations from the buffers ``weight_u`` /
    ``weight_v`` (the JAX package's starting vectors: numpy's
    ``default_rng(0)`` and ``(1)`` normals), which the forward does not
    update, as there."""

    def __init__(self, weight_shape, dim=0, power_iters=1, eps=1e-12,
                 name=None, dtype="float32", device=None):
        super().__init__(dtype=dtype, device=device)
        self._dim = dim
        self._power_iters = power_iters
        self._eps = eps
        h = weight_shape[dim]
        w = int(np.prod(weight_shape)) // h
        self.register_buffer("weight_u", torch.from_numpy(
            np.random.default_rng(0).normal(size=h).astype(np.float32)).to(
                self._device))
        self.register_buffer("weight_v", torch.from_numpy(
            np.random.default_rng(1).normal(size=w).astype(np.float32)).to(
                self._device))

    def forward(self, weight):
        return _spectral_norm(weight, self.weight_u, self.weight_v,
                              self._dim, self._eps, self._power_iters)


@eager_op(name="spectral_norm")
def _spectral_norm(w, u, v, dim, eps, iters):
    wm = torch.movedim(w, dim, 0)
    wmat = wm.reshape(wm.shape[0], -1)
    for _ in range(iters):
        v = wmat.T @ u
        v = v / (torch.linalg.vector_norm(v) + eps)
        u = wmat @ v
        u = u / (torch.linalg.vector_norm(u) + eps)
    sigma = u @ wmat @ v
    return w / sigma
