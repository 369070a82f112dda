"""The classic CNN zoo (``paddle_tpu/vision/models/zoo.py``): LeNet,
AlexNet, VGG, MobileNetV2 and SqueezeNet, NCHW, with the JAX package's
layer names.  Each model is built on `device`: the card unless the
caller names another or has called ``set_device("cpu")``."""

from __future__ import annotations

import torch

from paddle_tpu_torch.core.state import resolve_device
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.common_layers import Dropout, Linear, ReLU, Sequential
from paddle_tpu_torch.nn.conv_layers import Conv2D
from paddle_tpu_torch.nn.layer import Layer
from paddle_tpu_torch.nn.norm_layers import BatchNorm2D
from paddle_tpu_torch.nn.pooling_layers import AdaptiveAvgPool2D, MaxPool2D

__all__ = ["LeNet", "AlexNet", "VGG", "vgg11", "vgg13", "vgg16", "vgg19",
           "MobileNetV2", "mobilenet_v2", "SqueezeNet", "squeezenet1_0",
           "squeezenet1_1"]


class LeNet(Layer):
    """28 x 28 inputs."""

    def __init__(self, num_classes: int = 10, device=None):
        dev = resolve_device(device)
        super().__init__(device=dev)
        self.features = Sequential(
            Conv2D(1, 6, 3, stride=1, padding=1, device=dev), ReLU(),
            MaxPool2D(2, 2),
            Conv2D(6, 16, 5, stride=1, padding=0, device=dev), ReLU(),
            MaxPool2D(2, 2))
        self.fc = Sequential(
            Linear(400, 120, device=dev), Linear(120, 84, device=dev),
            Linear(84, num_classes, device=dev))

    def forward(self, x):
        return self.fc(torch.flatten(self.features(x), 1))


class AlexNet(Layer):
    def __init__(self, num_classes: int = 1000, dropout: float = 0.5,
                 device=None):
        dev = resolve_device(device)
        super().__init__(device=dev)
        self.features = Sequential(
            Conv2D(3, 64, 11, stride=4, padding=2, device=dev), ReLU(),
            MaxPool2D(3, 2),
            Conv2D(64, 192, 5, padding=2, device=dev), ReLU(),
            MaxPool2D(3, 2),
            Conv2D(192, 384, 3, padding=1, device=dev), ReLU(),
            Conv2D(384, 256, 3, padding=1, device=dev), ReLU(),
            Conv2D(256, 256, 3, padding=1, device=dev), ReLU(),
            MaxPool2D(3, 2))
        self.avgpool = AdaptiveAvgPool2D((6, 6))
        self.classifier = Sequential(
            Dropout(dropout), Linear(256 * 36, 4096, device=dev), ReLU(),
            Dropout(dropout), Linear(4096, 4096, device=dev), ReLU(),
            Linear(4096, num_classes, device=dev))

    def forward(self, x):
        x = self.avgpool(self.features(x))
        return self.classifier(torch.flatten(x, 1))


_VGG_CFGS = {
    "A": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "B": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M",
          512, 512, "M"],
    "D": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512,
          "M", 512, 512, 512, "M"],
    "E": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
          512, 512, 512, 512, "M", 512, 512, 512, 512, "M"],
}


class VGG(Layer):
    def __init__(self, features, num_classes: int = 1000,
                 with_pool: bool = True, device=None):
        dev = resolve_device(device)
        super().__init__(device=dev)
        self.features = features
        self.with_pool = with_pool
        if with_pool:
            self.avgpool = AdaptiveAvgPool2D((7, 7))
        self.classifier = Sequential(
            Linear(512 * 49, 4096, device=dev), ReLU(), Dropout(0.5),
            Linear(4096, 4096, device=dev), ReLU(), Dropout(0.5),
            Linear(4096, num_classes, device=dev))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.avgpool(x)
        return self.classifier(torch.flatten(x, 1))


def _vgg_features(cfg, batch_norm=False, device=None):
    layers = []
    cin = 3
    for v in _VGG_CFGS[cfg]:
        if v == "M":
            layers.append(MaxPool2D(2, 2))
        else:
            layers.append(Conv2D(cin, v, 3, padding=1, device=device))
            if batch_norm:
                layers.append(BatchNorm2D(v, device=device))
            layers.append(ReLU())
            cin = v
    return Sequential(*layers)


def _vgg(cfg, batch_norm, device=None, **kw):
    dev = resolve_device(device)
    return VGG(_vgg_features(cfg, batch_norm, dev), device=dev, **kw)


def vgg11(batch_norm=False, **kw):
    return _vgg("A", batch_norm, **kw)


def vgg13(batch_norm=False, **kw):
    return _vgg("B", batch_norm, **kw)


def vgg16(batch_norm=False, **kw):
    return _vgg("D", batch_norm, **kw)


def vgg19(batch_norm=False, **kw):
    return _vgg("E", batch_norm, **kw)


class _InvertedResidual(Layer):
    def __init__(self, cin, cout, stride, expand_ratio, device=None):
        super().__init__(device=device)
        hidden = int(round(cin * expand_ratio))
        self.use_res = stride == 1 and cin == cout
        kw = dict(bias_attr=False, device=device)
        layers = []
        if expand_ratio != 1:
            layers += [Conv2D(cin, hidden, 1, **kw),
                       BatchNorm2D(hidden, device=device), ReLU()]
        layers += [
            Conv2D(hidden, hidden, 3, stride=stride, padding=1,
                   groups=hidden, **kw),
            BatchNorm2D(hidden, device=device), ReLU(),
            Conv2D(hidden, cout, 1, **kw), BatchNorm2D(cout, device=device)]
        self.conv = Sequential(*layers)

    def forward(self, x):
        out = self.conv(x)
        return x + out if self.use_res else out


class MobileNetV2(Layer):
    """Inverted residuals."""

    def __init__(self, scale: float = 1.0, num_classes: int = 1000,
                 with_pool: bool = True, device=None):
        dev = resolve_device(device)
        super().__init__(device=dev)
        cfg = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
               (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]
        cin = max(8, int(32 * scale))
        features = [Conv2D(3, cin, 3, stride=2, padding=1, bias_attr=False,
                           device=dev), BatchNorm2D(cin, device=dev), ReLU()]
        for t, c, n, s in cfg:
            cout = max(8, int(c * scale))
            for i in range(n):
                features.append(_InvertedResidual(
                    cin, cout, s if i == 0 else 1, t, device=dev))
                cin = cout
        self.last_channel = max(1280, int(1280 * scale))
        features += [Conv2D(cin, self.last_channel, 1, bias_attr=False,
                            device=dev),
                     BatchNorm2D(self.last_channel, device=dev), ReLU()]
        self.features = Sequential(*features)
        self.with_pool = with_pool
        if with_pool:
            self.pool = AdaptiveAvgPool2D((1, 1))
        self.classifier = Sequential(
            Dropout(0.2), Linear(self.last_channel, num_classes, device=dev))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        return self.classifier(torch.flatten(x, 1))


def mobilenet_v2(scale=1.0, **kw):
    return MobileNetV2(scale=scale, **kw)


class _Fire(Layer):
    def __init__(self, cin, squeeze, e1, e3, device=None):
        super().__init__(device=device)
        self.squeeze = Conv2D(cin, squeeze, 1, device=device)
        self.expand1 = Conv2D(squeeze, e1, 1, device=device)
        self.expand3 = Conv2D(squeeze, e3, 3, padding=1, device=device)

    def forward(self, x):
        s = F.relu(self.squeeze(x))
        return torch.cat([F.relu(self.expand1(s)),
                          F.relu(self.expand3(s))], dim=1)


class SqueezeNet(Layer):
    def __init__(self, version: str = "1.0", num_classes: int = 1000,
                 device=None):
        if version not in ("1.0", "1.1"):
            raise ValueError(f"unsupported SqueezeNet version {version!r}; "
                             "expected '1.0' or '1.1'")
        dev = resolve_device(device)
        super().__init__(device=dev)

        def fire(*a):
            return _Fire(*a, device=dev)

        if version == "1.0":
            self.features = Sequential(
                Conv2D(3, 96, 7, stride=2, device=dev), ReLU(),
                MaxPool2D(3, 2),
                fire(96, 16, 64, 64), fire(128, 16, 64, 64),
                fire(128, 32, 128, 128), MaxPool2D(3, 2),
                fire(256, 32, 128, 128), fire(256, 48, 192, 192),
                fire(384, 48, 192, 192), fire(384, 64, 256, 256),
                MaxPool2D(3, 2), fire(512, 64, 256, 256))
        else:
            self.features = Sequential(
                Conv2D(3, 64, 3, stride=2, device=dev), ReLU(),
                MaxPool2D(3, 2),
                fire(64, 16, 64, 64), fire(128, 16, 64, 64),
                MaxPool2D(3, 2),
                fire(128, 32, 128, 128), fire(256, 32, 128, 128),
                MaxPool2D(3, 2),
                fire(256, 48, 192, 192), fire(384, 48, 192, 192),
                fire(384, 64, 256, 256), fire(512, 64, 256, 256))
        self.classifier = Sequential(
            Dropout(0.5), Conv2D(512, num_classes, 1, device=dev), ReLU(),
            AdaptiveAvgPool2D((1, 1)))

    def forward(self, x):
        return torch.flatten(self.classifier(self.features(x)), 1)


def squeezenet1_0(**kw):
    return SqueezeNet("1.0", **kw)


def squeezenet1_1(**kw):
    return SqueezeNet("1.1", **kw)
