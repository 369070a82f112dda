"""The ResNet family (``paddle_tpu/vision/models/resnet.py``): NCHW,
convolutions without bias, BatchNorm2D keeping its running statistics
in training mode, the JAX package's layer names (``conv1``, ``bn1``,
``layer1``..``layer4`` of blocks ``0``.., ``downsample.0`` / ``.1``,
``fc``).  A model is built on `device`: the card unless the caller
names another or has called ``set_device("cpu")``; fp32 unless `dtype`
says otherwise."""

from __future__ import annotations

from typing import List, Type, Union

import torch

from paddle_tpu_torch.core.state import resolve_device
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.common_layers import Linear, Sequential
from paddle_tpu_torch.nn.conv_layers import Conv2D
from paddle_tpu_torch.nn.layer import Layer
from paddle_tpu_torch.nn.norm_layers import BatchNorm2D
from paddle_tpu_torch.nn.pooling_layers import AdaptiveAvgPool2D, MaxPool2D

__all__ = ["ResNet", "BasicBlock", "BottleneckBlock", "resnet18",
           "resnet34", "resnet50", "resnet101", "resnet152"]


def _conv3x3(cin, cout, stride=1, **kw):
    return Conv2D(cin, cout, 3, stride=stride, padding=1, bias_attr=False,
                  **kw)


def _conv1x1(cin, cout, stride=1, **kw):
    return Conv2D(cin, cout, 1, stride=stride, bias_attr=False, **kw)


class BasicBlock(Layer):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 dtype="float32", device=None):
        super().__init__(dtype=dtype, device=device)
        kw = dict(dtype=dtype, device=device)
        self.conv1 = _conv3x3(inplanes, planes, stride, **kw)
        self.bn1 = BatchNorm2D(planes, **kw)
        self.conv2 = _conv3x3(planes, planes, **kw)
        self.bn2 = BatchNorm2D(planes, **kw)
        self.downsample = downsample
        self._relu = F.relu

    def forward(self, x):
        identity = x
        out = self._relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self._relu(out + identity)


class BottleneckBlock(Layer):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 dtype="float32", device=None):
        super().__init__(dtype=dtype, device=device)
        kw = dict(dtype=dtype, device=device)
        self.conv1 = _conv1x1(inplanes, planes, **kw)
        self.bn1 = BatchNorm2D(planes, **kw)
        self.conv2 = _conv3x3(planes, planes, stride, **kw)
        self.bn2 = BatchNorm2D(planes, **kw)
        self.conv3 = _conv1x1(planes, planes * self.expansion, **kw)
        self.bn3 = BatchNorm2D(planes * self.expansion, **kw)
        self.downsample = downsample
        self._relu = F.relu

    def forward(self, x):
        identity = x
        out = self._relu(self.bn1(self.conv1(x)))
        out = self._relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self._relu(out + identity)


class ResNet(Layer):
    def __init__(self, block: Type[Union[BasicBlock, BottleneckBlock]],
                 depth_layers: List[int], num_classes: int = 1000,
                 with_pool: bool = True, in_channels: int = 3,
                 dtype="float32", device=None):
        device = resolve_device(device)
        super().__init__(dtype=dtype, device=device)
        self._kw = dict(dtype=dtype, device=device)
        self.inplanes = 64
        self.conv1 = Conv2D(in_channels, 64, 7, stride=2, padding=3,
                            bias_attr=False, **self._kw)
        self.bn1 = BatchNorm2D(64, **self._kw)
        self.maxpool = MaxPool2D(kernel_size=3, stride=2, padding=1)
        self.layer1 = self._make_layer(block, 64, depth_layers[0])
        self.layer2 = self._make_layer(block, 128, depth_layers[1], 2)
        self.layer3 = self._make_layer(block, 256, depth_layers[2], 2)
        self.layer4 = self._make_layer(block, 512, depth_layers[3], 2)
        self.with_pool = with_pool
        if with_pool:
            self.avgpool = AdaptiveAvgPool2D(1)
        self.num_classes = num_classes
        if num_classes > 0:
            self.fc = Linear(512 * block.expansion, num_classes, **self._kw)

    def _make_layer(self, block, planes, blocks, stride=1):
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = Sequential(
                _conv1x1(self.inplanes, planes * block.expansion, stride,
                         **self._kw),
                BatchNorm2D(planes * block.expansion, **self._kw))
        layers = [block(self.inplanes, planes, stride, downsample,
                        **self._kw)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(block(self.inplanes, planes, **self._kw))
        return Sequential(*layers)

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = self.maxpool(x)
        x = self.layer1(x)
        x = self.layer2(x)
        x = self.layer3(x)
        x = self.layer4(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = torch.flatten(x, 1)
            x = self.fc(x)
        return x


def resnet18(num_classes=1000, **kw):
    return ResNet(BasicBlock, [2, 2, 2, 2], num_classes, **kw)


def resnet34(num_classes=1000, **kw):
    return ResNet(BasicBlock, [3, 4, 6, 3], num_classes, **kw)


def resnet50(num_classes=1000, **kw):
    return ResNet(BottleneckBlock, [3, 4, 6, 3], num_classes, **kw)


def resnet101(num_classes=1000, **kw):
    return ResNet(BottleneckBlock, [3, 4, 23, 3], num_classes, **kw)


def resnet152(num_classes=1000, **kw):
    return ResNet(BottleneckBlock, [3, 8, 36, 3], num_classes, **kw)
