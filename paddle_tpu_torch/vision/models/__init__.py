"""The vision model zoo (``paddle_tpu/vision/models/``): the ResNet
family, LeNet, AlexNet, VGG, MobileNetV2 and SqueezeNet, with the JAX
package's parameter names."""

from paddle_tpu_torch.vision.models.resnet import (  # noqa: F401
    BasicBlock, BottleneckBlock, ResNet, resnet18, resnet34, resnet50,
    resnet101, resnet152)
from paddle_tpu_torch.vision.models.zoo import (  # noqa: F401
    AlexNet, LeNet, MobileNetV2, SqueezeNet, VGG, mobilenet_v2,
    squeezenet1_0, squeezenet1_1, vgg11, vgg13, vgg16, vgg19)

__all__ = ["ResNet", "BasicBlock", "BottleneckBlock", "resnet18",
           "resnet34", "resnet50", "resnet101", "resnet152",
           "AlexNet", "LeNet", "MobileNetV2", "SqueezeNet", "VGG",
           "mobilenet_v2", "squeezenet1_0", "squeezenet1_1",
           "vgg11", "vgg13", "vgg16", "vgg19"]
