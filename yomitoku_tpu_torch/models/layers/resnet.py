"""ResNet-50 backbone with dilation, inference form (counterpart of
yomitoku_tpu/models/layers/resnet.py).

torchvision's resnet50 with ``replace_stride_with_dilation=[False, False,
True]`` as the reference DBNet uses it: features layer1 /4, layer2 /8,
layer3 /16, layer4 /16 (3x3 convolutions dilated 2x instead of strided).
BatchNorm is frozen: an affine map from stored statistics.  Parameter
names follow torchvision's state_dict.  Runs NCHW; the convolutions are
library convolutions, as XLA ran them in the JAX package (its opt-in
Pallas bottleneck and stage kernels are not ported).
"""

import torch
import torch.nn.functional as F
from torch import nn


class FrozenBatchNorm(nn.Module):
    """y = (x - mean) / sqrt(var + eps) * weight + bias from stored
    statistics (torch BatchNorm2d in eval mode, channel axis 1)."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(features))
        self.register_buffer("bias", torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x):
        inv = torch.rsqrt(self.running_var.float() + self.eps)
        mul = self.weight.float() * inv
        add = self.bias.float() - self.running_mean.float() * mul
        shape = (1, -1) + (1,) * (x.dim() - 2)
        return x * mul.to(x.dtype).view(shape) + add.to(x.dtype).view(shape)


def _conv(cin, cout, kernel, stride=1, dilation=1):
    return nn.Conv2d(cin, cout, kernel, stride,
                     padding=dilation * (kernel - 1) // 2,
                     dilation=dilation, bias=False)


class Bottleneck(nn.Module):
    def __init__(self, inplanes, planes, stride=1, dilation=1, downsample=False):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 1)
        self.bn1 = FrozenBatchNorm(planes)
        self.conv2 = _conv(planes, planes, 3, stride, dilation)
        self.bn2 = FrozenBatchNorm(planes)
        self.conv3 = _conv(planes, planes * 4, 1)
        self.bn3 = FrozenBatchNorm(planes * 4)
        self.downsample = (
            nn.Sequential(_conv(inplanes, planes * 4, 1, stride),
                          FrozenBatchNorm(planes * 4))
            if downsample else None
        )

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(out + x)


class ResNetFeatures(nn.Module):
    """torchvision-style ResNet returning {layer1..layer4} features."""

    def __init__(self, layers=(3, 4, 6, 3), dilate_last: bool = True):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = FrozenBatchNorm(64)
        inplanes, planes, dilation = 64, 64, 1
        for li, blocks in enumerate(layers):
            stride = 1 if li == 0 else 2
            prev_dilation = dilation
            if li == 3 and dilate_last:
                # torchvision replace_stride_with_dilation: the first block
                # keeps the previous dilation, later blocks dilate
                dilation *= stride
                stride = 1
            mods = [Bottleneck(inplanes, planes, stride, prev_dilation, True)]
            mods += [Bottleneck(planes * 4, planes, 1, dilation)
                     for _ in range(1, blocks)]
            setattr(self, f"layer{li + 1}", nn.Sequential(*mods))
            inplanes, planes = planes * 4, planes * 2

    def forward(self, x):  # (B, 3, H, W)
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        feats = {}
        for i in range(1, 5):
            x = getattr(self, f"layer{i}")(x)
            feats[f"layer{i}"] = x
        return feats
