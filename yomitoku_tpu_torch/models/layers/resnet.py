"""ResNet-50 backbone with dilation, inference form (counterpart of
yomitoku_tpu/models/layers/resnet.py).

torchvision's resnet50 with ``replace_stride_with_dilation=[False, False,
True]`` as the reference DBNet uses it: features layer1 /4, layer2 /8,
layer3 /16, layer4 /16 (3x3 convolutions dilated 2x instead of strided).
BatchNorm is frozen: an affine map from stored statistics.  Parameter
names follow torchvision's state_dict.  Runs NCHW on library convolutions,
as XLA ran them in the JAX package.

The fused-backbone configuration, opt-in as in the JAX package and read at
every forward as the JAX package reads it at every trace:
YOMITOKU_TPU_FUSED_BOTTLENECK=1 runs each stride-1 ``Bottleneck`` (a
stage's block 0 with its projection, where stride 1) on the
``fused_bottleneck`` kernel, and YOMITOKU_TPU_FUSED_STAGE=1 runs the
identity tail of each stage (blocks 1..N) on ``fused_identity_stage``,
both on CUDA tensors only (where the JAX package asks for its TPU
backend; its "interpret" mode of the stage switch is not ported).  The
Mosaic conditions of the JAX gates (``bottleneck_th`` / ``stage_th``: H and
W % 8, Cin % 128, a strip that fits VMEM) are dropped: the CUDA kernels
take any H, W and dilation, which at DBNet's 1600x1184 input admits every
stride-1 block (JAX's TPU gate would admit only layer1: 148 and 100 are
not multiples of 8).  Kept: stride 1, and at least 2 blocks for a stage.
The kernels read the BN-folded weights, computed from the module's own
parameters and buffers (no new parameters) and kept until one of them
changes (a state_dict load copies in place and so bumps their versions).
With a gate open the backbone runs channels_last from its input, so that
``x.permute(0, 2, 3, 1)`` is the NHWC view the kernels read, with no copy.
"""

import os

import torch
import torch.nn.functional as F
from torch import nn

from ...ops import fold_bn, fused_bottleneck, fused_identity_stage
from ..base import cached


def use_fused_bottleneck(x, stride, Cin, Cm, Cout, dilation) -> bool:
    """The ``fused_bottleneck`` kernel for this block:
    YOMITOKU_TPU_FUSED_BOTTLENECK=1, a CUDA tensor, stride 1 (any shape,
    dilation and projection)."""
    return (os.environ.get("YOMITOKU_TPU_FUSED_BOTTLENECK") == "1"
            and x.is_cuda and stride == 1)


def use_fused_stage(x, n_blocks, C, Cm, dilation) -> bool:
    """The ``fused_identity_stage`` kernel for a stage's identity tail:
    YOMITOKU_TPU_FUSED_STAGE=1, a CUDA tensor, at least two blocks."""
    return (os.environ.get("YOMITOKU_TPU_FUSED_STAGE") == "1"
            and x.is_cuda and n_blocks >= 2)


def fused_backbone(x) -> bool:
    """Whether either fused-backbone switch is on for x: the backbone then
    runs channels_last."""
    return x.is_cuda and "1" in (os.environ.get("YOMITOKU_TPU_FUSED_BOTTLENECK"),
                                 os.environ.get("YOMITOKU_TPU_FUSED_STAGE"))


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


def fold_conv_bn(conv_weight, bn):
    """A bias-free convolution followed by FrozenBatchNorm, folded as the
    JAX package folds them: (w (taps, in, out) in f32, with tap kh * 3 + kw
    of the HWIO kernel, each output channel scaled by the BN's mul; the
    f32 BN add)."""
    mul, add = fold_bn(bn.weight.float(), bn.bias.float(),
                       bn.running_mean.float(), bn.running_var.float(), bn.eps)
    w = conv_weight.float()  # (out, in, kh, kw)
    taps = w.permute(2, 3, 1, 0).reshape(-1, w.shape[1], w.shape[0])
    return taps * mul, add


def folded_bottleneck(convs, bns, proj, dtype):
    """The fused_bottleneck arguments of a block from its 1x1 / 3x3 / 1x1
    convolution weights and FrozenBatchNorms, and ``proj`` = (conv weight,
    bn) of a 1x1 projection shortcut or None: (w1, b1, w2, b2, w3, b3, wd,
    bd), weights in ``dtype``, biases f32."""
    (w1, b1), (w2, b2), (w3, b3) = (fold_conv_bn(c, b) for c, b in zip(convs, bns))
    wd = bd = None
    if proj is not None:
        wd, bd = fold_conv_bn(*proj)
        wd = wd[0].to(dtype).contiguous()
    return (w1[0].to(dtype).contiguous(), b1, w2.to(dtype).contiguous(), b2,
            w3[0].to(dtype).contiguous(), b3, wd, bd)


def weight_state(modules):
    """The parameters and buffers the folded weights are made of."""
    return [t for m in modules for t in list(m.parameters()) + list(m.buffers())]


def _conv(cin, cout, kernel, stride=1, dilation=1):
    return nn.Conv2d(cin, cout, kernel, stride,
                     padding=dilation * (kernel - 1) // 2,
                     dilation=dilation, bias=False)


class Bottleneck(nn.Module):
    def __init__(self, inplanes, planes, stride=1, dilation=1, downsample=False):
        super().__init__()
        self.stride, self.dilation, self.planes = stride, dilation, planes
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

    def folded(self, dtype):
        """fused_bottleneck's (w1, b1, w2, b2, w3, b3, wd, bd) of this block."""
        proj = None
        if self.downsample is not None:
            proj = (self.downsample[0].weight, self.downsample[1])
        return cached(self, f"_folded_{dtype}", weight_state([self]),
                      lambda: folded_bottleneck(
                          (self.conv1.weight, self.conv2.weight, self.conv3.weight),
                          (self.bn1, self.bn2, self.bn3), proj, dtype))

    def forward(self, x):
        Cm = self.planes
        if use_fused_bottleneck(x, self.stride, x.shape[1], Cm, 4 * Cm,
                                self.dilation):
            y = fused_bottleneck(x.permute(0, 2, 3, 1), *self.folded(x.dtype),
                                 dilation=self.dilation)
            return y.permute(0, 3, 1, 2)
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(out + x)


def stage_weights(blocks, dtype):
    """fused_identity_stage's stacked (w1s, b1s, w2s, b2s, w3s, b3s) of
    identity ``blocks``, kept on the first block until a weight of any of
    them changes."""
    def build():
        folded = [b.folded(dtype)[:6] for b in blocks]
        return tuple(torch.stack([f[c] for f in folded]) for c in range(6))

    return cached(blocks[0], f"_stage_folded_{dtype}", weight_state(blocks), build)


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
        if fused_backbone(x):
            x = x.contiguous(memory_format=torch.channels_last)
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        feats = {}
        for i in range(1, 5):
            first, *tail = getattr(self, f"layer{i}")
            x = first(x)
            Cm = first.planes
            if tail and use_fused_stage(x, len(tail), 4 * Cm, Cm, tail[0].dilation):
                y = fused_identity_stage(x.permute(0, 2, 3, 1),
                                         *stage_weights(tail, x.dtype),
                                         dilation=tail[0].dilation)
                x = y.permute(0, 3, 1, 2)
            else:
                for block in tail:
                    x = block(x)
            feats[f"layer{i}"] = x
        return feats
