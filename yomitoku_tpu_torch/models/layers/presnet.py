"""PResNet backbone (ResNet-50, variant d) of RT-DETRv2, inference form
(counterpart of yomitoku_tpu/models/layers/presnet.py).

Stem of three 3x3 convolutions and a 3x3/2 max-pool, bottleneck stages
whose stride-2 shortcuts average-pool 2x2 (ceil mode) before a 1x1
convolution (variant d), frozen BatchNorm.  Parameter names follow the
reference ``state_dict`` (rtdetr_backbone.py): ``conv1.conv1_1`` ..,
``res_layers.<s>.blocks.<b>.branch2a`` .., ``short`` on stage 0 and
``short.conv`` on the stride-2 shortcuts.  The convolutions are library
convolutions, as XLA ran them in the JAX package.

With YOMITOKU_TPU_FUSED_BOTTLENECK=1 on CUDA tensors (``resnet.
use_fused_bottleneck``) each stride-1 relu block runs on the
``fused_bottleneck`` kernel, stage 0's first block with its 1x1
projection shortcut included: 13 of the 16 blocks; the three stride-2
blocks keep their library convolutions, as they keep XLA in the JAX
package.  The backbone then runs channels_last from its input.
"""

import torch
import torch.nn.functional as F
from torch import nn

from ...ops import fused_bottleneck
from ..base import cached
from . import resnet
from .resnet import FrozenBatchNorm

ACTS = {
    None: lambda x: x,
    "relu": F.relu,
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="none"),  # exact erf, as torch's
}


class ConvNorm(nn.Module):
    """Convolution (no bias) + frozen BN + activation (reference
    ConvNormLayer)."""

    def __init__(self, cin, cout, kernel, stride=1, act=None):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride, (kernel - 1) // 2,
                              bias=False)
        self.norm = FrozenBatchNorm(cout)
        self.act = act

    def forward(self, x):
        return ACTS[self.act](self.norm(self.conv(x)))


def _avg_pool_2x2_ceil(x):
    """torch AvgPool2d(2, 2, 0, ceil_mode=True): a window clipped at an odd
    edge divides by the elements it covers."""
    return F.avg_pool2d(x, 2, 2, 0, ceil_mode=True, count_include_pad=True)


class _Shortcut(nn.Module):
    """Variant-d stride-2 shortcut: pool, then ``conv`` (a ConvNorm)."""

    def __init__(self, cin, cout):
        super().__init__()
        self.conv = ConvNorm(cin, cout, 1)

    def forward(self, x):
        return self.conv(_avg_pool_2x2_ceil(x))


class PBottleneck(nn.Module):
    def __init__(self, cin, ch_out, stride, shortcut, act="relu"):
        super().__init__()
        w = ch_out
        self.branch2a = ConvNorm(cin, w, 1, 1, act)
        self.branch2b = ConvNorm(w, w, 3, stride, act)
        self.branch2c = ConvNorm(w, w * 4, 1, 1, None)
        self.act, self.stride, self.ch_out = act, stride, ch_out
        if not shortcut:
            self.short = (_Shortcut(cin, w * 4) if stride == 2
                          else ConvNorm(cin, w * 4, 1, stride))

    def folded(self, dtype):
        """fused_bottleneck's (w1, b1, w2, b2, w3, b3, wd, bd) of this
        stride-1 block (wd, bd: the 1x1 projection, where it has one)."""
        branches = (self.branch2a, self.branch2b, self.branch2c)
        short = getattr(self, "short", None)
        proj = None if short is None else (short.conv.weight, short.norm)
        return cached(
            self, f"_folded_{dtype}", resnet.weight_state([self]),
            lambda: resnet.folded_bottleneck(
                [b.conv.weight for b in branches], [b.norm for b in branches],
                proj, dtype))

    def forward(self, x):
        w = self.ch_out
        if self.act == "relu" and resnet.use_fused_bottleneck(
                x, self.stride, x.shape[1], w, w * 4, 1):
            y = fused_bottleneck(x.permute(0, 2, 3, 1), *self.folded(x.dtype))
            return y.permute(0, 3, 1, 2)
        out = self.branch2c(self.branch2b(self.branch2a(x)))
        short = self.short(x) if hasattr(self, "short") else x
        return ACTS[self.act](out + short)


class _Blocks(nn.Module):
    def __init__(self, blocks):
        super().__init__()
        self.blocks = nn.Sequential(*blocks)

    def forward(self, x):
        return self.blocks(x)


class PResNet(nn.Module):
    """ResNet-50-d features at the stages in ``return_idx`` (NCHW)."""

    def __init__(self, depth=50, variant="d", return_idx=(1, 2, 3),
                 num_stages=4, act="relu"):
        super().__init__()
        if depth != 50 or variant != "d":
            raise ValueError(f"only PResNet-50 variant d (got {depth}{variant})")
        self.return_idx = tuple(return_idx)
        self.conv1 = nn.Sequential()
        for name, cin, cout, stride in (("conv1_1", 3, 32, 2),
                                        ("conv1_2", 32, 32, 1),
                                        ("conv1_3", 32, 64, 1)):
            self.conv1.add_module(name, ConvNorm(cin, cout, 3, stride, act))
        layers, cin, ch_out = [], 64, 64
        for si, n in enumerate((3, 4, 6, 3)[:num_stages]):
            blocks = []
            for bi in range(n):
                blocks.append(PBottleneck(
                    cin, ch_out, stride=2 if bi == 0 and si != 0 else 1,
                    shortcut=bi != 0, act=act,
                ))
                cin = ch_out * 4
            layers.append(_Blocks(blocks))
            ch_out *= 2
        self.res_layers = nn.ModuleList(layers)

    def forward(self, x):  # (B, 3, H, W)
        if resnet.fused_backbone(x):
            x = x.contiguous(memory_format=torch.channels_last)
        x = F.max_pool2d(self.conv1(x), 3, 2, 1)
        outs = []
        for si, layer in enumerate(self.res_layers):
            x = layer(x)
            if si in self.return_idx:
                outs.append(x)
        return outs
