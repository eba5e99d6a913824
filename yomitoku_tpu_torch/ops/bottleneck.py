"""Fused stride-1 ResNet bottleneck block (replacing
``yomitoku_tpu/ops/pallas/bottleneck.py``).

One block, BatchNorm folded into the weights by the caller (``fold_bn``):
1x1 reduce -> relu -> 3x3 at dilation d -> relu -> 1x1 expand, plus the
shortcut (x, or a 1x1 projection x . wd + bd), then relu.  NHWC
activations, the JAX package's argument layout: w1 (Cin, Cm), w2 (9, Cm,
Cm) with tap 3t + u, w3 (Cm, Cout), wd (Cin, Cout), f32 biases.  The 3x3's
zero padding applies to h1 (the post-1x1 activation), not to x.

On CUDA tensors: three launches of the implicit-GEMM kernel of
csrc/bottleneck.cu (see there for the design), h1 and h2 making one round
trip through device memory each, each convolution on the route
``ops._common.conv_plan`` picks for its shape and the card (bf16: TMA +
wgmma, with 64-pixel units or split K steps where the grid is small; f32:
FMAs); any H, W and dilation, no strip-height or VMEM condition, and no
fallback: a shape the kernel cannot take raises.  On CPU tensors: the
plain version.  Rounding follows the Pallas kernel: f32 products and
sums, h1 and h2 rounded to x's dtype, the f32 output relu(h2 . w3 + b3 +
res) rounded last (res = x upcast, or the unrounded f32 projection).
"""

import torch
import torch.nn.functional as F

from ._build import library
from ._common import (
    _code,
    _launch,
    _ptr,
    _sm_count,
    block_plans,
    conv_legal,
    conv_route_launches,
    conv_workspace,
    launches,
    on_cpu,
    require_cuda,
    vector,
)


def fold_bn(scale, bias, mean, var, eps=1e-5):
    """FrozenBatchNorm -> (mul, add) channel constants, in the JAX
    package's formula: mul = scale / sqrt(var + eps), add = bias - mean *
    mul."""
    mul = scale / torch.sqrt(var + eps)
    return mul, bias - mean * mul


def conv_reference(x, w, bias, dilation=1, x2=None, w2=None, bias2=None, res=None):
    """Plain PyTorch version of one convolution of the kernel: relu(conv(x,
    w) + bias [+ x2 . w2 + bias2] [+ res]) in f32 on x's values, rounded
    to x's dtype.  x (B, H, W, K); w (K, N) for a 1x1, or (9, K, N) with
    tap 3t + u for the 3x3 at ``dilation`` over zero-padded x; x2 (B, H,
    W, K2) with w2 (K2, N); res (B, H, W, N); f32 biases."""
    xf = x.float()
    if w.dim() == 2:
        acc = torch.matmul(xf, w.float())
    else:
        d = dilation
        H, W = x.shape[1:3]
        xp = F.pad(xf, (0, 0, d, d, d, d))  # zero rows / columns of x
        acc = 0.0
        for t in range(3):
            for u in range(3):
                tap = xp[:, t * d:t * d + H, u * d:u * d + W]
                acc = acc + torch.matmul(tap, w[3 * t + u].float())
    y = acc + bias.float()
    if x2 is not None:
        y = y + (torch.matmul(x2.float(), w2.float()) + bias2.float())
    if res is not None:
        y = y + res.float()
    return torch.relu(y).to(x.dtype)


def bottleneck_reference(x, w1, b1, w2, b2, w3, b3, wd=None, bd=None,
                         dilation=1):
    """Plain PyTorch version of ``fused_bottleneck``: x (B, H, W, Cin) ->
    (B, H, W, Cout) in x's dtype; the 3x3 pads h1 with zeros."""
    h1 = conv_reference(x, w1, b1)
    h2 = conv_reference(h1, w2, b2, dilation=dilation)
    if wd is None:
        return conv_reference(h2, w3, b3, res=x)
    return conv_reference(h2, w3, b3, x2=x, w2=wd, bias2=bd)


def nhwc_input(name, x):
    """Raise unless x is a (B, H, W, C) tensor whose memory is NHWC
    contiguous (the ``permute(0, 2, 3, 1)`` view of a channels_last NCHW
    tensor): the kernels read pixel rows in place and never copy."""
    if x.dim() != 4:
        raise ValueError(f"{name}: x must be (B, H, W, C), got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(
            f"{name}: x {tuple(x.shape)} with strides {x.stride()} is not NHWC "
            "contiguous; run the backbone in torch.channels_last")


def weight(w, shape, x, name):
    """A folded weight of ``shape`` in x's dtype, contiguous, on x's device."""
    if tuple(w.shape) != tuple(shape):
        raise ValueError(f"{name}: weight {tuple(w.shape)}, expected {tuple(shape)}")
    if w.device != x.device:
        raise ValueError(f"{name}: weight on {w.device}, x on {x.device}")
    return w.to(x.dtype).contiguous()


def count_conv_routes(plans, blocks=1):
    """Add a launch per convolution of ``blocks`` blocks run by ``plans``
    to ``conv_route_launches``."""
    for plan in plans:
        conv_route_launches[plan[0]] += blocks


def fused_bottleneck(x, w1, b1, w2, b2, w3, b3, wd=None, bd=None, dilation=1):
    """One stride-1 bottleneck block: x (B, H, W, Cin) -> (B, H, W, Cout)."""
    args = [x, w1, b1, w2, b2, w3, b3] + ([] if wd is None else [wd, bd])
    if on_cpu(*args):
        return bottleneck_reference(x, w1, b1, w2, b2, w3, b3, wd, bd,
                                    dilation=dilation)
    name = "fused_bottleneck"
    require_cuda(name, x)
    nhwc_input(name, x)
    B, H, W, Cin = x.shape
    Cm, Cout = w1.shape[-1], w3.shape[-1]
    if wd is None and Cin != Cout:
        raise ValueError(f"{name}: identity shortcut with Cin {Cin} != Cout {Cout}")
    if dilation < 1:
        raise ValueError(f"{name}: dilation {dilation}")
    f32 = torch.float32
    w1 = weight(w1, (Cin, Cm), x, name)
    w2 = weight(w2, (9, Cm, Cm), x, name)
    w3 = weight(w3, (Cm, Cout), x, name)
    b1, b2, b3 = (vector(b1, Cm, x, name, f32), vector(b2, Cm, x, name, f32),
                  vector(b3, Cout, x, name, f32))
    if wd is not None:
        wd, bd = weight(wd, (Cin, Cout), x, name), vector(bd, Cout, x, name, f32)
    out = torch.empty((B, H, W, Cout), dtype=x.dtype, device=x.device)
    scratch = torch.empty((2, B * H * W, Cm), dtype=x.dtype, device=x.device)
    legal = conv_legal([x, w1, w2, w3, wd], (Cin, Cm, Cout))
    plans, plan_arg, ws = block_plans(x.dtype, B, H, W, Cin, Cm, Cout, wd is not None,
                                      legal, _sm_count(x.device.index))
    ws = conv_workspace(ws, x.device)
    lib = library()
    rc = _launch(
        x.device, lib.lib.yt_bottleneck,
        _code(x), x.data_ptr(), B, H, W, Cin, Cm, Cout, int(dilation),
        w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        w3.data_ptr(), b3.data_ptr(), _ptr(wd), _ptr(bd),
        scratch[0].data_ptr(), scratch[1].data_ptr(), out.data_ptr(), plan_arg, _ptr(ws),
    )
    lib.check(rc, "yt_bottleneck launch")
    launches[name] += 1
    count_conv_routes(plans)
    return out
