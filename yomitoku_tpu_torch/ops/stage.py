"""The stride-1 tail of a ResNet stage: N identity bottleneck blocks in a
row (replacing ``yomitoku_tpu/ops/pallas/stage.py``).

Per block, BatchNorm folded by the caller: h = relu(x . w1 + b1);
h = relu(conv3x3_d(h) + b2) with h zero-padded; x = relu(h . w3 + b3 + x).
Weights stacked over the blocks: w1s (N, C, Cm), w2s (N, 9, Cm, Cm) with
tap 3t + u, w3s (N, Cm, C), f32 biases b1s (N, Cm), b2s (N, Cm), b3s (N, C).

The Pallas kernel DMA'd a row strip with an N*d-row halo once and kept the
stage's activations in VMEM across all N blocks.  That does not carry over
to the H100: an SM has 227 KB of shared memory and the card 50 MB of L2,
while one DBNet layer1 activation is 400 x 296 x 256 x 2 B = 60.6 MB per
image.  So on CUDA tensors one C call (``yt_identity_stage``,
csrc/bottleneck.cu) runs the N blocks one after the other, three launches
each, between two ping-pong activation buffers, with one h1 / h2 scratch
allocated once per call: one Python call per stage, and every block's
output makes one round trip through device memory.  Each convolution runs
on the route ``ops._common.conv_plan`` picks (the same for every block of
the stage).  A persistent multi-block kernel is later work.  On CPU tensors: the plain version, N
``bottleneck_reference`` blocks, each output rounded to x's dtype as the
Pallas kernel rounds it.
"""

import torch

from ._build import library
from ._common import (
    _code,
    _launch,
    _ptr,
    _sm_count,
    block_plans,
    conv_legal,
    conv_workspace,
    launches,
    on_cpu,
    require_cuda,
)
from .bottleneck import bottleneck_reference, count_conv_routes, nhwc_input, weight


def fused_identity_stage_reference(x, w1s, b1s, w2s, b2s, w3s, b3s,
                                   dilation=1):
    """Plain PyTorch version of ``fused_identity_stage``."""
    for j in range(w1s.shape[0]):
        x = bottleneck_reference(x, w1s[j], b1s[j], w2s[j], b2s[j], w3s[j],
                                 b3s[j], dilation=dilation)
    return x


def fused_identity_stage(x, w1s, b1s, w2s, b2s, w3s, b3s, dilation=1):
    """N stride-1 identity bottlenecks: x (B, H, W, C) -> (B, H, W, C)."""
    args = (x, w1s, b1s, w2s, b2s, w3s, b3s)
    if on_cpu(*args):
        return fused_identity_stage_reference(*args, dilation=dilation)
    name = "fused_identity_stage"
    require_cuda(name, x)
    nhwc_input(name, x)
    B, H, W, C = x.shape
    N, _, Cm = w1s.shape
    if N < 1 or dilation < 1:
        raise ValueError(f"{name}: {N} blocks at dilation {dilation}")
    f32 = torch.float32
    w1s = weight(w1s, (N, C, Cm), x, name)
    w2s = weight(w2s, (N, 9, Cm, Cm), x, name)
    w3s = weight(w3s, (N, Cm, C), x, name)
    biases = []
    for b, n in ((b1s, Cm), (b2s, Cm), (b3s, C)):
        if tuple(b.shape) != (N, n) or b.device != x.device:
            raise ValueError(f"{name}: bias {tuple(b.shape)} on {b.device}, "
                             f"expected ({N}, {n}) on {x.device}")
        biases.append(b.to(f32).contiguous())
    b1s, b2s, b3s = biases
    out = torch.empty_like(x)
    tmp = torch.empty_like(x) if N > 1 else None
    scratch = torch.empty((2, B * H * W, Cm), dtype=x.dtype, device=x.device)
    legal = conv_legal([x, w1s, w2s, w3s], (C, Cm))
    plans, plan_arg, ws = block_plans(x.dtype, B, H, W, C, Cm, C, False, legal,
                                      _sm_count(x.device.index))
    ws = conv_workspace(ws, x.device)
    lib = library()
    rc = _launch(
        x.device, lib.lib.yt_identity_stage,
        _code(x), x.data_ptr(), B, H, W, C, Cm, N, int(dilation),
        w1s.data_ptr(), b1s.data_ptr(), w2s.data_ptr(), b2s.data_ptr(),
        w3s.data_ptr(), b3s.data_ptr(), scratch[0].data_ptr(),
        scratch[1].data_ptr(), _ptr(tmp), out.data_ptr(), plan_arg, _ptr(ws),
    )
    lib.check(rc, "yt_identity_stage launch")
    launches[name] += 1
    count_conv_routes(plans, N)
    return out
