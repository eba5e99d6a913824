"""The arithmetic every reference matmul and convolution runs in."""

import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # the largest finite float8_e4m3fn


def no_tf32():
    """float32 products in float32: TF32 off for matmuls and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp8_round(x, dims):
    """x rounded to float8 e4m3 with one scale per slice over ``dims``
    (amax mapped to the format's largest value), back in float32."""
    amax = x.abs().amax(dim=dims, keepdim=True).clamp_min(1e-12)
    scale = amax / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class Precision:
    """``fp8=False``: float32 products (the reference).  ``fp8=True``: the
    inputs of every product rounded to float8 e4m3 first, activations per
    row (per tensor for a convolution's input), weights per output
    channel, accumulation in float32 (the control)."""

    def __init__(self, fp8=False):
        self.fp8 = fp8

    def act(self, x):
        return fp8_round(x, (-1,)) if self.fp8 else x

    def weight(self, w):
        return fp8_round(w, tuple(range(1, w.dim()))) if self.fp8 else w

    def linear(self, x, w, b=None):
        return F.linear(self.act(x), self.weight(w), b)

    def matmul(self, a, b):
        """a @ b for activations on both sides (attention)."""
        if self.fp8:
            a, b = fp8_round(a, (-1,)), fp8_round(b, (-2,))
        return a @ b

    def conv2d(self, x, w, b=None, stride=1, padding=0, dilation=1):
        if self.fp8:
            x = fp8_round(x, tuple(range(x.dim())))
        return F.conv2d(x, self.weight(w), b, stride, padding, dilation)

    def conv_transpose2d(self, x, w, b=None, stride=1):
        if self.fp8:
            x = fp8_round(x, tuple(range(x.dim())))
            # (in, out, kh, kw): one scale per output channel
            w = fp8_round(w.transpose(0, 1), (1, 2, 3)).transpose(0, 1)
        return F.conv_transpose2d(x, w, b, stride)
