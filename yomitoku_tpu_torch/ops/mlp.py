"""Transformer-MLP kernels of the port (replacing
``yomitoku_tpu/ops/pallas/fused_mlp.py``).

* ``fused_mlp``: fc2(gelu_erf(fc1(x))).
* ``fused_mlp_ln``: the pre-LN sublayer x + fc2(gelu_erf(fc1(LN(x)))).

Each is two launches of the GEMM kernel (csrc/gemm.cu): fc1 with the
exact-erf GELU in its epilogue (and the LayerNorm in its prologue for
``fused_mlp_ln``), then fc2 with its bias (and the residual) in the
epilogue.  The Pallas kernels kept the hidden activation in VMEM, chunked
over the hidden axis with an f32 accumulator; here it makes one round trip
through device memory in the input dtype, where the Pallas kernels also
rounded it before fc2.  GELU is erff, where the Pallas kernels use the
A&S 7.1.26 rational erf (|err| <= 1.5e-7): equal at f32 tolerance, not
bitwise.

Weights are in the JAX (in, out) layout.  On CPU tensors each function
runs its plain ``*_reference`` version; on CUDA tensors it launches the
kernels or raises.
"""

import torch
import torch.nn.functional as F

from ._common import gemm, launches, layer_norm, on_cpu, require_cuda, vector


def _mlp_reference(xn, w1, b1, w2, b2, dt):
    h = torch.matmul(xn.float(), w1.float()) + b1.float()
    g = F.gelu(h, approximate="none").to(dt)
    return torch.matmul(g.float(), w2.float()) + b2.float()


def fused_mlp_reference(x, w1, b1, w2, b2):
    """Plain PyTorch version of ``fused_mlp``."""
    return _mlp_reference(x, w1, b1, w2, b2, x.dtype).to(x.dtype)


def fused_mlp_ln_reference(x, ln_scale, ln_bias, w1, b1, w2, b2, eps=1e-6):
    """Plain PyTorch version of ``fused_mlp_ln``."""
    xn = layer_norm(x, ln_scale, ln_bias, eps, x.dtype)
    out = _mlp_reference(xn, w1, b1, w2, b2, x.dtype)
    return (x.float() + out).to(x.dtype)


def _launch_mlp(name, x, w1, b1, w2, b2, ln=None):
    """``ln`` = (scale, bias, eps) adds the LayerNorm prologue and the
    residual."""
    require_cuda(name, x, w1, w2)
    N, D = x.shape
    Hd, Do = w1.shape[1], w2.shape[1]
    if w1.shape[0] != D or w2.shape[0] != Hd:
        raise ValueError(f"{name}: w1 {tuple(w1.shape)}, w2 {tuple(w2.shape)}")
    if ln is not None:
        if Do != D:
            raise ValueError(f"{name}: residual needs out dim {Do} == {D}")
        ln = (vector(ln[0], D, x, name), vector(ln[1], D, x, name), ln[2])
    h = torch.empty((N, Hd), dtype=x.dtype, device=x.device)
    gemm(x, w1, vector(b1, Hd, x, name), h, ln=ln, gelu=True)
    out = torch.empty((N, Do), dtype=x.dtype, device=x.device)
    gemm(h, w2, vector(b2, Do, x, name), out,
         res=x if ln is not None else None)
    launches[name] += 1
    return out


def fused_mlp(x, w1, b1, w2, b2):
    """x (N, D); w1 (D, H); w2 (H, Do) -> (N, Do)."""
    if on_cpu(x, w1, b1, w2, b2):
        return fused_mlp_reference(x, w1, b1, w2, b2)
    return _launch_mlp("fused_mlp", x, w1, b1, w2, b2)


def fused_mlp_ln(x, ln_scale, ln_bias, w1, b1, w2, b2, eps=1e-6):
    """x (N, D); ln_scale/ln_bias (D,); w1 (D, H); w2 (H, D) -> (N, D)."""
    if on_cpu(x, ln_scale, ln_bias, w1, b1, w2, b2):
        return fused_mlp_ln_reference(
            x, ln_scale, ln_bias, w1, b1, w2, b2, eps=eps
        )
    return _launch_mlp("fused_mlp_ln", x, w1, b1, w2, b2,
                       ln=(ln_scale, ln_bias, eps))
