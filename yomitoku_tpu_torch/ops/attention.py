"""Attention kernels of the port (replacing
``yomitoku_tpu/ops/pallas/flash_attention.py``).

* ``fused_attention_heads``: head-packed softmax(q k^T s) v.  One launch
  of the attention kernel (csrc/attention.cu).
* ``fused_attention_block_ln``: the pre-LN self-attention sublayer
  x + Wo.MHA(LN(x)Wq, LN(x)Wk, LN(x)Wv) + bo.  Three launches: the GEMM
  kernel with the LayerNorm prologue writes the packed (B*L, 3D) QKV
  buffer, the attention kernel reads Q, K and V as column slices of it
  and the GEMM kernel adds the out-projection, its bias and the residual.
  ``fused_attention_block_ln_packed`` is the same sublayer with the three
  input projections given as one packed weight, as the models hold them.
  The Pallas kernel did all of it for one batch item in VMEM, with the four
  D x D weights resident; an SM holds neither, so the sublayer is split
  at the two places where a (B*L, D)-sized activation must be complete.

* ``fused_attention``: unmasked softmax(q k^T s) v on (B, H, L, Dh)
  tensors, one launch of the attention kernel on the (B*H, L, Dh) views
  with one head each; in bf16 at a wgmma head dim whose rows TMA cannot
  map (46: 92 bytes), on head-packed (B, L, H*Dh) copies instead.
* ``fused_attention_block``: attn(x Wq + bq, x Wk + bk, x Wv + bv) Wo + bo,
  the LN sublayer's chain without the LayerNorm prologue and without the
  residual: three launches (packed QKV GEMM, attention, out-projection
  GEMM), q, k, v and the attention output rounded to x's dtype.  Neither
  has a model caller, in the JAX package or here.

* ``fused_attention_block_ln_int8``: the same sublayer with W8A8
  projections (the Pallas kernel's semantics, see ops/mlp.py): five
  launches.  The row-quantize kernel with the LayerNorm prologue gives
  the int8 codes of LN(x) in f32 and a scale per row; the int8 GEMM
  (csrc/gemm_int8.cu) writes the packed QKV, dequantized and rounded to
  x's dtype; the attention kernel reads Q, K and V there and writes its
  output in f32; the row-quantize kernel quantizes that f32 output per
  row; the int8 GEMM adds the out-projection, its bias and the residual.
  ``fused_attention_block_ln_int8_packed`` takes the QKV codes packed.

Each function keeps the JAX function's name and argument order, with
weights in the JAX (in, out) layout; int8 weights as the transpose of a
row-major (out, in) tensor (``quantize_weight_int8``).  On CPU tensors it runs its plain
``*_reference`` version; on CUDA tensors it launches the kernels or
raises.  Numerics follow the Pallas kernels: f32 LayerNorm statistics,
f32 logits and accumulation, projections rounded to the input dtype.
"""

import torch

from ._common import (
    WGMMA_HEAD_DIMS,
    attention,
    gemm,
    gemm_int8,
    launches,
    layer_norm,
    on_cpu,
    quantize_rows,
    require_cuda,
    vector,
)
from .mlp import dequantize, int_matmul, quantize_rows_reference


def _attention_f32(q, k, v, num_heads, scale=None):
    """Head-packed attention in f32 (f32 logits, weights rounded to v's
    dtype, f32 accumulation), unrounded output."""
    B, Lq, D = q.shape
    Lk = k.shape[1]
    H = num_heads
    Dh = D // H
    if scale is None:
        scale = Dh ** -0.5
    qh = q.reshape(B, Lq, H, Dh).transpose(1, 2).float()
    kh = k.reshape(B, Lk, H, Dh).transpose(1, 2).float()
    vh = v.reshape(B, Lk, H, Dh).transpose(1, 2)
    logits = torch.matmul(qh, kh.transpose(-1, -2)) * scale
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.matmul(w.float(), vh.float())
    return out.transpose(1, 2).reshape(B, Lq, D)


def fused_attention_heads_reference(q, k, v, num_heads, scale=None):
    """Plain PyTorch version of ``fused_attention_heads``."""
    return _attention_f32(q, k, v, num_heads, scale).to(q.dtype)


def fused_attention_heads(q, k, v, num_heads, scale=None):
    """Attention on head-packed rows: q (B, Lq, H*Dh), k/v (B, Lk, H*Dh)
    -> (B, Lq, H*Dh).  Any Lq and Lk: the kernel masks ragged edges."""
    B, Lq, D = q.shape
    if scale is None:
        scale = (D // num_heads) ** -0.5
    if on_cpu(q, k, v):
        return fused_attention_heads_reference(q, k, v, num_heads, scale)
    require_cuda("fused_attention_heads", q, k, v)
    out = torch.empty((B, Lq, D), dtype=q.dtype, device=q.device)
    attention(q, k, v, out, num_heads, scale)
    launches["fused_attention_heads"] += 1
    return out


def fused_attention_reference(q, k, v, scale=None):
    """Plain PyTorch version of ``fused_attention``."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(w.float(), v.float()).to(q.dtype)


def fused_attention(q, k, v, scale=None):
    """Unmasked scaled-dot attention softmax(q k^T * scale) v: q (B, H, Lq,
    Dh), k/v (B, H, Lk, Dh) -> (B, H, Lq, Dh), f32 logits and accumulation
    whatever the input dtype."""
    B, H, Lq, Dh = q.shape
    Lk = k.shape[2]
    if scale is None:
        scale = Dh ** -0.5
    if on_cpu(q, k, v):
        return fused_attention_reference(q, k, v, scale)
    name = "fused_attention"
    require_cuda(name, q, k, v)
    if k.shape != (B, H, Lk, Dh) or v.shape != k.shape:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if q.dtype == torch.bfloat16 and Dh in WGMMA_HEAD_DIMS and Dh % 8:
        # rows of Dh elements are no TMA rows: the wgmma route on head-packed copies
        packed = lambda t: t.transpose(1, 2).reshape(B, t.shape[2], H * Dh)  # noqa: E731
        out = torch.empty((B, Lq, H * Dh), dtype=q.dtype, device=q.device)
        attention(packed(q), packed(k), packed(v), out, H, scale)
        launches[name] += 1
        return out.view(B, Lq, H, Dh).transpose(1, 2).contiguous()
    out = torch.empty((B, H, Lq, Dh), dtype=q.dtype, device=q.device)
    attention(q.reshape(B * H, Lq, Dh), k.reshape(B * H, Lk, Dh),
              v.reshape(B * H, Lk, Dh), out.view(B * H, Lq, Dh), 1, scale)
    launches[name] += 1
    return out


def fused_attention_block_reference(x, wq, bq, wk, bk, wv, bv, wo, bo,
                                    num_heads, scale=None):
    """Plain PyTorch version of ``fused_attention_block``."""
    dt = x.dtype
    xf = x.float()

    def proj(w, b):
        return (torch.matmul(xf, w.float()) + b.float()).to(dt)

    attn = fused_attention_heads_reference(proj(wq, bq), proj(wk, bk),
                                           proj(wv, bv), num_heads, scale)
    return (torch.matmul(attn.float(), wo.float()) + bo.float()).to(dt)


def fused_attention_block(x, wq, bq, wk, bk, wv, bv, wo, bo, num_heads,
                          scale=None):
    """Self-attention block without LayerNorm or residual: x (B, L, D)
    contiguous -> attn(x Wq + bq, x Wk + bk, x Wv + bv) Wo + bo.  Weights
    (D, D) in the (in, out) layout, each row-major or the transpose of a
    row-major tensor; the three input projections are packed into one
    (D, 3D) weight per call."""
    args = (x, wq, bq, wk, bk, wv, bv, wo, bo)
    if on_cpu(*args):
        return fused_attention_block_reference(*args, num_heads, scale=scale)
    B, L, D = x.shape
    if scale is None:
        scale = (D // num_heads) ** -0.5
    name = "fused_attention_block"
    require_cuda(name, x, wq, wk, wv, wo)
    if not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous")
    dt = x.dtype
    x2 = x.view(B * L, D)
    qkv = torch.empty((B * L, 3 * D), dtype=dt, device=x.device)
    gemm(x2, torch.cat([wq, wk, wv], dim=1),
         vector(torch.cat([bq, bk, bv]), 3 * D, x, name), qkv)
    q3 = qkv.view(B, L, 3 * D)
    attn = torch.empty((B, L, D), dtype=dt, device=x.device)
    attention(q3[..., :D], q3[..., D:2 * D], q3[..., 2 * D:], attn, num_heads,
              scale)
    out = torch.empty_like(x2)
    gemm(attn.view(B * L, D), wo, vector(bo, D, x, name), out)
    launches[name] += 1
    return out.view(B, L, D)


def fused_attention_block_ln_reference(
    x, ln_scale, ln_bias, wq, bq, wk, bk, wv, bv, wo, bo, num_heads,
    scale=None, eps=1e-6,
):
    """Plain PyTorch version of ``fused_attention_block_ln``."""
    dt = x.dtype
    h = layer_norm(x, ln_scale, ln_bias, eps, dt).float()

    def proj(w, b):
        return (torch.matmul(h, w.float()) + b.float()).to(dt)

    q, k, v = proj(wq, bq), proj(wk, bk), proj(wv, bv)
    attn = fused_attention_heads_reference(q, k, v, num_heads, scale)
    out = torch.matmul(attn.float(), wo.float()) + bo.float()
    return (x.float() + out).to(dt)


def fused_attention_block_ln(
    x, ln_scale, ln_bias, wq, bq, wk, bk, wv, bv, wo, bo, num_heads,
    scale=None, eps=1e-6,
):
    """Pre-LN self-attention sublayer x + attn_block(LayerNorm(x)).

    x (B, L, D) contiguous; ln_scale, ln_bias and the biases (D,); the
    four weights (D, D) in the (in, out) layout, each row-major or the
    transpose of a row-major tensor.  The three input projections are
    packed into one (D, 3D) weight per call;
    ``fused_attention_block_ln_packed`` takes them packed already."""
    args = (x, ln_scale, ln_bias, wq, bq, wk, bk, wv, bv, wo, bo)
    if on_cpu(*args):
        return fused_attention_block_ln_reference(
            *args, num_heads, scale=scale, eps=eps
        )
    return fused_attention_block_ln_packed(
        x, ln_scale, ln_bias, torch.cat([wq, wk, wv], dim=1),
        torch.cat([bq, bk, bv]), wo, bo, num_heads, scale=scale, eps=eps,
    )


def fused_attention_block_ln_packed(
    x, ln_scale, ln_bias, w_qkv, b_qkv, wo, bo, num_heads, scale=None,
    eps=1e-6,
):
    """``fused_attention_block_ln`` with the input projections packed:
    w_qkv (D, 3D) = [wq | wk | wv] and b_qkv (3D,).  A torch
    ``in_proj_weight.t()`` (or a timm ``qkv.weight.t()``) and its bias pass
    as they are, so the models hand over their parameters without a copy."""
    B, L, D = x.shape
    if scale is None:
        scale = (D // num_heads) ** -0.5
    args = (x, ln_scale, ln_bias, w_qkv, b_qkv, wo, bo)
    if on_cpu(*args):
        return fused_attention_block_ln_reference(
            x, ln_scale, ln_bias,
            w_qkv[:, :D], b_qkv[:D], w_qkv[:, D:2 * D], b_qkv[D:2 * D],
            w_qkv[:, 2 * D:], b_qkv[2 * D:], wo, bo, num_heads,
            scale=scale, eps=eps,
        )
    name = "fused_attention_block_ln"
    require_cuda(name, x, w_qkv, wo)
    if not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous")
    dt = x.dtype
    x2 = x.view(B * L, D)
    ln = (vector(ln_scale, D, x, name), vector(ln_bias, D, x, name), eps)
    qkv = torch.empty((B * L, 3 * D), dtype=dt, device=x.device)
    gemm(x2, w_qkv, vector(b_qkv, 3 * D, x, name), qkv, ln=ln)
    q3 = qkv.view(B, L, 3 * D)
    attn = torch.empty((B, L, D), dtype=dt, device=x.device)
    attention(
        q3[..., :D], q3[..., D:2 * D], q3[..., 2 * D:], attn, num_heads, scale
    )
    out = torch.empty_like(x2)
    gemm(attn.view(B * L, D), wo, vector(bo, D, x, name), out, res=x2)
    launches[name] += 1
    return out.view(B, L, D)


def fused_attention_block_ln_int8_reference(
    x, ln_scale, ln_bias, wq, sq, bq, wk, sk, bk, wv, sv, bv, wo, so, bo,
    num_heads, scale=None, eps=1e-6, ln_codes=None,
):
    """Plain PyTorch version of ``fused_attention_block_ln_int8``.
    ``ln_codes``: (codes (B*L, D) int8, scales (B*L, 1) f32) of LayerNorm(x)
    to project instead of quantizing it here, such as the row-quantize
    kernel's own, to hold the rest of the block on the same codes."""
    B, L, D = x.shape
    dt = x.dtype
    if ln_codes is None:
        h = layer_norm(x, ln_scale, ln_bias, eps, torch.float32).reshape(B * L, D)
        hq, sh = quantize_rows_reference(h)
    else:
        hq, sh = ln_codes

    def proj(w, s, b):
        return dequantize(int_matmul(hq, w), sh, s, b).to(dt).reshape(B, L, D)

    attn = _attention_f32(proj(wq, sq, bq), proj(wk, sk, bk), proj(wv, sv, bv),
                          num_heads, scale)
    aq, sa = quantize_rows_reference(attn.reshape(B * L, D))
    out = dequantize(int_matmul(aq, wo), sa, so, bo).reshape(B, L, D)
    return (x.float() + out).to(dt)


def fused_attention_block_ln_int8(
    x, ln_scale, ln_bias, wq, sq, bq, wk, sk, bk, wv, sv, bv, wo, so, bo,
    num_heads, scale=None, eps=1e-6,
):
    """Pre-LN self-attention sublayer with int8 projections: x +
    attn_block_int8(LayerNorm(x)).  w* int8 (D, D) with per-output-channel
    scales s* (D,) from ``quantize_weight_int8``; x (B, L, D) contiguous.
    The three input projections are packed into one (D, 3D) code matrix
    per call; ``fused_attention_block_ln_int8_packed`` takes them packed."""
    args = (x, ln_scale, ln_bias, wq, sq, bq, wk, sk, bk, wv, sv, bv, wo, so, bo)
    if on_cpu(*args):
        return fused_attention_block_ln_int8_reference(
            *args, num_heads, scale=scale, eps=eps)
    # packed along the output axis of the (N, K) rows: the transpose of a
    # row-major (3D, D), the layout the int8 GEMM reads
    w_qkv = torch.cat([wq.t(), wk.t(), wv.t()]).t()
    return fused_attention_block_ln_int8_packed(
        x, ln_scale, ln_bias, w_qkv, torch.cat([sq, sk, sv]),
        torch.cat([bq, bk, bv]), wo, so, bo, num_heads, scale=scale, eps=eps)


def fused_attention_block_ln_int8_packed(
    x, ln_scale, ln_bias, w_qkv, s_qkv, b_qkv, wo, so, bo, num_heads,
    scale=None, eps=1e-6,
):
    """``fused_attention_block_ln_int8`` with the input projections packed:
    w_qkv (D, 3D) int8 = [wq | wk | wv], s_qkv and b_qkv (3D,)."""
    B, L, D = x.shape
    if scale is None:
        scale = (D // num_heads) ** -0.5
    args = (x, ln_scale, ln_bias, w_qkv, s_qkv, b_qkv, wo, so, bo)
    if on_cpu(*args):
        return fused_attention_block_ln_int8_reference(
            x, ln_scale, ln_bias,
            w_qkv[:, :D], s_qkv[:D], b_qkv[:D],
            w_qkv[:, D:2 * D], s_qkv[D:2 * D], b_qkv[D:2 * D],
            w_qkv[:, 2 * D:], s_qkv[2 * D:], b_qkv[2 * D:],
            wo, so, bo, num_heads, scale=scale, eps=eps,
        )
    name = "fused_attention_block_ln_int8"
    require_cuda(name, x)
    if not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous")
    if w_qkv.shape != (D, 3 * D) or wo.shape != (D, D):
        raise ValueError(f"{name}: w_qkv {tuple(w_qkv.shape)}, wo {tuple(wo.shape)}")
    dev, f32 = x.device, torch.float32
    # the GEMM reads W as rows of (out, in): a copy only for other layouts
    w_qkv, wo = w_qkv.t().contiguous().t(), wo.t().contiguous().t()
    x2 = x.view(B * L, D)
    xq = torch.empty((B * L, D), dtype=torch.int8, device=dev)
    sx = torch.empty((B * L, 1), dtype=f32, device=dev)
    quantize_rows(x2, xq, sx, ln=(vector(ln_scale, D, x, name, f32),
                                  vector(ln_bias, D, x, name, f32), eps))
    qkv = torch.empty((B * L, 3 * D), dtype=x.dtype, device=dev)
    gemm_int8(xq, sx, w_qkv, vector(s_qkv, 3 * D, x, name, f32),
              vector(b_qkv, 3 * D, x, name, f32), qkv)
    q3 = qkv.view(B, L, 3 * D)
    attn = torch.empty((B, L, D), dtype=f32, device=dev)
    attention(q3[..., :D], q3[..., D:2 * D], q3[..., 2 * D:], attn, num_heads, scale)
    aq = torch.empty((B * L, D), dtype=torch.int8, device=dev)
    sa = torch.empty((B * L, 1), dtype=f32, device=dev)
    quantize_rows(attn.view(B * L, D), aq, sa)
    out = torch.empty_like(x2)
    gemm_int8(aq, sa, wo, vector(so, D, x, name, f32), vector(bo, D, x, name, f32),
              out, res=x2)
    launches[name] += 1
    return out.view(B, L, D)
