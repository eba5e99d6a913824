"""Multi-head attention, MLP and LayerNorm (counterpart of
yomitoku_tpu/models/layers/attention.py).

Shapes are batch-first; masks are boolean with True meaning MASKED (the
torch ``attn_mask`` convention).  ``MultiHeadAttention`` exposes the split
``project_q`` / ``project_kv`` / ``attend`` API so the PARSeq decode loop
can project loop-invariant K/V once.

Kernel gates.  The port calls its CUDA kernels where the JAX package calls
its Pallas kernels, on the same conditions, except:
  * "CUDA tensor" replaces "TPU backend";
  * dropped, because they existed only for Mosaic or for VMEM capacity and
    the CUDA kernels tile and mask ragged edges: L % 8 and Lk % 8, the
    L, Lk <= 1024 and D <= 1024 bounds, and the MLP's rows % 8 and
    hidden % 128;
  * kept: unmasked attention, head dim <= 128 (the attention kernel's
    limit), at least 16 query rows and at least 1024 MLP rows (below those
    the AR decode step's tiny products run as plain PyTorch, as they run as
    plain XLA in the JAX package).
The JAX package's environment switches that turn the kernels off
(YOMITOKU_TPU_NO_FLASH, YOMITOKU_TPU_NO_FUSED_MLP) are not ported.

The W8A8 encoder sublayers (``use_int8_encoder``) take the place of the
pre-LN fused kernels where the JAX package's do: opt-in with
YOMITOKU_TPU_INT8_ENCODER=1, on CUDA tensors.  Their int8 weights are
quantized once and kept until the float weights change (a state_dict load
copies into the parameters and so bumps their version), where the JAX
package quantizes inside every forward; both quantize the same
parameters.  ``quantize_kv_int8`` and ``MultiHeadAttention.attend_int8``
are the int8 memory-K/V cache of the PARSeq AR loop, plain torch ops as
they are XLA ops in the JAX package.
"""

import os
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...ops import (
    fused_attention_block_ln_int8_packed,
    fused_attention_block_ln_packed,
    fused_attention_heads,
    fused_mlp,
    fused_mlp_ln,
    fused_mlp_ln_int8,
    layer_norm,
    quantize_weight_int8,
)
from ..base import cached

__all__ = [
    "LayerNorm",
    "MultiHeadAttention",
    "ViTAttention",
    "Mlp",
    "layer_norm",
    "mlp_forward",
    "quantize_kv_int8",
    "scaled_dot_attention",
    "use_int8_encoder",
]


class LayerNorm(nn.LayerNorm):
    """nn.LayerNorm's parameters with the JAX package's arithmetic (f32
    one-pass statistics, clamped variance; flax's fast variance)."""

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias, self.eps, x.dtype)


def _use_fused_block(x, num_heads) -> bool:
    L, D = x.shape[-2], x.shape[-1]
    return x.is_cuda and D // num_heads <= 128 and L >= 16


def _use_fused_packed(query, key, num_heads) -> bool:
    Lq, D = query.shape[-2], query.shape[-1]
    return query.is_cuda and D // num_heads <= 128 and Lq >= 16


def _use_fused_mlp(x) -> bool:
    return x.is_cuda and x[..., 0].numel() >= 1024


def use_int8_encoder(x) -> bool:
    """W8A8 encoder sublayer kernels: opt-in with
    YOMITOKU_TPU_INT8_ENCODER=1, on CUDA tensors (where the JAX package asks
    for its TPU backend).  Read at every call, as the JAX package reads it
    at every trace."""
    return os.environ.get("YOMITOKU_TPU_INT8_ENCODER") == "1" and x.is_cuda


def _int8_weights(owner, *weights):
    """``quantize_weight_int8`` of each torch-layout (out, in) weight's
    ``.t()``, kept on ``owner`` until a weight changes."""
    return cached(owner, "_int8_weights", weights,
                  lambda: [quantize_weight_int8(w.t()) for w in weights])


def quantize_kv_int8(k, v, per_row=False):
    """Symmetric int8 quantization of a K/V pair ((B, H, L, Dh) each) with
    one float32 scale per (batch, head), shape (B, H, 1, 1):
    s = max(max|x| / 127, 1e-8), q = clip(round(x / s), -127, 127) ->
    (kq, sk, vq, sv), as the JAX package's default (per-head) form.  With
    ``per_row`` one scale per row, shape (B, H, L), as the JAX package's
    form for a cache built a row at a time."""

    def q8(x):
        xf = x.float()
        dims = (-1,) if per_row else (2, 3)
        s = torch.clamp_min(xf.abs().amax(dim=dims, keepdim=True) / 127.0, 1e-8)
        q = torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8)
        return q, (s[..., 0] if per_row else s)

    kq, sk = q8(k)
    vq, sv = q8(v)
    return kq, sk, vq, sv


def scaled_dot_attention(q, k, v, mask=None, dtype=torch.float32):
    """q (B, H, Lq, Dh), k/v (B, H, Lk, Dh); mask True = masked out.
    f32 logits and accumulation; softmax weights rounded to ``dtype``."""
    scale = q.shape[-1] ** -0.5
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if mask is not None:
        logits = logits.masked_fill(mask, torch.finfo(torch.float32).min)
    weights = torch.softmax(logits, dim=-1).to(dtype)
    return torch.matmul(weights.float(), v.float())


class MultiHeadAttention(nn.Module):
    """Separate-source MHA with torch ``nn.MultiheadAttention``'s parameter
    layout (packed ``in_proj_weight`` (3D, D), ``out_proj``)."""

    def __init__(self, embed_dim: int, num_heads: int):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim, embed_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim))
        self.out_proj = nn.Linear(embed_dim, embed_dim)

    def in_proj(self):
        """Packed (3D, D) weight and (3D,) bias, torch layout."""
        return self.in_proj_weight, self.in_proj_bias

    def out_params(self):
        return self.out_proj.weight, self.out_proj.bias

    def _dense(self, x, i):
        """Projection i (0 q, 1 k, 2 v) of the packed weight."""
        w, b = self.in_proj()
        D = self.embed_dim
        return F.linear(x, w[i * D:(i + 1) * D], b[i * D:(i + 1) * D])

    def _split(self, x):
        B, L, D = x.shape
        H = self.num_heads
        return x.reshape(B, L, H, D // H).transpose(1, 2)

    # -- split API (for cached AR decoding) ------------------------------

    def project_q(self, query):
        """(B, Lq, D) -> (B, H, Lq, Dh)."""
        return self._split(self._dense(query, 0))

    def project_kv(self, key, value):
        """(B, Lk, D) x2 -> ((B, H, Lk, Dh), (B, H, Lk, Dh))."""
        return self._split(self._dense(key, 1)), self._split(self._dense(value, 2))

    def attend(self, q, k, v, mask: Optional[torch.Tensor] = None):
        """Heads-split inputs; mask broadcastable to (B, H, Lq, Lk)."""
        out = scaled_dot_attention(q, k, v, mask, dtype=q.dtype)
        B, H, Lq, Dh = out.shape
        out = out.transpose(1, 2).reshape(B, Lq, H * Dh).to(q.dtype)
        return F.linear(out, *self.out_params())

    def attend_int8(self, q, kq, sk, vq, sv, mask: Optional[torch.Tensor] = None):
        """Attend against an int8 K/V cache (``quantize_kv_int8``): the
        per-(batch, head) scales fold into the query before QK^T and into
        the output after PV; logits and accumulation in f32, the scaled
        query and the softmax weights rounded to the compute dtype."""
        dt = q.dtype
        scale = q.shape[-1] ** -0.5
        qs = (q.float() * (sk * scale)).to(dt)
        logits = torch.matmul(qs.float(), kq.float().transpose(-1, -2))
        if mask is not None:
            logits = logits.masked_fill(mask, torch.finfo(torch.float32).min)
        weights = torch.softmax(logits, dim=-1).to(dt)
        out = torch.matmul(weights.float(), vq.float()) * sv
        B, H, Lq, Dh = out.shape
        out = out.transpose(1, 2).reshape(B, Lq, H * Dh).to(dt)
        return F.linear(out, *self.out_params())

    # -- fused entry ------------------------------------------------------

    def forward(self, query, key, value, attn_mask=None, key_padding_mask=None,
                pre_ln: Optional[tuple] = None):
        unmasked = attn_mask is None and key_padding_mask is None
        if pre_ln is not None:
            # Pre-LN sublayer contract: return x + attn(LayerNorm(x)).
            g, b, eps = pre_ln
            if (unmasked and query is key and key is value
                    and _use_fused_block(query, self.num_heads)):
                w, bias = self.in_proj()
                wo, bo = self.out_params()
                if use_int8_encoder(query):
                    (wq8, sq8), (wo8, so8) = _int8_weights(self, w, wo)
                    return fused_attention_block_ln_int8_packed(
                        query, g, b, wq8, sq8, bias, wo8, so8, bo,
                        self.num_heads, eps=eps,
                    )
                return fused_attention_block_ln_packed(
                    query, g, b, w.t(), bias, wo.t(), bo, self.num_heads,
                    eps=eps,
                )
            h = layer_norm(query, g, b, eps, query.dtype)
            k2 = h if key is query else key
            v2 = h if value is query else value
            return query + self(h, k2, v2, attn_mask, key_padding_mask)

        if unmasked and _use_fused_packed(query, key, self.num_heads):
            # Head-packed kernel: no (B, L, H, Dh) transposes at all.
            out = fused_attention_heads(
                self._dense(query, 0), self._dense(key, 1),
                self._dense(value, 2), self.num_heads,
            )
            return F.linear(out, *self.out_params())

        q = self.project_q(query)
        k, v = self.project_kv(key, value)
        mask = None
        if attn_mask is not None:
            # (Lq, Lk) or (B, Lq, Lk) -> (B|1, 1, Lq, Lk)
            mask = attn_mask[None, None] if attn_mask.dim() == 2 else attn_mask[:, None]
        if key_padding_mask is not None:
            kp = key_padding_mask[:, None, None, :]  # (B, 1, 1, Lk)
            mask = kp if mask is None else mask | kp
        return self.attend(q, k, v, mask)


class ViTAttention(MultiHeadAttention):
    """The same attention with the timm ViT parameter layout (``qkv``,
    ``proj``), as the reference encoder checkpoints name it."""

    def __init__(self, embed_dim: int, num_heads: int):
        nn.Module.__init__(self)
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.qkv = nn.Linear(embed_dim, 3 * embed_dim)
        self.proj = nn.Linear(embed_dim, embed_dim)

    def in_proj(self):
        return self.qkv.weight, self.qkv.bias

    def out_params(self):
        return self.proj.weight, self.proj.bias


def mlp_forward(x, fc1: nn.Linear, fc2: nn.Linear, pre_ln: Optional[tuple] = None):
    """fc2(gelu_erf(fc1(x))), or x + that of LayerNorm(x) with ``pre_ln`` =
    (scale, bias, eps).  The fused kernels take the (in, out) layout: the
    Linear weights pass transposed, as views."""
    lead, d = x.shape[:-1], x.shape[-1]
    if _use_fused_mlp(x):
        x2 = x.reshape(-1, d)
        args = (fc1.weight.t(), fc1.bias, fc2.weight.t(), fc2.bias)
        if pre_ln is not None:
            g, b, eps = pre_ln
            if use_int8_encoder(x):
                (w1q, s1), (w2q, s2) = _int8_weights(fc1, fc1.weight, fc2.weight)
                out = fused_mlp_ln_int8(x2, g, b, w1q, s1, fc1.bias, w2q, s2,
                                        fc2.bias, eps=eps)
            else:
                out = fused_mlp_ln(x2, g, b, *args, eps=eps)
        else:
            out = fused_mlp(x2, *args)
        return out.reshape(*lead, fc2.out_features)
    residual = None
    if pre_ln is not None:
        residual = x
        g, b, eps = pre_ln
        x = layer_norm(x, g, b, eps, x.dtype)
    out = fc2(F.gelu(fc1(x), approximate="none"))
    return out if residual is None else residual + out


class Mlp(nn.Module):
    """Transformer MLP block (fc1 -> exact GELU -> fc2)."""

    def __init__(self, dim: int, hidden_dim: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, dim)

    def forward(self, x, pre_ln: Optional[tuple] = None):
        return mlp_forward(x, self.fc1, self.fc2, pre_ln)
