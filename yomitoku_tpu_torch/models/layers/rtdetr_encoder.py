"""RT-DETR HybridEncoder (counterpart of
yomitoku_tpu/models/layers/rtdetr_encoder.py).

Per-level 1x1 projections, one post-LN AIFI self-attention layer on the
stride-32 level with a 2D sincos position embedding, then a CSPRep FPN
(top-down) and PAN (bottom-up) across the three levels.  NCHW; parameter
names follow the reference ``state_dict`` (rtdetr_hybrid_encoder.py).
Every LayerNorm has torch's eps 1e-5 and the GELU is the exact erf form:
the JAX package pins both (a wrong eps is an O(1) error where the token
variance collapses).
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .attention import LayerNorm, MultiHeadAttention
from .presnet import ACTS, ConvNorm


def sincos_pos_embed_2d(w: int, h: int, dim: int, temperature: float = 10000.0):
    """[sin(w), cos(w), sin(h), cos(h)] per token, the grid built with
    indexing='ij' over (w, h) and flattened w-major, as the reference
    build_2d_sincos_position_embedding does -> (1, w * h, dim) float32."""
    grid_w, grid_h = np.meshgrid(
        np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32),
        indexing="ij",
    )
    pos_dim = dim // 4
    omega = 1.0 / (temperature ** (np.arange(pos_dim, dtype=np.float32) / pos_dim))
    out_w = grid_w.flatten()[:, None] * omega[None]
    out_h = grid_h.flatten()[:, None] * omega[None]
    pe = np.concatenate(
        [np.sin(out_w), np.cos(out_w), np.sin(out_h), np.cos(out_h)], axis=1
    )
    return pe[None]


class AIFILayer(nn.Module):
    """Post-LN transformer encoder layer; the position embedding is added
    to the queries and keys, not to the values (reference
    TransformerEncoderLayer)."""

    def __init__(self, d_model, nhead, dim_feedforward, act="gelu"):
        super().__init__()
        self.self_attn = MultiHeadAttention(d_model, nhead)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm1 = LayerNorm(d_model, eps=1e-5)
        self.norm2 = LayerNorm(d_model, eps=1e-5)
        self.act = act

    def forward(self, src, pos_embed):
        q = src + pos_embed
        src = self.norm1(src + self.self_attn(q, q, src))
        h = self.linear2(ACTS[self.act](self.linear1(src)))
        return self.norm2(src + h)


class _TransformerEncoder(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class RepVggBlock(nn.Module):
    def __init__(self, cin, cout, act="silu"):
        super().__init__()
        self.conv1 = ConvNorm(cin, cout, 3)
        self.conv2 = ConvNorm(cin, cout, 1)
        self.act = act

    def forward(self, x):
        return ACTS[self.act](self.conv1(x) + self.conv2(x))


class CSPRepLayer(nn.Module):
    def __init__(self, cin, cout, num_blocks=3, expansion=1.0, act="silu"):
        super().__init__()
        hidden = int(cout * expansion)
        self.conv1 = ConvNorm(cin, hidden, 1, act=act)
        self.conv2 = ConvNorm(cin, hidden, 1, act=act)
        self.bottlenecks = nn.Sequential(
            *[RepVggBlock(hidden, hidden, act) for _ in range(num_blocks)]
        )
        self.conv3 = (ConvNorm(hidden, cout, 1, act=act) if hidden != cout
                      else nn.Identity())

    def forward(self, x):
        return self.conv3(self.bottlenecks(self.conv1(x)) + self.conv2(x))


class HybridEncoder(nn.Module):
    def __init__(self, in_channels=(512, 1024, 2048), hidden_dim=256,
                 use_encoder_idx=(2,), num_encoder_layers=1, nhead=8,
                 dim_feedforward=1024, enc_act="gelu", expansion=1.0,
                 depth_mult=1.0, act="silu", pe_temperature=10000.0):
        super().__init__()
        d = hidden_dim
        nlev = len(in_channels)
        self.hidden_dim = d
        self.use_encoder_idx = tuple(use_encoder_idx)
        self.pe_temperature = pe_temperature
        self.input_proj = nn.ModuleList([ConvNorm(c, d, 1) for c in in_channels])
        self.encoder = nn.ModuleList([
            _TransformerEncoder([
                AIFILayer(d, nhead, dim_feedforward, enc_act)
                for _ in range(num_encoder_layers)
            ])
            for _ in self.use_encoder_idx
        ])
        nblocks = round(3 * depth_mult)
        self.lateral_convs = nn.ModuleList(
            [ConvNorm(d, d, 1, act=act) for _ in range(nlev - 1)])
        self.fpn_blocks = nn.ModuleList(
            [CSPRepLayer(2 * d, d, nblocks, expansion, act) for _ in range(nlev - 1)])
        self.downsample_convs = nn.ModuleList(
            [ConvNorm(d, d, 3, 2, act=act) for _ in range(nlev - 1)])
        self.pan_blocks = nn.ModuleList(
            [CSPRepLayer(2 * d, d, nblocks, expansion, act) for _ in range(nlev - 1)])
        self._pos = {}  # (W, H, device, dtype) -> position embedding

    def pos_embed(self, w, h, like):
        key = (w, h, like.device, like.dtype)
        if key not in self._pos:
            pe = sincos_pos_embed_2d(w, h, self.hidden_dim, self.pe_temperature)
            self._pos[key] = torch.from_numpy(pe).to(like.device, like.dtype)
        return self._pos[key]

    def forward(self, feats):
        proj = [p(f) for p, f in zip(self.input_proj, feats)]
        for enc, idx in zip(self.encoder, self.use_encoder_idx):
            B, C, H, W = proj[idx].shape
            src = proj[idx].flatten(2).transpose(1, 2)  # (B, H*W, C)
            pe = self.pos_embed(W, H, src)
            for layer in enc.layers:
                src = layer(src, pe)
            proj[idx] = src.transpose(1, 2).reshape(B, C, H, W)

        # top-down FPN
        nlev = len(proj)
        inner = [proj[-1]]
        for i, idx in enumerate(range(nlev - 1, 0, -1)):
            high = self.lateral_convs[i](inner[0])
            inner[0] = high
            up = F.interpolate(high, scale_factor=2.0, mode="nearest")
            inner.insert(0, self.fpn_blocks[i](torch.cat([up, proj[idx - 1]], 1)))

        # bottom-up PAN
        outs = [inner[0]]
        for i in range(nlev - 1):
            down = self.downsample_convs[i](outs[-1])
            outs.append(self.pan_blocks[i](torch.cat([down, inner[i + 1]], 1)))
        return outs
