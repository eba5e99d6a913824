"""ViT encoder for PARSeq text recognition (counterpart of
yomitoku_tpu/models/layers/vit.py): patch-embed conv, learned position
embedding, no class token, pre-LN blocks, final LayerNorm, all LayerNorms
at eps 1e-6.  Parameter names follow the reference timm encoder.

The public forward takes NHWC images, as the JAX package's does; the
patch-embed convolution runs NCHW inside.
"""

from typing import Sequence

import torch
from torch import nn

from .attention import LayerNorm, Mlp, ViTAttention

VIT_EPS = 1e-6


class PatchEmbed(nn.Module):
    def __init__(self, embed_dim: int, patch_size: Sequence[int]):
        super().__init__()
        self.proj = nn.Conv2d(3, embed_dim, tuple(patch_size),
                              stride=tuple(patch_size))

    def forward(self, x):  # (B, H, W, C)
        x = self.proj(x.permute(0, 3, 1, 2))
        B, D, Hp, Wp = x.shape
        # row-major (H-major) token order; grid kept for pos-embed slicing
        return x.flatten(2).transpose(1, 2).contiguous(), (Hp, Wp)


class EncoderBlock(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int, mlp_ratio: float):
        super().__init__()
        self.norm1 = LayerNorm(embed_dim, eps=VIT_EPS)
        self.attn = ViTAttention(embed_dim, num_heads)
        self.norm2 = LayerNorm(embed_dim, eps=VIT_EPS)
        self.mlp = Mlp(embed_dim, int(embed_dim * mlp_ratio))

    def forward(self, x):
        # Pre-LN sublayers with LN + residual folded into the fused kernels
        # (pre_ln contract: the submodule returns x + sublayer(LN(x))).
        x = self.attn(x, x, x, pre_ln=(self.norm1.weight, self.norm1.bias, VIT_EPS))
        return self.mlp(x, pre_ln=(self.norm2.weight, self.norm2.bias, VIT_EPS))


class ViTEncoder(nn.Module):
    def __init__(self, img_size, patch_size, embed_dim, depth, num_heads,
                 mlp_ratio=4.0):
        super().__init__()
        self.grid = (img_size[0] // patch_size[0], img_size[1] // patch_size[1])
        self.patch_embed = PatchEmbed(embed_dim, patch_size)
        self.pos_embed = nn.Parameter(
            torch.zeros(1, self.grid[0] * self.grid[1], embed_dim)
        )
        self.blocks = nn.ModuleList(
            EncoderBlock(embed_dim, num_heads, mlp_ratio) for _ in range(depth)
        )
        self.norm = LayerNorm(embed_dim, eps=VIT_EPS)

    def forward(self, x):  # (B, H, W, 3) -> (B, N, D)
        x, (hp, wp) = self.patch_embed(x)
        pos = self.pos_embed
        if (hp, wp) != self.grid:
            # narrower input: the top-left sub-grid of the learned position
            # embedding, so token (i, j) keeps its trained embedding
            D = pos.shape[-1]
            pos = pos.reshape(1, *self.grid, D)[:, :hp, :wp].reshape(1, hp * wp, D)
        x = x + pos.to(x.dtype)
        for blk in self.blocks:
            x = blk(x)
        return self.norm(x)
