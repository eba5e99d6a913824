"""Two-stream (query/content) transformer decoder for PARSeq (counterpart
of yomitoku_tpu/models/layers/two_stream.py): pre-LN layers where a
position-query stream attends over a content stream (token embeddings)
and the encoder memory, LayerNorms at eps 1e-5.  The content stream is
only updated between layers (never after the last), so with depth 1 the
content keys are the raw embeddings and the AR loop keeps one content K/V
cache.  Parameter names follow the reference decoder.
"""

from typing import Optional

import torch
from torch import nn

from .attention import LayerNorm, MultiHeadAttention, mlp_forward, quantize_kv_int8

DEC_EPS = 1e-5


class TwoStreamDecoderLayer(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int, mlp_ratio: float):
        super().__init__()
        D = embed_dim
        self.self_attn = MultiHeadAttention(D, num_heads)
        self.cross_attn = MultiHeadAttention(D, num_heads)
        self.linear1 = nn.Linear(D, int(D * mlp_ratio))
        self.linear2 = nn.Linear(int(D * mlp_ratio), D)
        self.norm1 = LayerNorm(D, eps=DEC_EPS)
        self.norm2 = LayerNorm(D, eps=DEC_EPS)
        self.norm_q = LayerNorm(D, eps=DEC_EPS)
        self.norm_c = LayerNorm(D, eps=DEC_EPS)

    def _mlp(self, x):
        return mlp_forward(x, self.linear1, self.linear2)

    def _stream(self, tgt, tgt_norm, tgt_kv, memory, attn_mask, key_padding_mask):
        tgt = tgt + self.self_attn(
            tgt_norm, tgt_kv, tgt_kv, attn_mask=attn_mask,
            key_padding_mask=key_padding_mask,
        )
        tgt = tgt + self.cross_attn(self.norm1(tgt), memory, memory)
        return tgt + self._mlp(self.norm2(tgt))

    # -- cached AR decode API --------------------------------------------

    def memory_kv(self, memory):
        """Loop-invariant cross-attention K/V: (B, H, M, Dh) x2."""
        return self.cross_attn.project_kv(memory, memory)

    def memory_kv_int8(self, memory):
        """The memory K/V as an int8 cache with per-(batch, head) scales:
        (kq, sk, vq, sv) (``attention.quantize_kv_int8``)."""
        return quantize_kv_int8(*self.memory_kv(memory))

    def content_kv(self, rows):
        """Self-attention K/V for new content rows: (B, H, r, Dh) x2."""
        c = self.norm_c(rows)
        return self.self_attn.project_kv(c, c)

    def query_step(self, query, kc, vc, km, vm, query_mask=None):
        """Query-stream update against cached K/V (no content update).
        ``km`` may be the int8 memory cache (kq, sk, vq, sv) of
        ``memory_kv_int8``; ``vm`` is then unused."""
        mask = None
        if query_mask is not None:
            m = query_mask
            mask = m[None, None] if m.dim() == 2 else m[:, None]
        q1 = self.self_attn.project_q(self.norm_q(query))
        tgt = query + self.self_attn.attend(q1, kc, vc, mask)
        q2 = self.cross_attn.project_q(self.norm1(tgt))
        if isinstance(km, tuple):
            tgt = tgt + self.cross_attn.attend_int8(q2, *km)
        else:
            tgt = tgt + self.cross_attn.attend(q2, km, vm)
        return tgt + self._mlp(self.norm2(tgt))

    def forward(self, query, content, memory, query_mask=None,
                content_mask=None, content_key_padding_mask=None,
                update_content: bool = True):
        query_norm = self.norm_q(query)
        content_norm = self.norm_c(content)
        query = self._stream(query, query_norm, content_norm, memory,
                             query_mask, content_key_padding_mask)
        if update_content:
            content = self._stream(content, content_norm, content_norm, memory,
                                   content_mask, content_key_padding_mask)
        return query, content


class TwoStreamDecoder(nn.Module):
    def __init__(self, embed_dim, num_heads, mlp_ratio, depth):
        super().__init__()
        self.layers = nn.ModuleList(
            TwoStreamDecoderLayer(embed_dim, num_heads, mlp_ratio)
            for _ in range(depth)
        )
        self.norm = LayerNorm(embed_dim, eps=DEC_EPS)

    def forward(self, query, content, memory, query_mask=None,
                content_mask=None, content_key_padding_mask=None):
        for i, layer in enumerate(self.layers):
            query, content = layer(
                query, content, memory, query_mask, content_mask,
                content_key_padding_mask,
                update_content=i < len(self.layers) - 1,
            )
        return self.norm(query)

    # -- cached AR decode (depth-1 fast path) ------------------------------

    def ar_memory_kv(self, memory):
        return self.layers[0].memory_kv(memory)

    def ar_content_kv(self, rows):
        return self.layers[0].content_kv(rows)

    def ar_query_step(self, query, kc, vc, km, vm,
                      query_mask: Optional[torch.Tensor] = None):
        return self.norm(self.layers[0].query_step(query, kc, vc, km, vm, query_mask))
