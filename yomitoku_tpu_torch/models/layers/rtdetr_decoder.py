"""RT-DETRv2 transformer decoder (counterpart of
yomitoku_tpu/models/layers/rtdetr_decoder.py).

Anchor-based top-k query selection over the flattened pyramid, then
decoder layers of self-attention, multi-scale deformable cross-attention
and FFN with iterative sigmoid box refinement, stopping at ``eval_idx``.
Parameter names follow the reference ``state_dict`` (rtdetrv2_decoder.py),
including the score heads of every layer, of which inference reads only
``eval_idx``'s.  The offsets, locations and attention weights are computed
in the compute dtype, as in the JAX package; the deformable sampling itself
is ``ops.ms_deformable_attention`` (the CUDA kernel on the card).
"""

import numpy as np
import torch
from torch import nn

from ...ops import ms_deformable_attention
from .attention import LayerNorm, MultiHeadAttention
from .presnet import ACTS, ConvNorm


def inverse_sigmoid(x, eps=1e-5):
    x = x.clamp(0.0, 1.0)
    return torch.log(x.clamp(min=eps) / (1 - x).clamp(min=eps))


class MLP(nn.Module):
    """``num_layers`` Linear layers with ReLU between them (reference MLP,
    parameters ``layers.<j>``)."""

    def __init__(self, input_dim, hidden_dim, output_dim, num_layers, act="relu"):
        super().__init__()
        dims = [input_dim] + [hidden_dim] * (num_layers - 1) + [output_dim]
        self.layers = nn.ModuleList(
            [nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:])])
        self.act = act

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = ACTS[self.act](x)
        return x


class MSDeformableAttention(nn.Module):
    def __init__(self, embed_dim, num_heads, num_levels, num_points_list,
                 offset_scale=0.5):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.num_points_list = tuple(num_points_list)
        self.offset_scale = offset_scale
        total = sum(self.num_points_list)
        self.sampling_offsets = nn.Linear(embed_dim, num_heads * total * 2)
        self.attention_weights = nn.Linear(embed_dim, num_heads * total)
        self.value_proj = nn.Linear(embed_dim, embed_dim)
        self.output_proj = nn.Linear(embed_dim, embed_dim)
        scale = [1.0 / n for n in self.num_points_list for _ in range(n)]
        # a buffer of the reference checkpoints too, dropped when one loads
        self.register_buffer("num_points_scale", torch.tensor(scale)[:, None],
                             persistent=False)

    def forward(self, query, reference_points, value, spatial_shapes):
        """reference_points (B, Lq, 1, 4) cxcywh in [0, 1]."""
        B, Lq = query.shape[:2]
        nh = self.num_heads
        total = sum(self.num_points_list)
        v = self.value_proj(value).reshape(B, -1, nh, self.embed_dim // nh)
        off = self.sampling_offsets(query).reshape(B, Lq, nh, total, 2)
        att = self.attention_weights(query).reshape(B, Lq, nh, total)
        att = torch.softmax(att, dim=-1)
        offset = (off * self.num_points_scale
                  * reference_points[:, :, None, :, 2:] * self.offset_scale)
        locations = reference_points[:, :, None, :, :2] + offset
        # the JAX model's deformable_attention_core
        out = ms_deformable_attention(
            v, locations, att, spatial_shapes, self.num_points_list)
        return self.output_proj(out)


class RTDETRDecoderLayer(nn.Module):
    def __init__(self, d_model, n_head, dim_feedforward, num_levels,
                 num_points_list, act="relu"):
        super().__init__()
        self.self_attn = MultiHeadAttention(d_model, n_head)
        self.cross_attn = MSDeformableAttention(
            d_model, n_head, num_levels, num_points_list)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm1 = LayerNorm(d_model, eps=1e-5)
        self.norm2 = LayerNorm(d_model, eps=1e-5)
        self.norm3 = LayerNorm(d_model, eps=1e-5)
        self.act = act

    def forward(self, target, reference_points, memory, spatial_shapes,
                query_pos_embed):
        q = target + query_pos_embed
        target = self.norm1(target + self.self_attn(q, q, target))
        h = self.cross_attn(target + query_pos_embed, reference_points, memory,
                            spatial_shapes)
        target = self.norm2(target + h)
        h = self.linear2(ACTS[self.act](self.linear1(target)))
        return self.norm3(target + h)


def generate_anchors(spatial_shapes, grid_size=0.05, eps=1e-2):
    """Per-level half-pixel grid anchors in [0, 1] with exponential
    width/height, logit-transformed, invalid ones +inf (reference
    _generate_anchors) -> (anchors (1, L, 4) float32, valid (1, L, 1))."""
    anchors = []
    for lvl, (h, w) in enumerate(spatial_shapes):
        gy, gx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        gxy = (np.stack([gx, gy], -1).reshape(-1, 2) + 0.5) / np.array(
            [w, h], np.float32)
        wh = np.ones_like(gxy) * grid_size * (2.0 ** lvl)
        anchors.append(np.concatenate([gxy, wh], -1))
    anchors = np.concatenate(anchors, 0)[None]
    valid = ((anchors > eps) & (anchors < 1 - eps)).all(-1, keepdims=True)
    anchors = np.log(anchors / (1 - anchors))
    anchors = np.where(valid, anchors, np.inf).astype(np.float32)
    return anchors, valid


class _EncOutput(nn.Module):
    def __init__(self, d):
        super().__init__()
        self.proj = nn.Linear(d, d)
        self.norm = LayerNorm(d, eps=1e-5)

    def forward(self, x):
        return self.norm(self.proj(x))


class _Decoder(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class RTDETRTransformerv2(nn.Module):
    def __init__(self, num_classes, hidden_dim=256, num_queries=300,
                 feat_channels=(256, 256, 256), num_levels=3,
                 num_points=(4, 4, 4), nhead=8, num_layers=6,
                 dim_feedforward=1024, eval_idx=-1, eps=1e-2):
        super().__init__()
        d = hidden_dim
        self.num_queries = num_queries
        self.eps = eps
        self.num_layers = num_layers
        self.eval_idx = eval_idx if eval_idx >= 0 else num_layers + eval_idx
        self.input_proj = nn.ModuleList(
            [ConvNorm(c, d, 1) for c in feat_channels[:num_levels]])
        self.enc_output = _EncOutput(d)
        self.enc_score_head = nn.Linear(d, num_classes)
        self.enc_bbox_head = MLP(d, d, 4, 3)
        # shared by every decoder layer (reference TransformerDecoder)
        self.query_pos_head = MLP(4, 2 * d, d, 2)
        self.decoder = _Decoder([
            RTDETRDecoderLayer(d, nhead, dim_feedforward, num_levels, num_points)
            for _ in range(num_layers)
        ])
        self.dec_bbox_head = nn.ModuleList(
            [MLP(d, d, 4, 3) for _ in range(num_layers)])
        self.dec_score_head = nn.ModuleList(
            [nn.Linear(d, num_classes) for _ in range(num_layers)])
        self._anchors = {}  # (spatial shapes, device) -> (anchors, valid)

    def anchors(self, spatial_shapes, device):
        key = (tuple(spatial_shapes), device)
        if key not in self._anchors:
            anchors, valid = generate_anchors(spatial_shapes, eps=self.eps)
            self._anchors[key] = (torch.from_numpy(anchors).to(device),
                                  torch.from_numpy(valid).to(device))
        return self._anchors[key]

    def forward(self, feats):
        flat, spatial_shapes = [], []
        for proj, f in zip(self.input_proj, feats):
            p = proj(f)
            spatial_shapes.append(tuple(p.shape[-2:]))
            flat.append(p.flatten(2).transpose(1, 2))  # (B, H*W, d)
        memory = torch.cat(flat, dim=1)
        anchors, valid = self.anchors(spatial_shapes, memory.device)
        memory = memory * valid.to(memory.dtype)

        out_mem = self.enc_output(memory)
        enc_logits = self.enc_score_head(out_mem)
        enc_coord = self.enc_bbox_head(out_mem).float() + anchors

        # top-k query selection on the largest class logit
        scores = enc_logits.float().amax(dim=-1)
        topk_ind = torch.topk(scores, self.num_queries, dim=1).indices

        def take(t):
            return torch.gather(
                t, 1, topk_ind[..., None].expand(-1, -1, t.shape[-1]))

        output = take(out_mem)
        ref_points = torch.sigmoid(take(enc_coord))
        dt = output.dtype
        for i, layer in enumerate(self.decoder.layers):
            qpe = self.query_pos_head(ref_points.to(dt))
            output = layer(output, ref_points[:, :, None].to(dt), memory,
                           spatial_shapes, qpe)
            delta = self.dec_bbox_head[i](output)
            new_ref = torch.sigmoid(delta.float() + inverse_sigmoid(ref_points))
            if i == self.eval_idx:
                logits = self.dec_score_head[i](output).float()
                return {"pred_logits": logits, "pred_boxes": new_ref}
            ref_points = new_ref
        raise ValueError(f"eval_idx {self.eval_idx} outside {self.num_layers} layers")
