"""PARSeq (Bautista & Atienza, ECCV 2022) as upstream YomiToku configures
it: a ViT encoder over 32xW line crops (patch embedding, learned position
embedding, pre-LN blocks at eps 1e-6, exact GELU, final LayerNorm), and a
one-layer two-stream decoder (position queries attend over the content
stream [BOS | pos_q[i-1] + emb(tok_i)] and the encoder memory; pre-LN at
eps 1e-5), a linear head over num_tokens - 2 classes.

Token ids: EOS = 0, the charset, BOS = num_tokens - 2, PAD = num_tokens - 1.
Masks are boolean, True = masked.

The reference decodes teacher-forced: given a sequence of tokens it
returns every position's logits in one pass (causal mask for the AR
decode, the cloze mask with the padding mask for the refine).
"""

import math

import torch
import torch.nn.functional as F


def param_spec(c):
    """[(name, shape, kind, fan_in)] of a PARSeq with the widths of ``c``
    (the configuration's ``text_recognizer`` entry), names in the reference
    checkpoints' state_dict layout."""
    D, De = c["embed_dim"], c["decoder_embed_dim"]
    ph, pw = c["patch_size"]
    h, w = c["img_size"]
    n_patch = (h // ph) * (w // pw)
    spec = []

    def lin(name, out, inp):
        spec.append((f"{name}.weight", (out, inp), "weight", inp))
        spec.append((f"{name}.bias", (out,), "bias", None))

    def ln(name, d):
        spec.append((f"{name}.weight", (d,), "norm_weight", None))
        spec.append((f"{name}.bias", (d,), "bias", None))

    spec.append(("pos_queries", (1, c["max_label_length"] + 1, De), "position", None))
    spec.append(("encoder.pos_embed", (1, n_patch, D), "position", None))
    spec.append(("encoder.patch_embed.proj.weight", (D, 3, ph, pw), "weight", 3 * ph * pw))
    spec.append(("encoder.patch_embed.proj.bias", (D,), "bias", None))
    hid = int(D * c["mlp_ratio"])
    for i in range(c["depth"]):
        p = f"encoder.blocks.{i}"
        ln(f"{p}.norm1", D)
        lin(f"{p}.attn.qkv", 3 * D, D)
        lin(f"{p}.attn.proj", D, D)
        ln(f"{p}.norm2", D)
        lin(f"{p}.mlp.fc1", hid, D)
        lin(f"{p}.mlp.fc2", D, hid)
    ln("encoder.norm", D)
    if c["decoder_depth"] != 1:
        raise NotImplementedError("the reference decoder has one layer")
    p = "decoder.layers.0"
    for attn in ("self_attn", "cross_attn"):
        spec.append((f"{p}.{attn}.in_proj_weight", (3 * De, De), "weight", De))
        spec.append((f"{p}.{attn}.in_proj_bias", (3 * De,), "bias", None))
        lin(f"{p}.{attn}.out_proj", De, De)
    hid = int(De * c["decoder_mlp_ratio"])
    lin(f"{p}.linear1", hid, De)
    lin(f"{p}.linear2", De, hid)
    for n in ("norm1", "norm2", "norm_q", "norm_c"):
        ln(f"{p}.{n}", De)
    ln("decoder.norm", De)
    lin("head", c["num_tokens"] - 2, De)
    spec.append(("text_embed.embedding.weight", (c["num_tokens"], De), "weight", De))
    return spec


def _ln(x, p, name, eps):
    return F.layer_norm(x, x.shape[-1:], p[f"{name}.weight"], p[f"{name}.bias"], eps)


def _heads(x, n):
    B, L, D = x.shape
    return x.reshape(B, L, n, D // n).transpose(1, 2)


def _attention(q, k, v, n, prec, mask=None):
    """(B, Lq, D), (B, Lk, D) x2 -> (B, Lq, D); softmax(q k^T / sqrt(Dh)) v
    per head, ``mask`` broadcastable to (B, n, Lq, Lk)."""
    q, k, v = _heads(q, n), _heads(k, n), _heads(v, n)
    logits = prec.matmul(q, k.transpose(-1, -2)) * (q.shape[-1] ** -0.5)
    if mask is not None:
        logits = logits.masked_fill(mask, float("-inf"))
    out = prec.matmul(torch.softmax(logits, dim=-1), v)
    B, _, Lq, Dh = out.shape
    return out.transpose(1, 2).reshape(B, Lq, n * Dh)


def encode(p, c, crops, prec):
    """(B, H, W, 3) RGB crops in [-1, 1] -> memory (B, N, D)."""
    ph, pw = c["patch_size"]
    x = prec.conv2d(crops.permute(0, 3, 1, 2), p["encoder.patch_embed.proj.weight"],
                    p["encoder.patch_embed.proj.bias"], stride=(ph, pw))
    x = x.flatten(2).transpose(1, 2) + p["encoder.pos_embed"]
    n = c["num_heads"]
    for i in range(c["depth"]):
        b = f"encoder.blocks.{i}"
        h = _ln(x, p, f"{b}.norm1", 1e-6)
        q, k, v = prec.linear(h, p[f"{b}.attn.qkv.weight"], p[f"{b}.attn.qkv.bias"]).chunk(3, -1)
        x = x + prec.linear(_attention(q, k, v, n, prec),
                            p[f"{b}.attn.proj.weight"], p[f"{b}.attn.proj.bias"])
        h = _ln(x, p, f"{b}.norm2", 1e-6)
        h = F.gelu(prec.linear(h, p[f"{b}.mlp.fc1.weight"], p[f"{b}.mlp.fc1.bias"]))
        x = x + prec.linear(h, p[f"{b}.mlp.fc2.weight"], p[f"{b}.mlp.fc2.bias"])
    return _ln(x, p, "encoder.norm", 1e-6)


def _mha(p, name, q, kv, n, prec, mask=None):
    w, b = p[f"{name}.in_proj_weight"], p[f"{name}.in_proj_bias"]
    D = q.shape[-1]
    out = _attention(prec.linear(q, w[:D], b[:D]), prec.linear(kv, w[D:2 * D], b[D:2 * D]),
                     prec.linear(kv, w[2 * D:], b[2 * D:]), n, prec, mask)
    return prec.linear(out, p[f"{name}.out_proj.weight"], p[f"{name}.out_proj.bias"])


def decode(p, c, memory, tokens, mask, prec):
    """Teacher-forced decoder pass: ``tokens`` (B, L) = [BOS, t1, ...]
    -> logits (B, L, num_tokens - 2), query i attending over the content
    positions ``mask`` (broadcastable to (B, heads, L, L)) leaves open."""
    B, L = tokens.shape
    De = memory.shape[-1]
    emb = p["text_embed.embedding.weight"][tokens] * math.sqrt(De)
    pos = p["pos_queries"][:, :L]
    content = torch.cat([emb[:, :1], pos[:, :L - 1] + emb[:, 1:]], dim=1)
    query = pos.expand(B, -1, -1)
    lp = "decoder.layers.0"
    n = c["decoder_num_heads"]
    t = query + _mha(p, f"{lp}.self_attn", _ln(query, p, f"{lp}.norm_q", 1e-5),
                     _ln(content, p, f"{lp}.norm_c", 1e-5), n, prec, mask)
    t = t + _mha(p, f"{lp}.cross_attn", _ln(t, p, f"{lp}.norm1", 1e-5), memory, n, prec)
    h = F.gelu(prec.linear(_ln(t, p, f"{lp}.norm2", 1e-5),
                           p[f"{lp}.linear1.weight"], p[f"{lp}.linear1.bias"]))
    t = t + prec.linear(h, p[f"{lp}.linear2.weight"], p[f"{lp}.linear2.bias"])
    return prec.linear(_ln(t, p, "decoder.norm", 1e-5), p["head.weight"], p["head.bias"])


def ar_logits(p, c, memory, ar_tokens, prec):
    """Logits of every AR step given the decoded sequence ``ar_tokens``
    (B, L) = [BOS, t1, ..., t_{L-1}]: step i sees content 0..i (causal)."""
    L = ar_tokens.shape[1]
    causal = torch.triu(torch.ones(L, L, dtype=torch.bool, device=memory.device), 1)
    return decode(p, c, memory, ar_tokens, causal, prec)


def refine_logits(p, c, memory, ar_tokens, prec):
    """The cloze refinement over the AR sequence: query i may not see
    content i + 1, nor any content from the first EOS on."""
    L = ar_tokens.shape[1]
    ones = torch.ones(L, L, dtype=torch.bool, device=memory.device)
    cloze = torch.triu(ones, 1) & ~torch.triu(ones, 2)
    padding = (ar_tokens == 0).int().cumsum(-1) > 0  # from the first EOS
    mask = cloze[None, None] | padding[:, None, None, :]
    return decode(p, c, memory, ar_tokens, mask, prec)
