"""Published peaks of one NVIDIA H100 SXM (data sheet, dense rates) and the
operation and byte counts the roofline shares and the step's MFU divide
by.  Counts are of what the inputs need: every input byte read once and
every output byte written once, multiply-adds as two operations."""

BF16_FLOP_S = 989e12
HBM_BYTES_S = 3.35e12
BF16 = 2  # bytes


def bound_s(ops, nbytes):
    """The least time the card could take: the larger of ``ops`` at the bf16
    peak and ``nbytes`` at the memory rate."""
    return max(ops / BF16_FLOP_S, nbytes / HBM_BYTES_S)


def attn_block_ln(B, L, D):
    """x + proj(attention(LN(x) Wqkv + b)) over (B, L, D), bf16:
    (operations, bytes).  QKV and output projections 8 B L D^2, QK^T and PV
    4 B L^2 D; x read and the output written, the weights (4 D^2) and the
    biases and LN parameters (6 D) read once."""
    ops = 8 * B * L * D * D + 4 * B * L * L * D
    nbytes = BF16 * (2 * B * L * D + 4 * D * D + 6 * D)
    return ops, nbytes


def mlp_ln(M, D, hidden):
    """x + fc2(gelu(fc1(LN(x)))) over (M, D), bf16: (operations, bytes)."""
    ops = 4 * M * D * hidden
    nbytes = BF16 * (2 * M * D + 2 * D * hidden + hidden + 3 * D)
    return ops, nbytes


def parseq_line_flops(c, steps):
    """Operations one line needs in PARSeq with the widths of ``c``: the
    encoder at the full canvas, ``steps`` AR decode steps (step i attends
    over i + 1 content rows), and the refine over every position."""
    D, De = c["embed_dim"], c["decoder_embed_dim"]
    ph, pw = c["patch_size"]
    h, w = c["img_size"]
    N = (h // ph) * (w // pw)
    hid = D * c["mlp_ratio"]
    enc = 2 * N * 3 * ph * pw * D  # patch embedding
    enc += c["depth"] * (8 * N * D * D + 4 * N * N * D + 4 * N * D * hid)
    L = c["max_label_length"] + 1
    classes = c["num_tokens"] - 2
    dhid = De * c["decoder_mlp_ratio"]
    memory_kv = 4 * N * De * De
    # per position: its content row's K/V (4 De^2), the query and output
    # projections of both attentions (8 De^2), the MLP, the head
    per_pos = 12 * De * De + 4 * De * dhid + 2 * De * classes
    ar = memory_kv + sum(per_pos + 4 * (i + 1) * De + 4 * N * De for i in range(steps))
    # the refine reads the same memory K/V
    refine = L * (per_pos + 4 * L * De + 4 * N * De)
    return enc + ar + refine


def dbnet_flops(det, map_hw):
    """Operations of one DBNet forward at ``map_hw``, counted by torch's
    flop counter over the reference's convolutions on meta tensors."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from portbench.reference import dbnet
    from portbench.reference.precision import Precision

    params = {name: torch.empty(shape, device="meta")
              for name, shape, _, _ in dbnet.param_spec(det)}
    x = torch.empty((1, 3, *map_hw), device="meta")
    with FlopCounterMode(display=False) as counter:
        dbnet.forward(params, x, Precision())
    return counter.get_total_flops()
