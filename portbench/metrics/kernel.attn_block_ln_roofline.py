"""The encoder's attention sublayer (``fused_attention_block_ln``) against
its bound: each traced call's least time (operations or bytes of its
logical shapes) over the device time of the kernels under its range, %."""

from portbench.core import peaks


def read(r):
    return r.op_roofline("attn_block_ln", lambda B, L, D, heads: peaks.attn_block_ln(B, L, D))
