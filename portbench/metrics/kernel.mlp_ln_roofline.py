"""The encoder's MLP sublayer (``fused_mlp_ln``) against its bound: each
traced call's least time over its kernels' device time, %."""

from portbench.core import peaks


def read(r):
    return r.op_roofline("mlp_ln", lambda M, D, hidden: peaks.mlp_ln(M, D, hidden))
