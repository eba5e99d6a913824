"""The whole page's share of the card's bf16 peak: the operations the
window's completed pages need (DBNet at its input, the encoder on real
lines, the AR steps run, the refine) over the window's seconds at 989
TFLOP/s, %."""

from portbench.core import peaks


def read(r):
    if not r.flops:
        return None
    return 100.0 * r.flops / (r.seconds * peaks.BF16_FLOP_S)
