"""The recognizer's ``rec/call`` span (``TextRecognizer.__call__``, ms per
completed page): the line maps, the crops, the encoder, the AR loop, the
refine, the readback and the tokenizer."""


def read(r):
    span = r.stages.get(("rec", "call"))
    return 1e3 * span / r.pages if r.pages and span else None
