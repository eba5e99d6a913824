"""Host work of the recognizer per completed page (ms): its stage
accounting's ``host_prep`` (quads checked, line maps) and ``tokenize``
(ids to text) segments.  Its ``dispatch`` segment is left out: it holds
the AR loop, whose per-step readback waits for the card."""


def read(r):
    s = sum(r.stages.get(("rec", kind), 0.0) for kind in ("host_prep", "tokenize"))
    return 1e3 * s / r.pages if r.pages and s else None
