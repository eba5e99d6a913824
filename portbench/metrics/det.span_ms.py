"""The detector's ``det/call`` span (``TextDetector.__call__``, ms per
completed page): the resize on the card, DBNet's launch
(``det/dispatch``), the map's readback (``det/sync``) and the contours."""


def read(r):
    span = r.stages.get(("det", "call"))
    return 1e3 * span / r.pages if r.pages and span else None
