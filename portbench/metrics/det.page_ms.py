"""The detector's call per page (``OCR.detector``, wall ms, mean over the
window's calls): the device resize, DBNet, the map's readback and the
contours."""


def read(r):
    calls = r.spans.get("det", [])
    return 1e3 * sum(calls) / len(calls) if calls else None
