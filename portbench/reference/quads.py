"""The DBNet postprocessor's answer for a map whose text regions are
axis-aligned rectangles of one value (the benchmark paints such maps):
each rectangle's minimum-area box (its corner pixels' centres: width
x1 - x0, height y1 - y0), grown on every side by the unclip distance
d = area * (ratio / sqrt(min side)) / perimeter, rescaled to the page,
rounded half to even and clipped to it; corners TL, TR, BR, BL.  Its
score is the mean map value inside, as a probability."""

import math

import numpy as np


def expected_quads(cores, map_hw, page_hw, unclip_ratio):
    """``cores`` (N, 4) inclusive pixel rectangles (x0, y0, x1, y1) on a map
    of ``map_hw`` -> (N, 4, 2) int64 quads on a page of ``page_hw``."""
    mh, mw = map_hw
    ph, pw = page_hw
    out = np.zeros((len(cores), 4, 2), np.int64)
    for n, (x0, y0, x1, y1) in enumerate(np.asarray(cores, np.float64)):
        w, h = x1 - x0, y1 - y0
        d = w * h * (unclip_ratio / math.sqrt(min(w, h))) / (2.0 * (w + h))
        xs = (x0 - d, x1 + d, x1 + d, x0 - d)
        ys = (y0 - d, y0 - d, y1 + d, y1 + d)
        for k in range(4):
            out[n, k, 0] = min(max(np.rint(xs[k] / mw * pw), 0), pw)
            out[n, k, 1] = min(max(np.rint(ys[k] / mh * ph), 0), ph)
    return out
