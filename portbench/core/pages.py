"""The one page generator every traffic mix feeds with its parameters.

A page is a white A4 portrait image, uint8 BGR, with ``columns`` x
``rows`` text lines; each line is a run of glyph-like ink blocks (two to
four dark strokes in a glyph box).  The seed moves the glyph counts,
sizes, strokes and places, never the number of lines.

Beside each page the generator paints the detector's map: each line's
core, a rectangle of ``paint_value`` whose unclip (the postprocessor's
growth by area * ratio / sqrt(min side) / perimeter) gives back a box
about the line's ink.  Random weights find one or two words on a page,
too few to exercise the recognizer; the painted map stands in for the
detector's output after its real forward has run.
"""

import math

import numpy as np

from portbench.reference.pages import detector_size

#: keys a traffic file must give
TRAFFIC_KEYS = ("page_hw", "pool", "clients", "columns", "rows", "margin", "column_gap",
                "row_pitch", "glyphs", "glyph_h", "glyph_w", "advance", "paint_value")


class Page:
    """One generated page: ``image`` (H, W, 3) uint8 BGR, ``lines`` (N, 4)
    ink boxes (x0, y0, x1, y1) on the page, ``cores`` (N, 4) inclusive
    painted rectangles on the map, ``map`` (1, mh, mw) uint8."""

    def __init__(self, image, lines, cores, painted):
        self.image, self.lines, self.cores, self.map = image, lines, cores, painted


def check_traffic(t):
    missing = [k for k in TRAFFIC_KEYS if k not in t]
    if missing:
        raise ValueError(f"traffic lacks {missing}")
    H, W = t["page_hw"]
    col_w = (W - 2 * t["margin"][1] - (t["columns"] - 1) * t["column_gap"]) / t["columns"]
    if t["glyphs"][1] * t["advance"] > col_w:
        raise ValueError(f"a line of {t['glyphs'][1]} glyphs exceeds its column ({col_w:.0f} px)")
    if t["margin"][0] + t["rows"] * t["row_pitch"] > H:
        raise ValueError("the rows exceed the page")
    if t["glyph_h"][1] >= t["row_pitch"] or t["glyph_w"][1] > t["advance"]:
        raise ValueError("glyphs overlap their neighbours")
    return col_w


def _core_size(w, h, ratio):
    """(wc, hc) of the rectangle that the unclip grows to about (w, h)."""
    lo, hi = 0.0, min(w, h) / 2.0
    for _ in range(60):
        d = (lo + hi) / 2
        wc, hc = w - 2 * d, h - 2 * d
        grown = wc * hc * (ratio / math.sqrt(min(wc, hc))) / (2 * (wc + hc))
        lo, hi = (d, hi) if grown > d else (lo, d)
    return w - 2 * lo, h - 2 * lo


def make_page(t, det, seed, index):
    """Page ``index`` of the pool for ``seed``; ``det`` is the configuration's
    ``text_detector`` entry (resize and unclip)."""
    rng = np.random.default_rng([int(seed) & (2**63 - 1), int(index)])
    H, W = t["page_hw"]
    col_w = check_traffic(t)
    img = np.full((H, W, 3), 255, np.uint8)
    n_lines, g_max = t["columns"] * t["rows"], t["glyphs"][1]
    # every draw of the page at once: per line 4 numbers, per glyph 1, per
    # stroke (up to four a glyph) 6, as uniforms scaled to their ranges
    u_line = rng.random((n_lines, 4))
    u_glyph = rng.random((n_lines, g_max))
    u_stroke = rng.random((n_lines, g_max, 4, 6))

    def pick(u, lo, hi):  # an integer in [lo, hi]
        return lo + int(u * (hi - lo + 1))

    lines = []
    for i in range(n_lines):
        col, row = divmod(i, t["rows"])
        ul = u_line[i]
        n = pick(ul[0], *t["glyphs"])
        gh = pick(ul[1], *t["glyph_h"])
        x0 = int(round(t["margin"][1] + col * (col_w + t["column_gap"])))
        x0 += pick(ul[2], 0, int(col_w - n * t["advance"]))
        y0 = t["margin"][0] + row * t["row_pitch"] + (t["row_pitch"] - gh) // 2
        x = x0
        for g in range(n):
            gw = pick(u_glyph[i, g], *t["glyph_w"])
            for s in u_stroke[i, g, :pick(ul[3], 2, 4)]:
                thick, ink = pick(s[0], 2, 4), pick(s[1], 0, 69)
                if s[2] < 0.5:  # horizontal stroke
                    sy = y0 + pick(s[3], 0, gh - thick)
                    sx = x + pick(s[4], 0, gw // 2 - 1)
                    img[sy:sy + thick, sx:x + gw - pick(s[5], 0, gw // 3)] = ink
                else:
                    sx = x + pick(s[3], 0, gw - thick)
                    sy = y0 + pick(s[4], 0, gh // 3 - 1)
                    img[sy:y0 + gh - pick(s[5], 0, gh // 3), sx:sx + thick] = ink
            x_end = x + gw
            x += t["advance"]
        lines.append((x0, y0, x_end, y0 + gh))
    lines = np.asarray(lines, np.int64)
    mh, mw = detector_size(H, W, det["shortest_size"], det["limit_size"])
    sx, sy = mw / W, mh / H
    cores = []
    painted = np.zeros((1, mh, mw), np.uint8)
    for x0, y0, x1, y1 in lines:
        wc, hc = _core_size((x1 - x0 + 4) * sx, (y1 - y0 + 4) * sy, det["unclip_ratio"])
        cx, cy = (x0 + x1) / 2 * sx, (y0 + y1) / 2 * sy
        a, b = int(round(cx - wc / 2)), int(round(cy - hc / 2))
        core = (a, b, a + max(int(round(wc)), 2), b + max(int(round(hc)), 2))
        painted[0, core[1]:core[3] + 1, core[0]:core[2] + 1] = t["paint_value"]
        cores.append(core)
    cores = np.asarray(cores, np.int64)
    _check_apart(cores)
    return Page(img, lines, cores, painted)


def _check_apart(cores):
    """Painted cores must not touch, or the postprocessor joins them."""
    order = np.lexsort((cores[:, 0], cores[:, 1]))
    c = cores[order]
    for i in range(len(c)):
        near = c[(np.abs(c[:, 1] - c[i, 1]) < 64) & (np.arange(len(c)) != i)]
        apart = ((near[:, 0] > c[i, 2] + 1) | (near[:, 2] < c[i, 0] - 1)
                 | (near[:, 1] > c[i, 3] + 1) | (near[:, 3] < c[i, 1] - 1))
        if not apart.all():
            raise ValueError(f"painted line cores touch near {tuple(c[i])}")
