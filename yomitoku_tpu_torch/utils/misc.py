"""Geometry and small host utilities (the port's copy of what it calls of
yomitoku_tpu/utils/misc.py): the charset loader, the image writer of the
figure exports, and the box predicates of the layout and table filters and
of DocumentAnalyzer's aggregation, with the same integer-truncation
semantics."""

import os

import cv2
import numpy as np


def load_charset(charset_path):
    with open(charset_path, "r", encoding="utf-8") as f:
        return f.read()


def filter_by_flag(elements, flags):
    if len(elements) != len(flags):
        raise ValueError(f"{len(elements)} elements but {len(flags)} flags")
    return [e for e, keep in zip(elements, flags) if keep]


def save_image(img, path):
    success, buffer = cv2.imencode(".jpg", img)
    basedir = os.path.dirname(path)
    if basedir:
        os.makedirs(basedir, exist_ok=True)
    if not success:
        raise ValueError("Failed to encode image")
    with open(path, "wb") as f:
        f.write(buffer.tobytes())


def calc_intersection(rect_a, rect_b):
    """Integer intersection rectangle of two xyxy rects, or None."""
    ax1, ay1, ax2, ay2 = map(int, rect_a)
    bx1, by1, bx2, by2 = map(int, rect_b)
    ix1, iy1 = max(ax1, bx1), max(ay1, by1)
    ix2, iy2 = min(ax2, bx2), min(ay2, by2)
    if max(0, ix2 - ix1) == 0 or max(0, iy2 - iy1) == 0:
        return None
    return [ix1, iy1, ix2, iy2]


def calc_overlap_ratio(rect_a, rect_b):
    """Fraction of rect_b's area covered by the intersection with rect_a."""
    intersection = calc_intersection(rect_a, rect_b)
    if intersection is None:
        return 0, None
    ix1, iy1, ix2, iy2 = intersection
    bx1, by1, bx2, by2 = rect_b
    b_area = (bx2 - bx1) * (by2 - by1)
    overlap_area = (ix2 - ix1) * (iy2 - iy1)
    return overlap_area / b_area, intersection


def is_contained(rect_a, rect_b, threshold=0.8):
    """True when rect_b is (mostly) inside rect_a — overlap ratio > threshold."""
    ratio, _ = calc_overlap_ratio(rect_a, rect_b)
    return ratio > threshold


def overlap_ratio_matrix(boxes_a, boxes_b):
    """Vectorized pairwise calc_overlap_ratio: (n, 4) x (m, 4) xyxy ->
    (n, m) fraction of b's area covered by a∩b.  Same int-truncation
    semantics as calc_intersection; degenerate intersections/boxes -> 0."""
    a = np.trunc(np.asarray(boxes_a, np.float64)).astype(np.int64)
    b = np.trunc(np.asarray(boxes_b, np.float64)).astype(np.int64)
    if a.size == 0 or b.size == 0:
        return np.zeros((len(a), len(b)), np.float64)
    ix1 = np.maximum(a[:, None, 0], b[None, :, 0])
    iy1 = np.maximum(a[:, None, 1], b[None, :, 1])
    ix2 = np.minimum(a[:, None, 2], b[None, :, 2])
    iy2 = np.minimum(a[:, None, 3], b[None, :, 3])
    iw = np.maximum(0, ix2 - ix1)
    ih = np.maximum(0, iy2 - iy1)
    inter = iw * ih
    # the ratio uses rect_b's un-truncated area, as calc_overlap_ratio does
    bf = np.asarray(boxes_b, np.float64)
    b_area = (bf[:, 2] - bf[:, 0]) * (bf[:, 3] - bf[:, 1])
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = np.where(
            (inter > 0) & (b_area[None, :] > 0),
            inter / b_area[None, :],
            0.0,
        )
    return ratio


def containment_matrix(boxes_a, boxes_b, threshold=0.8):
    """(n, m) bool: is_contained(a_i, b_j) — b_j mostly inside a_i."""
    return overlap_ratio_matrix(boxes_a, boxes_b) > threshold


def quad_to_xyxy(quad):
    xs = [p[0] for p in quad]
    ys = [p[1] for p in quad]
    return min(xs), min(ys), max(xs), max(ys)
