"""Geometry and small host utilities (the port's copy of what it calls of
yomitoku_tpu/utils/misc.py): the charset loader, the image writer of the
figure exports, the box predicates of the layout and table filters and of
DocumentAnalyzer's aggregation, with the same integer-truncation
semantics, and the scalar adjacency views and lattice walk of the table
semantics (``utils.adjacency`` holds the matrix forms)."""

import math
import os
from collections import deque

import cv2
import numpy as np

from .adjacency import bottom_adjacency_matrix, right_adjacency_matrix


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


def calc_iou(rect_a, rect_b):
    intersection = calc_intersection(rect_a, rect_b)
    if intersection is None:
        return 0
    ix1, iy1, ix2, iy2 = intersection
    ax1, ay1, ax2, ay2 = rect_a
    bx1, by1, bx2, by2 = rect_b
    inter = (ix2 - ix1) * (iy2 - iy1)
    a_area = (ax2 - ax1) * (ay2 - ay1)
    b_area = (bx2 - bx1) * (by2 - by1)
    return inter / (a_area + b_area - inter)


def is_intersected_horizontal(rect_a, rect_b, threshold=0.5):
    """Vertical-interval overlap >= threshold * min height."""
    _, ay1, _, ay2 = map(int, rect_a)
    _, by1, _, by2 = map(int, rect_b)
    overlap = max(0, min(ay2, by2) - max(ay1, by1))
    min_height = min(ay2 - ay1, by2 - by1)
    return (overlap / min_height) >= threshold


def is_intersected_vertical(rect_a, rect_b):
    """Any horizontal-interval overlap at all."""
    ax1, _, ax2, _ = map(int, rect_a)
    bx1, _, bx2, _ = map(int, rect_b)
    return max(0, min(ax2, bx2) - max(ax1, bx1)) != 0


def convert_table_array(table):
    """TableStructure -> 2-D array of cell contents (1-indexed rows/cols)."""
    arr = [["" for _ in range(table.n_col)] for _ in range(table.n_row)]
    for cell in table.cells:
        r0, c0 = cell.row - 1, cell.col - 1
        for i in range(r0, r0 + cell.row_span):
            for j in range(c0, c0 + cell.col_span):
                arr[i][j] = cell.contents
    return arr


def convert_table_array_to_dict(table_array, header_row=1):
    n_rows = len(table_array)
    n_cols = len(table_array[0])
    header_cols = []
    for i in range(n_cols):
        header = [table_array[j][i] for j in range(header_row)]
        header_cols.append("_".join(header) if header else f"col_{i}")
    out = []
    for i in range(header_row, n_rows):
        out.append({header_cols[j]: table_array[i][j] for j in range(n_cols)})
    return out


def clamp(t, lo, hi):
    return max(lo, min(hi, t))


def point_distance(p, q):
    return math.hypot(p[0] - q[0], p[1] - q[1])


def is_right_adjacent(box_a, box_b, dist_threshold=15, overlap_ratio_th=0.1,
                      ignore_dist_threshold=10, rule="soft"):
    """Scalar view of ``adjacency.right_adjacency_matrix`` — is box_b the
    right-neighbor of box_a?  Rules: "soft" allows 1:1/1:N/N:1/N:M joins,
    "hard" only 1:1, "nest" only the child-side corner condition."""
    return bool(
        right_adjacency_matrix(
            [box_a], [box_b], dist_threshold=dist_threshold,
            overlap_ratio_th=overlap_ratio_th,
            ignore_dist_threshold=ignore_dist_threshold, rule=rule,
        )[0, 0]
    )


def is_bottom_adjacent(box_a, box_b, dist_threshold=15, overlap_ratio_th=0.1,
                       ignore_dist_threshold=10, rule="soft"):
    """Scalar view of ``adjacency.bottom_adjacency_matrix`` — is box_b the
    bottom-neighbor of box_a?"""
    return bool(
        bottom_adjacency_matrix(
            [box_a], [box_b], dist_threshold=dist_threshold,
            overlap_ratio_th=overlap_ratio_th,
            ignore_dist_threshold=ignore_dist_threshold, rule=rule,
        )[0, 0]
    )


def get_line_with_head(dag, head, dir_value: str):
    """BFS over a networkx DiGraph from ``head`` following edges tagged
    dir == dir_value."""
    line_nodes = []
    queue = deque([head])
    while queue:
        u = queue.popleft()
        if u not in dag.nodes:
            continue
        line_nodes.append(u)
        for v in dag.successors(u):
            if dag[u][v].get("dir") == dir_value:
                queue.append(v)
    return line_nodes
