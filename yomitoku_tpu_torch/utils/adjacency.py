"""Vectorized box-adjacency kernels for the table-semantic layer.

Behavioral contract: reference ``yomitoku/utils/misc.py:299`` /
``:356`` (``is_right_adjacent`` / ``is_bottom_adjacent``) — pinned by the
differential fuzz tests in ``tests/test_semantic_differential.py``.

The formulation here is different from (and much faster than) the
reference's scalar predicates: both directions are served by ONE core in
a canonical "A flows into B along +x" frame; bottom-adjacency is
right-adjacency with the x/y axes swapped.  All pair predicates are
computed as (n, m) numpy matrices in a handful of broadcast ops, so DAG
construction over hundreds of table cells costs microseconds instead of
the reference's O(n^2) Python predicate calls.

Geometry of the canonical frame, evaluated for every (a, b) pair at once:

* gate 1   — b must start at or beyond a's leading edge (bx1 >= ax1);
* gate 2   — the transverse intervals must overlap by at least
             ``overlap_ratio_th`` of the smaller extent;
* gate 3   — the two "diagonal touch" corner pairs must not be within
             ``ignore_dist_threshold`` (kills corner-only contact);
* distance — corner-to-edge distances between a's trailing edge and b's
             leading edge, folded into the reference's four max-pairs,
             then thresholded per rule (soft / hard / nest / child).

Axis-aligned point-to-segment distance reduces to a clip: the nearest
point of a vertical segment to (px, py) is (sx, clip(py)).

The port's copy of ``yomitoku_tpu/utils/adjacency.py``, line for line.
"""

import numpy as np

_RULES = ("soft", "hard", "nest", "child")


def _as_xyxy(boxes):
    arr = np.asarray(boxes, dtype=np.float64)
    if arr.size == 0:
        return arr.reshape(0, 4)
    return arr.reshape(-1, 4)


def _directed_adjacency(a, b, rule, dist_threshold, overlap_ratio_th,
                        ignore_dist_threshold):
    """(n, m) adjacency in the canonical +x frame. ``a``/``b`` are (n, 4)
    and (m, 4) float64 xyxy arrays."""
    n, m = len(a), len(b)
    if n == 0 or m == 0:
        return np.zeros((n, m), dtype=bool)

    ax1, ay1 = a[:, 0, None], a[:, 1, None]
    ax2, ay2 = a[:, 2, None], a[:, 3, None]
    bx1, by1 = b[None, :, 0], b[None, :, 1]
    bx2, by2 = b[None, :, 2], b[None, :, 3]

    # gate 1: direction.
    ok = bx1 >= ax1

    # gate 2: transverse overlap vs the smaller extent.
    span = np.maximum(0.0, np.minimum(ay2, by2) - np.maximum(ay1, by1))
    least = np.minimum(ay2 - ay1, by2 - by1)
    ok &= span >= overlap_ratio_th * least

    # gate 3: diagonal corner contact is not adjacency.
    ok &= np.hypot(ax2 - bx1, ay2 - by1) >= ignore_dist_threshold
    ok &= np.hypot(ax2 - bx1, ay1 - by2) >= ignore_dist_threshold

    if rule == "hard":
        # 1:1 joins: both leading-corner pairs must line up.
        ok &= np.hypot(ax2 - bx1, ay1 - by1) < dist_threshold
        ok &= np.hypot(ax2 - bx1, ay2 - by2) < dist_threshold
        return ok

    # Corner-to-opposite-edge distances.  d1/d2: a's trailing corners to
    # b's leading edge; d3/d4: b's leading corners to a's trailing edge.
    gap = ax2 - bx1
    d1 = np.hypot(gap, ay1 - np.clip(ay1, np.minimum(by1, by2), np.maximum(by1, by2)))
    d2 = np.hypot(gap, ay2 - np.clip(ay2, np.minimum(by1, by2), np.maximum(by1, by2)))
    d3 = np.hypot(gap, by1 - np.clip(by1, np.minimum(ay1, ay2), np.maximum(ay1, ay2)))
    d4 = np.hypot(gap, by2 - np.clip(by2, np.minimum(ay1, ay2), np.maximum(ay1, ay2)))

    # The reference folds these into four max-pairs before thresholding.
    e_nest = np.maximum(d3, d4)
    if rule == "nest":
        return ok & (e_nest < dist_threshold)
    if rule == "soft":
        near = (
            (np.maximum(d1, d4) < dist_threshold)
            | (np.maximum(d2, d3) < dist_threshold)
            | (e_nest < dist_threshold)
            | (np.maximum(d1, d2) < dist_threshold)
        )
        return ok & near
    if rule == "child":
        # nested-child joins only; explicit 1:1 joins are excluded.
        hard = (np.hypot(ax2 - bx1, ay1 - by1) < dist_threshold) & (
            np.hypot(ax2 - bx1, ay2 - by2) < dist_threshold
        )
        return ok & ~hard & (e_nest < dist_threshold)
    raise ValueError(f"unknown adjacency rule: {rule!r}")


def right_adjacency_matrix(boxes_a, boxes_b, dist_threshold=15,
                           overlap_ratio_th=0.1, ignore_dist_threshold=10,
                           rule="soft"):
    """(n, m) bool: is ``boxes_b[j]`` the right-neighbor of ``boxes_a[i]``?

    Matches reference ``is_right_adjacent`` pairwise (which has no
    "child" rule on the horizontal axis — it yields no matches there).
    """
    a, b = _as_xyxy(boxes_a), _as_xyxy(boxes_b)
    if rule == "child":
        return np.zeros((len(a), len(b)), dtype=bool)
    return _directed_adjacency(
        a, b, rule, dist_threshold, overlap_ratio_th, ignore_dist_threshold
    )


def bottom_adjacency_matrix(boxes_a, boxes_b, dist_threshold=15,
                            overlap_ratio_th=0.1, ignore_dist_threshold=10,
                            rule="soft"):
    """(n, m) bool: is ``boxes_b[j]`` the bottom-neighbor of ``boxes_a[i]``?

    Bottom-adjacency is right-adjacency in the transposed plane.
    """
    a, b = _as_xyxy(boxes_a), _as_xyxy(boxes_b)
    swap = [1, 0, 3, 2]
    return _directed_adjacency(
        a[:, swap] if len(a) else a, b[:, swap] if len(b) else b,
        rule, dist_threshold, overlap_ratio_th, ignore_dist_threshold,
    )
