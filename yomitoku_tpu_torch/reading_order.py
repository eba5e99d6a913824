"""Reading-order estimation over layout elements (the port's copy of
yomitoku_tpu/reading_order.py, numpy on the host as there): link every pair
of elements that overlaps across the reading axis — unless a third element
sits strictly between them — directing each edge down (or across) the
page, then emit elements in a parent-gated depth-first sweep seeded by
reading distance.

The O(n^3) "is something in between?" test is two boolean matrix products
over (n, n) interval masks, and edges carry an event index so that
children sort in the order of the pairwise construction loop.  The
emission sweep runs on integer indices with a cursor per node.
"""

import numpy as np


def _interval_overlap(lo, hi):
    """(n, n) pairwise overlap length of 1-D intervals [lo, hi)."""
    return np.maximum(
        0.0,
        np.minimum(hi[:, None], hi[None, :]) - np.maximum(lo[:, None], lo[None, :]),
    )


def _axis_masks(boxes, axis):
    """Pair masks for one reading axis.

    axis="y" (top2bottom): elements pair when their x-extents touch at
    all; axis="x": elements pair when their y-extents overlap by >= half
    the smaller height.  Coordinates are int-truncated like the
    reference's predicates."""
    ib = np.trunc(boxes)
    if axis == "y":
        paired = _interval_overlap(ib[:, 0], ib[:, 2]) != 0
    else:
        ov = _interval_overlap(ib[:, 1], ib[:, 3])
        heights = ib[:, 3] - ib[:, 1]
        least = np.minimum(heights[:, None], heights[None, :])
        with np.errstate(divide="ignore", invalid="ignore"):
            frac = ov / least
        paired = frac >= 0.5
    return paired


def _blocked_pairs(paired, lo, hi):
    """blocked[i, j]: some third element k (paired with i) lies strictly
    between i and j along the reading coordinate — k's whole [lo, hi]
    interval beyond i's hi and before j's lo, or the mirror.

    Factored as boolean matrix products: between1 = any_k A[k,i] & B[k,j]
    with A tying k to i's far side and B tying k to j's near side."""
    n = len(lo)
    k_lo, k_hi = lo[:, None], hi[:, None]
    A1 = paired & (k_lo > hi[None, :]) & (k_hi > hi[None, :])  # k beyond i
    B1 = (k_lo < lo[None, :]) & (k_hi < lo[None, :])  # k before j
    A2 = paired & (k_lo < lo[None, :]) & (k_hi < lo[None, :])  # k before i
    B2 = (k_lo > hi[None, :]) & (k_hi > hi[None, :])  # k beyond j
    idx = np.arange(n)
    for m in (A1, B1, A2, B2):
        m[idx, idx] = False
    # int32 accumulation: a uint8 product wraps mod 256, which would
    # zero a true blocked[i, j] once a pair shares exactly 256 blockers
    blocked = (A1.T.astype(np.int32) @ B1.astype(np.int32)) > 0
    blocked |= (A2.T.astype(np.int32) @ B2.astype(np.int32)) > 0
    return blocked


def _build_edges(boxes, direction):
    """Edge matrix, per-edge event index, seed distances, and sort keys.

    Every ordered pair (i, j) is an "event" with index i*n+j, mirroring
    the reference's nested construction loop; an edge's event index is
    the earliest event that creates it, and children later sort stably
    by (coordinate key, event index)."""
    n = len(boxes)
    x1, y1, x2, y2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]

    if direction == "top2bottom":
        paired = _axis_masks(boxes, "y")
        blocked = _blocked_pairs(paired, y1, y2)
        # event (i, j) emits i->j when i starts higher, else j->i
        fwd = y1[:, None] < y1[None, :]
        seed = x1 + y1
        child_key, adopt_key = x1, x1
    elif direction == "right2left":
        paired = _axis_masks(boxes, "x")
        blocked = _blocked_pairs(paired, x1, x2)
        # flow right-to-left: event (i, j) emits i->j unless i ends
        # left of j
        fwd = x2[:, None] >= x2[None, :]
        seed = (x2.max() - x2) + y1
        child_key, adopt_key = y1, y1
    elif direction == "left2right":
        paired = _axis_masks(boxes, "x")
        blocked = _blocked_pairs(paired, x1, x2)
        fwd = x2[None, :] >= x2[:, None]
        seed = x1 + y1 * 5
        child_key, adopt_key = y1, y1
    else:
        raise ValueError(f"Invalid direction: {direction}")

    idx = np.arange(n)
    live = paired & ~blocked
    live[idx, idx] = False

    # edge u->v materializes from event (u, v) when fwd, or from the
    # mirrored event (v, u) when that event's else-branch points back.
    by_fwd = live & fwd
    by_mirror = (live & ~fwd).T
    edges = by_fwd | by_mirror

    event = idx[:, None] * n + idx[None, :]
    times = np.where(by_fwd, event, np.iinfo(np.int64).max)
    times = np.minimum(times, np.where(by_mirror, event.T, np.iinfo(np.int64).max))
    return edges, times, seed, child_key, adopt_key


def _emit(edges, times, seed, child_key, adopt_key):
    """Parent-gated DFS emission (reference _priority_dfs semantics)."""
    n = len(seed)
    kids = [
        sorted(np.flatnonzero(edges[u]), key=lambda v: (child_key[v], times[u, v]))
        for u in range(n)
    ]
    parents = [np.flatnonzero(edges[:, v]) for v in range(n)]

    cursor = [0] * n
    visited = np.zeros(n, dtype=bool)
    emitted = []
    pending = list(np.argsort(seed, kind="stable"))
    stack = [pending.pop(0)]
    deferred = []  # nodes waiting on unvisited parents

    while len(emitted) < n:
        while stack:
            freed = False
            cur = stack.pop()
            if not visited[cur]:
                if visited[parents[cur]].all():
                    visited[cur] = True
                    emitted.append(cur)
                    freed = True
                elif cur not in deferred:
                    deferred.append(cur)
            if freed:
                # retry the whole deferral list, oldest on top
                while deferred:
                    stack.append(deferred.pop())

            if cursor[cur] < len(kids[cur]):
                stack.append(cur)
                stack.append(kids[cur][cursor[cur]])
                cursor[cur] += 1
            else:
                # adopt stack residents fed by cur and replay them in
                # reading order (largest key deepest).  The index walk
                # mirrors CPython list-iterator semantics under removal.
                adopted = []
                i = 0
                while i < len(stack):
                    x = stack[i]
                    if edges[cur, x]:
                        adopted.append(x)
                        stack.remove(x)
                    i += 1
                adopted.sort(key=lambda v: adopt_key[v], reverse=True)
                stack.extend(adopted)

        for i, cand in enumerate(pending):
            if cand not in deferred:
                stack.append(pending.pop(i))
                break
        else:
            if len(emitted) < n and deferred:
                forced = deferred.pop(0)  # break edge cycles
                visited[forced] = True
                emitted.append(forced)
    return emitted


def prediction_reading_order(elements, direction, img=None):
    if len(elements) < 2:
        return elements
    boxes = np.asarray([e.box for e in elements], dtype=np.float64)
    order = _emit(*_build_edges(boxes, direction))
    for rank, element_idx in enumerate(order):
        elements[element_idx].order = rank
    return elements
