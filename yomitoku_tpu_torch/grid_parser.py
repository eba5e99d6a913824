"""Grid parsing: reconstruct a 2-D table grid from detected cell boxes.

Behavioral contract: reference yomitoku/grid_parser.py, pinned by the
differential fuzz in tests/test_semantic_differential.py and the golden
JSON cases in tests/test_table_semantic_from_json.py.

Pipeline:

1. **lattice** — a digraph over cell/empty/header nodes whose edges are
   the soft-rule adjacency relations (R/L and D/U), computed as two
   vectorized (n, n) matrices in ``utils.adjacency`` instead of O(n^2)
   scalar predicate calls;
2. **unitization** — any node with multiple out-edges in one direction
   is replaced by a stack of bbox slices, one per neighbor, so every
   lattice line becomes a 1:1 chain.  One axis-parametrized splitter
   handles all four directions (the fan-out axis, chain direction, and
   re-attachment rule are table-driven);
3. **tracing** — row lines (R-chains from in-degree-0 heads) are
   intersected with column lines (D-chains) to produce the cell-id
   matrix; spans and indices fall out of each id's extent in the matrix;
4. **headers** — rows whose cells are all header/empty mark the header
   band; per-column header stacks are collected from that band, and
   optionally columns repeating the same terminal header are merged.

The port's copy of ``yomitoku_tpu/grid_parser.py``, line for line.
"""

from collections import deque
from itertools import count

import networkx as nx
import numpy as np

from .schemas.table_semantic_parser import TableGridSchema
from .utils.adjacency import bottom_adjacency_matrix, right_adjacency_matrix
from .utils.misc import get_line_with_head, is_bottom_adjacent, is_right_adjacent
from .utils.union_find import UnionFind

_SOFT = dict(rule="soft", dist_threshold=20, overlap_ratio_th=0.25)
_SOFT_IGN = dict(
    rule="soft", dist_threshold=20, ignore_dist_threshold=10, overlap_ratio_th=0.25
)

# Per fan-out direction: the reverse edge label, the bbox coordinate the
# split runs along, the chain labels linking consecutive slices, and the
# cross labels re-attaching the slice stack's ends to the orthogonal
# neighbors of the original node.
_REV = {"R": "L", "L": "R", "D": "U", "U": "D"}
_SPLIT_AXIS = {"R": 1, "L": 1, "D": 0, "U": 0}
_CHAIN = {"R": ("D", "U"), "L": ("D", "U"), "D": ("R", "L"), "U": ("R", "L")}


def _lattice(nodes):
    """Adjacency digraph over the cluster's cells (reference _get_grid_dag)."""
    cells = nodes["cell"] + nodes["empty"] + nodes["header"]
    dag = nx.DiGraph()
    for cell in cells:
        dag.add_node(cell.id, bbox=cell.box, role=cell.role, contents=cell.contents)
    boxes = [c.box for c in cells]
    down = bottom_adjacency_matrix(boxes, boxes, **_SOFT)
    right = right_adjacency_matrix(boxes, boxes, **_SOFT)
    for i, a in enumerate(cells):
        for j, b in enumerate(cells):
            if a.id == b.id:
                continue
            if down[i, j]:
                dag.add_edge(a.id, b.id, dir="D")
                dag.add_edge(b.id, a.id, dir="U")
            if right[i, j]:
                dag.add_edge(a.id, b.id, dir="R")
                dag.add_edge(b.id, a.id, dir="L")
    return dag


def _partition_span(lo, hi, windows):
    """Repair clipped neighbor windows into a contiguous ordered
    partition of [lo, hi]; zero-width slots borrow 10% of a wide right
    neighbor."""
    bounds = []
    cursor = lo
    for a, b in windows:
        a = max(a, cursor)
        bounds.append([a, max(b, a)])
        cursor = bounds[-1][1]
    if bounds:
        bounds[-1][1] = hi
    for i in range(len(bounds)):
        a, b = bounds[i]
        if b - a <= 1e-3 and i + 1 < len(bounds):
            nxt = bounds[i + 1]
            if nxt[1] - nxt[0] > 2e-3:
                cut = a + (nxt[1] - nxt[0]) * 0.1
                bounds[i][1] = cut
                nxt[0] = cut
    return bounds


def _slice_bbox(G, u, neighbors, axis):
    """Slice u's bbox along ``axis`` (0=x, 1=y) into one window per
    neighbor, windows ordered by neighbor center."""
    bb = G.nodes[u]["bbox"]
    lo, hi = bb[axis], bb[axis + 2]
    ordered = sorted(
        neighbors,
        key=lambda n: (G.nodes[n]["bbox"][axis] + G.nodes[n]["bbox"][axis + 2]) / 2.0,
    )
    windows = [
        (max(lo, G.nodes[n]["bbox"][axis]), min(hi, G.nodes[n]["bbox"][axis + 2]))
        for n in ordered
    ]
    slices = []
    for a, b in _partition_span(lo, hi, windows):
        piece = list(bb)
        piece[axis], piece[axis + 2] = a, b
        slices.append(tuple(piece))
    return slices


def _feeders(G, u, out_dir):
    """Nodes whose ``out_dir`` edge feeds into u — these must be re-aimed
    at the matching slice after a split.  (The U direction scans D
    successors, preserving the reference's asymmetry.)"""
    if out_dir == "U":
        return [v for v in G.successors(u) if G[u][v].get("dir") == "D"]
    return [p for p in G.predecessors(u) if G[p][u].get("dir") == out_dir]


def _feeder_matches(G, bwd, dup, out_dir):
    a, b = G.nodes[bwd]["bbox"], G.nodes[dup]["bbox"]
    if out_dir == "R":
        return is_right_adjacent(a, b, **_SOFT_IGN)
    if out_dir == "L":
        return is_right_adjacent(b, a, **_SOFT_IGN)
    if out_dir == "D":
        return is_bottom_adjacent(a, b, **_SOFT_IGN)
    return is_bottom_adjacent(b, a, **_SOFT_IGN)


def _fanout_split(dag, head, out_dir):
    """Walk ``out_dir`` lines from ``head``, replacing every node with
    >1 out-edge by a chained stack of bbox slices (1:N -> N x 1:1)."""
    G = dag.copy()
    in_dir = _REV[out_dir]
    axis = _SPLIT_AXIS[out_dir]
    chain_fwd, chain_bwd = _CHAIN[out_dir]
    fresh = count(1)
    queue = deque([head])

    while queue:
        u = queue.popleft()
        if u not in G.nodes:
            continue
        outs = [v for v in G.successors(u) if G[u][v].get("dir") == out_dir]
        if len(outs) <= 1:
            queue.extend(outs)
            continue

        feeders = _feeders(G, u, out_dir)
        # the original node's orthogonal neighbors re-attach to the
        # stack's first / last slice
        side_in = [p for p in G.predecessors(u) if G[p][u].get("dir") == chain_fwd]
        side_out = [v for v in G.successors(u) if G[u][v].get("dir") == chain_fwd]

        slices = sorted(_slice_bbox(G, u, outs, axis), key=lambda bb: bb[axis])
        outs = sorted(outs, key=lambda n: G.nodes[n]["bbox"][axis])

        attrs = dict(G.nodes[u])
        dups = []
        for bb in slices:
            name = f"{u}__dup{next(fresh)}"
            G.add_node(name, **{**attrs, "bbox": bb})
            dups.append(name)

        for out, dup in zip(outs, dups):
            G.add_edge(dup, out, dir=out_dir)
            G.add_edge(out, dup, dir=in_dir)
        for p in side_in:
            G.add_edge(dups[0], p, dir=chain_bwd)
            G.add_edge(p, dups[0], dir=chain_fwd)
        for p in side_out:
            G.add_edge(dups[-1], p, dir=chain_fwd)
            G.add_edge(p, dups[-1], dir=chain_bwd)
        for a, b in zip(dups, dups[1:]):
            G.add_edge(a, b, dir=chain_fwd)
            G.add_edge(b, a, dir=chain_bwd)
        for bwd in feeders:
            for dup in dups:
                if _feeder_matches(G, bwd, dup, out_dir):
                    G.add_edge(bwd, dup, dir=out_dir)
                    G.add_edge(dup, bwd, dir=in_dir)
                    queue.append(bwd)
        G.remove_node(u)
        queue.extend(dups)
    return G


def _line_heads(dag, dir_value):
    """Heads of every ``dir_value`` line: per connected component
    (isolates included) the nodes without an incoming edge of that
    direction, or the minimum node id when the component cycles."""
    und = nx.Graph()
    und.add_nodes_from(dag.nodes())
    in_deg = dict.fromkeys(dag.nodes(), 0)
    for u, v, d in dag.edges(data=True):
        if d.get("dir") == dir_value:
            und.add_edge(u, v)
            in_deg[v] += 1
    heads = []
    for comp in nx.connected_components(und):
        roots = sorted(n for n in comp if in_deg[n] == 0)
        heads.extend(roots if roots else [min(comp)])
    return heads


def _unitize(dag):
    """Normalize every direction's lines to 1:1 chains."""
    G = dag
    for out_dir in ("R", "L", "D", "U"):
        H = G.copy()
        for head in _line_heads(H, out_dir):
            H = _fanout_split(H, head, out_dir)
        G = H
    return G


def _trace_grid(dag):
    """Row lines x column lines -> cell-id matrix."""
    row_heads = sorted(_line_heads(dag, "R"), key=lambda n: dag.nodes[n]["bbox"][1])
    col_heads = sorted(_line_heads(dag, "D"), key=lambda n: dag.nodes[n]["bbox"][0])
    col_sets = [set(get_line_with_head(dag, h, "D")) for h in col_heads]
    grid = []
    for rh in row_heads:
        row_line = set(get_line_with_head(dag, rh, "R"))
        row = []
        for cs in col_sets:
            hit = row_line.intersection(cs)
            row.append(next(iter(hit)) if hit else None)
        grid.append(row)
    return grid


def _apply_grid_positions(cells, grid):
    """Write each cell's row/col anchor and span from its extent in the
    id matrix (0-based anchors)."""
    extents = {}
    for r, row in enumerate(grid):
        for c, cid in enumerate(row):
            if cid is None:
                continue
            e = extents.get(cid)
            if e is None:
                extents[cid] = [r, r, c, c]
            else:
                e[0], e[1] = min(e[0], r), max(e[1], r)
                e[2], e[3] = min(e[2], c), max(e[3], c)
    for cid, (r0, r1, c0, c1) in extents.items():
        cell = cells[cid]
        cell.row, cell.col = r0, c0
        cell.row_span, cell.col_span = r1 - r0 + 1, c1 - c0 + 1


def _strip_slice_suffix(grid):
    return [
        [cid.split("__dup")[0] if cid is not None else None for cid in row]
        for row in grid
    ]


def _column_headers(grid, is_header_row, cells, clustered_nodes):
    """Per-column header stacks from the header band; headers that fall
    outside the band are demoted to plain cells."""
    in_band = set()
    col_headers = []
    for col in zip(*grid):
        stack = {
            cid
            for keep, cid in zip(is_header_row, col)
            if keep and cid is not None
        }
        in_band |= stack
        col_headers.append(sorted(stack, key=lambda h: cells[h].box[1]))

    grid_members = {
        cell.id for cluster in clustered_nodes.values() for cell in cluster
    }
    for cell in cells.values():
        if cell.role == "header" and cell.id in grid_members and cell.id not in in_band:
            cell.role = "cell"
    return col_headers


def _grid_bbox(grid, cells):
    ids = {cid for row in grid for cid in row if cid is not None}
    if not ids:
        return (0.0, 0.0, 0.0, 0.0)
    boxes = np.asarray([cells[cid].box for cid in ids], dtype=np.float64)
    return (
        boxes[:, 0].min(), boxes[:, 1].min(), boxes[:, 2].max(), boxes[:, 3].max()
    )


def merge_cells(cell1, cell2):
    """Merge two cells; if one id-set contains the other, keep the larger."""
    ids1, ids2 = set(cell1.id.split("_")), set(cell2.id.split("_"))
    if ids1.issubset(ids2):
        return cell2, False
    if ids2.issubset(ids1):
        return cell1, False
    return type(cell1)(
        id=f"{cell1.id}_{cell2.id}",
        box=(
            min(cell1.box[0], cell2.box[0]),
            min(cell1.box[1], cell2.box[1]),
            max(cell1.box[2], cell2.box[2]),
            max(cell1.box[3], cell2.box[3]),
        ),
        role=cell1.role,
        contents=(cell1.contents + cell2.contents).strip(),
        row=min(cell1.row, cell2.row),
        col=min(cell1.col, cell2.col),
        row_span=cell1.row_span + cell2.row_span,
        col_span=cell1.col_span + cell2.col_span,
    ), True


def _merge_same_column_values(grid, col_headers, cells):
    """Union columns sharing an identical terminal header cell."""
    uf = UnionFind(len(col_headers))
    for c1 in range(len(col_headers)):
        if not col_headers[c1]:
            continue
        for c2 in range(c1 + 1, len(col_headers)):
            if col_headers[c2] and col_headers[c1][-1] == col_headers[c2][-1]:
                uf.union(c1, c2)

    groups = uf.groups()
    new_col_headers = []
    for group in groups:
        merged = [h for c in group for h in col_headers[c]]
        merged = sorted(set(merged), key=lambda h: cells[h].box[1])
        # quirk kept from the reference: the final set() re-wrap discards
        # the sort, leaving hash order
        new_col_headers.append(list(set(merged)))

    new_grid = []
    for row in grid:
        new_row = []
        for group in groups:
            ids = [row[c] for c in group if row[c] is not None]
            if not ids:
                new_row.append(None)
                continue
            acc = cells[ids[0]]
            for cid in ids[1:]:
                acc, _ = merge_cells(acc, cells[cid])
            cells[acc.id] = acc
            new_row.append(acc.id)
        new_grid.append(new_row)

    live = {cid for row in new_grid for cid in row if cid is not None}
    cells = {cid: cell for cid, cell in cells.items() if cid in live}
    return new_grid, new_col_headers, cells


def parse_grid_from_bottom_up(cells, clustered_nodes, merge_same_column_values=False):
    """Cells + role clusters -> (TableGridSchema, cells, dag) or None."""
    dag = _unitize(_lattice(clustered_nodes))
    grid = _trace_grid(dag)
    if len(grid) == 0 or len(grid[0]) == 0:
        return None

    is_header_row = [
        all(
            (dag.nodes[cid]["role"] if cid is not None else "empty")
            in ("header", "empty")
            for cid in row
        )
        for row in grid
    ]

    grid = _strip_slice_suffix(grid)
    grid_box = list(map(int, _grid_bbox(grid, cells)))
    _apply_grid_positions(cells, grid)
    col_headers = _column_headers(grid, is_header_row, cells, clustered_nodes)

    if merge_same_column_values:
        grid, col_headers, cells = _merge_same_column_values(grid, col_headers, cells)

    return (
        TableGridSchema(
            id=None,
            n_row=len(grid),
            n_col=len(grid[0]) if grid else 0,
            box=grid_box,
            data=grid,
            col_headers=col_headers,
        ),
        cells,
        dag,
    )
