"""Key-value parsing of non-grid table regions.

Behavioral contract: reference yomitoku/kv_parser.py, pinned by the
differential fuzz in tests/test_semantic_differential.py.

Flow: every cell/header is claimed by its best-overlap group box (or a
shared pseudo-group); a relation digraph links header->cell,
header->header, and cell->cell pairs that are right-/bottom-adjacent and
group-compatible; per weakly-connected component, key paths are walked
from root headers twice — once following only R edges, once only D — and
the direction yielding more distinct value leaves wins; cells no walk
reached become keyless items.

The group claims and pair adjacencies are computed as overlap/adjacency
matrices (utils.misc.overlap_ratio_matrix / utils.adjacency) rather than
per-pair scalar predicates.

The port's copy of ``yomitoku_tpu/kv_parser.py``, line for line.
"""

import networkx as nx
import numpy as np

from .schemas.table_semantic_parser import KvItemSchema
from .utils.adjacency import bottom_adjacency_matrix, right_adjacency_matrix
from .utils.misc import overlap_ratio_matrix

PSEUDO_GROUP_ID = "__unmatched__"


def _claim_groups(items, groups):
    """id -> group id for every item claimed by a group: the group must
    cover >20% of the item, and among those the item keeps the group it
    covers the largest fraction of (first win on ties)."""
    if not items or not groups:
        return {}
    gboxes = [g.box for g in groups]
    iboxes = [i.box for i in items]
    covers_item = overlap_ratio_matrix(gboxes, iboxes)  # (G, N)
    covers_group = overlap_ratio_matrix(iboxes, gboxes)  # (N, G)
    claims = {}
    for n, item in enumerate(items):
        score = np.where(covers_item[:, n] > 0.2, covers_group[n], -1.0)
        g = int(score.argmax())
        if score[g] > 0:
            claims[item.id] = groups[g].id
    return claims


def get_kv_items_dag(nodes, groups):
    """Relation digraph over header/cell/empty nodes; edges carry dir
    R/L/D/U and only link group-compatible pairs."""
    headers = nodes["header"]
    values = nodes["cell"] + nodes["empty"]
    value_group = _claim_groups(values, groups)
    header_group = _claim_groups(headers, groups)
    if groups:
        for v in values:
            value_group.setdefault(v.id, PSEUDO_GROUP_ID)
        for h in headers:
            header_group.setdefault(h.id, PSEUDO_GROUP_ID)

    everyone = headers + nodes["cell"] + nodes["empty"]
    dag = nx.DiGraph()
    for n in everyone:
        dag.add_node(n.id, id=n.id, bbox=n.box, role=n.role, contents=n.contents)

    boxes = [n.box for n in everyone]
    right = right_adjacency_matrix(boxes, boxes)
    down = bottom_adjacency_matrix(boxes, boxes)
    pos = {n.id: i for i, n in enumerate(everyone)}

    def _link(a, b):
        i, j = pos[a.id], pos[b.id]
        if right[i, j]:
            dag.add_edge(a.id, b.id, dir="R")
            dag.add_edge(b.id, a.id, dir="L")
        if down[i, j]:
            dag.add_edge(a.id, b.id, dir="D")
            dag.add_edge(b.id, a.id, dir="U")

    # header -> value within the same group (cells first, then empties)
    for pool in (nodes["cell"], nodes["empty"]):
        for h in headers:
            hg = header_group.get(h.id)
            if hg is None:
                continue
            for v in pool:
                if value_group.get(v.id) == hg:
                    _link(h, v)

    # header -> header: same group, or either side unclaimed
    for node in headers:
        ng = header_group.get(node.id)
        for parent in headers:
            if node.id == parent.id:
                continue
            pg = header_group.get(parent.id)
            if pg is None or ng is None:
                continue
            if pg != ng and PSEUDO_GROUP_ID not in (pg, ng):
                continue
            _link(parent, node)

    # cell -> cell within the same group
    for node in nodes["cell"]:
        ng = value_group.get(node.id)
        if ng is None:
            continue
        for parent in nodes["cell"]:
            if node.id != parent.id and value_group.get(parent.id) == ng:
                _link(parent, node)
    return dag


def _root_headers(dag, direction, node_set):
    """Headers in the component with no ``direction`` in-edge from
    another component header."""
    roots = []
    for h in node_set:
        if dag.nodes[h]["role"] != "header":
            continue
        fed = any(
            u in node_set
            and dag.nodes[u]["role"] == "header"
            and dag[u][h].get("dir") == direction
            for u in dag.predecessors(h)
        )
        if not fed:
            roots.append(h)
    return roots


def _span_boxes(box_a, box_b):
    return [
        min(box_a[0], box_b[0]), min(box_a[1], box_b[1]),
        max(box_a[2], box_b[2]), max(box_a[3], box_b[3]),
    ]


def _walk(dag, node_id, key_path, direction, cells, items, touched):
    """Preorder key-path walk: headers extend the path, values emit an
    item keyed by the path so far."""
    if dag.nodes[node_id]["role"] in ("cell", "empty"):
        box = (
            _span_boxes(cells[node_id].box, cells[key_path[0]].box)
            if key_path
            else cells[node_id].box
        )
        items.append(
            KvItemSchema(id=None, key=list(key_path), value=node_id, box=box)
        )
        touched[node_id] = cells[node_id]
        for k in key_path:
            touched[k] = cells[k]
        return
    key_path = key_path + [node_id]
    for nxt in dag.successors(node_id):
        if nxt not in key_path and dag[node_id][nxt].get("dir") == direction:
            _walk(dag, nxt, key_path, direction, cells, items, touched)


def parse_kv_items(clustered_nodes, nodes, cells):
    """Per weak component, keep the walk direction (R vs D) that reaches
    more distinct value leaves; unreached values become keyless items."""
    dag = get_kv_items_dag(clustered_nodes, nodes["group"])
    kv_items = []
    kv_cells = {}

    for component in nx.weakly_connected_components(dag):
        node_set = set(component)
        candidates = {}
        for direction in ("R", "D"):
            items, touched = [], {}
            for root in _root_headers(dag, direction, node_set):
                _walk(dag, root, [], direction, cells, items, touched)
            candidates[direction] = (items, touched)

        h_leaves = len({kv.value for kv in candidates["R"][0]})
        v_leaves = len({kv.value for kv in candidates["D"][0]})
        winner = "D" if v_leaves > h_leaves else "R"
        items, touched = candidates[winner]
        kv_items.extend(items)
        kv_cells.update(touched)

        loser_dirs = ("R", "L") if winner == "D" else ("D", "U")
        dag.remove_edges_from([
            (u, v)
            for u, v, d in dag.edges(node_set, data=True)
            if v in node_set and d.get("dir") in loser_dirs
        ])

    reached = {kv.value for kv in kv_items}
    for cell in clustered_nodes["cell"] + clustered_nodes["empty"]:
        if cell.id not in reached:
            kv_items.append(
                KvItemSchema(id=None, key=[], value=cell.id, box=cell.box)
            )
            kv_cells[cell.id] = cells[cell.id]
    return kv_items, dag, kv_cells
