"""TableSemanticParser: tables -> semantic grids and key-value items (the
port's copy of yomitoku_tpu/table_semantic_parser.py).

The detector and the layout parser over one page, the CellDetector on the
layout's table boxes, tables with fewer than two real cells demoted to
paragraphs, recognition; then on the host: OCR words assigned to the cell
they overlap most, each table's nodes split by role and clustered as the
weakly connected components of an adjacency DAG, clusters with at least
two rows and two columns of hard adjacency parsed as grids
(``grid_parser``), the others as key-value items (``kv_parser``), ids
assigned (``t{i}``, ``g{i}``, ``kv{i}``, ``c{i}``, ``p{i}``) and a
template applied where one is given.

``run_models`` takes the JAX package's routes.  Where device crops are
on for the detector's device (CUDA, by default) the page is uploaded
once, as one DevicePage.  Where the detector, the layout parser and the
cell detector all lie on that page's device and
YOMITOKU_TPU_NO_FUSED_PAGE is unset, the page takes the fused page
program (ops/fused_page.py, with the cell detector in the region slot;
the CUDA default, as the JAX package's is on an accelerator): one
readback for the detector, the layout and the cell detector on up to
four tables the device selects, then on the host the layout filter, the
slots' matching, the chunked region route for the tables the slots
missed (overlapped with the contours), and the cell postprocess while
the recognizer runs on a side pool of eight threads kept for the
parser's life.  Everywhere else the unfused route runs, each module on
another device than the page uploading its own.  ``num_devices`` goes to
every module (one replica of each model per device where two or more
take part, ``parallel/``); above 1, ``batch`` takes the page axis on the
fused route (``_batch_dp_fused``: chunks of pages through
``FusedPageAnalysis.batch_call``), as the JAX package's does.  Neither the
page nor the image is kept on the parser, so ``batch`` may run
``__call__`` on several threads; the fused program is built once, under a
lock.

One deliberate difference: the detector and the layout parser (on the
fused route: the program's two legs) run on two worker threads that the
parser keeps for its lifetime, where the JAX package makes a pool of two
for each page.  PyTorch keeps cuDNN's
convolution plans per thread, so on a new thread every convolution of
DBNet and RT-DETRv2 is planned again (DocumentAnalyzer keeps its two
workers for the same reason).
"""

import asyncio
import os
import threading
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor

import cv2
import networkx as nx
import numpy as np

from .data.functions import shortest_edge_size
from .grid_parser import parse_grid_from_bottom_up
from .kv_parser import parse_kv_items
from .layout_parser import LayoutParser
from .ocr import ocr_aggregate
from .ops.device_crop import (
    DevicePage,
    collect_filtered_regions,
    device_crops_enabled,
    dispatch_regions_from_page,
    lies_on,
)
from .ops.fused_page import FusedPageAnalysis, dp_chunk_pages, run_page_chunks
from .parallel import dp_mesh
from .parallel.runner import KeptPools, same_device
from .reading_order import prediction_reading_order
from .schemas import (
    Element,
    LayoutParserSchema,
    OCRSchema,
    ParagraphSchema,
    TableCellSchema,
    TextDetectorSchema,
)
from .schemas.table_semantic_parser import (
    CellSchema,
    TableDetectorSchema,
    TableSemanticContentsSchema,
    TableSemanticParserSchema,
)
from .table_cell_detector import CellDetector
from .text_detector import TextDetector
from .text_recognizer import TextRecognizer
from .utils.adjacency import bottom_adjacency_matrix, right_adjacency_matrix
from .utils.logger import set_logger
from .utils.misc import overlap_ratio_matrix, quad_to_xyxy
from .utils.stagetrace import segment
from .utils.union_find import UnionFind

logger = set_logger(__name__, "INFO")


def _split_nodes_with_role(cells):
    nodes = {"header": [], "group": [], "cell": [], "empty": []}
    for cell in cells:
        nodes.setdefault(cell.role, []).append(cell)
    return nodes


def get_cell_by_id(cells, cell_id):
    for cell in cells:
        if cell.id == cell_id:
            return cell
    return None


def _get_cluster_nodes(clusters, nodes):
    clustered_nodes_list = []
    pool = nodes["header"] + nodes["cell"] + nodes["empty"]
    for cluster in clusters:
        clustered = {"header": [], "cell": [], "empty": []}
        for node_id in cluster:
            node = get_cell_by_id(pool, node_id)
            clustered[node.role].append(node)
        clustered_nodes_list.append(clustered)
    return clustered_nodes_list


def _prune_solo_nest_edges(dag):
    """A node's lone "nest" out-edge is 1:1 vertical noise — drop it;
    surviving nest edges become plain D links."""
    for u in dag.nodes():
        nests = [v for v in dag.successors(u) if dag[u][v].get("dir") == "nest"]
        if len(nests) == 1:
            dag.remove_edge(u, nests[0])
    for _, _, d in dag.edges(data=True):
        if d.get("dir") == "nest":
            d["dir"] = "D"


def _weakly_cluster_nodes_with_graph(nodes):
    """Heuristic proximity DAG + weakly-connected clustering.

    All pair rules are evaluated as adjacency matrices (one vectorized
    call per rule) and only the edge insertion walks pairs in order."""
    headers = nodes["header"]
    values = nodes["cell"] + nodes["empty"]
    empties = nodes["empty"]
    h_boxes = [h.box for h in headers]
    v_boxes = [v.box for v in values]
    e_boxes = [e.box for e in empties]

    dag = nx.DiGraph()
    for role in ("header", "cell", "empty"):
        for node in nodes[role]:
            dag.add_node(node.id, bbox=node.box, role=node.role)

    hv_nest = bottom_adjacency_matrix(h_boxes, v_boxes, rule="nest")
    hv_soft = right_adjacency_matrix(h_boxes, v_boxes, rule="soft")
    hh_soft = right_adjacency_matrix(h_boxes, h_boxes, rule="soft")
    hh_child = bottom_adjacency_matrix(h_boxes, h_boxes, rule="child")
    for i, header in enumerate(headers):
        for j, cell in enumerate(values):
            if hv_nest[i, j] or hv_soft[i, j]:
                dag.add_edge(header.id, cell.id, dir="D")
        for j, other in enumerate(headers):
            if header.id == other.id:
                continue
            if hh_soft[i, j]:
                dag.add_edge(header.id, other.id, dir="D")
            if hh_child[i, j]:
                dag.add_edge(header.id, other.id, dir="nest")

    _prune_solo_nest_edges(dag)

    vv_soft = right_adjacency_matrix(v_boxes, v_boxes, rule="soft")
    vv_hard = bottom_adjacency_matrix(v_boxes, v_boxes, rule="hard")
    for i, a in enumerate(values):
        for j, b in enumerate(values):
            if a.id != b.id and (vv_soft[i, j] or vv_hard[i, j]):
                dag.add_edge(a.id, b.id, dir="D")

    eh_hard_d = bottom_adjacency_matrix(e_boxes, h_boxes, rule="hard")
    eh_hard_r = right_adjacency_matrix(e_boxes, h_boxes, rule="hard")
    for i, empty in enumerate(empties):
        for j, header in enumerate(headers):
            if eh_hard_d[i, j] or eh_hard_r[i, j]:
                dag.add_edge(empty.id, header.id, dir="D")

    return list(nx.weakly_connected_components(dag)), dag


def _linked_component_count(cells, adj):
    """Connected components of the undirected graph induced by the true
    entries of ``adj`` — isolated cells don't count."""
    pairs = np.argwhere(adj)
    if pairs.size == 0:
        return 0
    uf = UnionFind(len(cells))
    touched = set()
    for i, j in pairs:
        uf.union(int(i), int(j))
        touched.add(int(i))
        touched.add(int(j))
    return len({uf.find(i) for i in touched})


def is_grid_cluster(nodes):
    """Grid = the cluster's hard-adjacency relation splits into >=2 row
    lines and >=2 column lines."""
    cells = nodes["cell"] + nodes["empty"]
    boxes = [c.box for c in cells]
    ids = np.asarray([c.id for c in cells])
    distinct = ids[:, None] != ids[None, :] if len(cells) else np.zeros((0, 0), bool)
    hard_v = bottom_adjacency_matrix(boxes, boxes, rule="hard") & distinct
    hard_h = right_adjacency_matrix(boxes, boxes, rule="hard") & distinct
    return (
        _linked_component_count(cells, hard_h) > 1
        and _linked_component_count(cells, hard_v) > 1
    )


def sort_cells(cells, offset=0):
    """Reading-order-ish cell sort + id remap (reference :309)."""
    cells = list(cells)
    if len(cells) == 0:
        return cells, {}
    min_height = min(cell.box[3] - cell.box[1] for cell in cells)
    values = [c for c in cells if c.role in ("cell", "header", "empty")]
    groups = [c for c in cells if c.role == "group"]
    values = sorted(values, key=lambda x: (x.box[1] // min_height, x.box[0]))
    groups = sorted(groups, key=lambda x: (x.box[1], x.box[0]))
    cells = values + groups

    remap_ids = {}
    for i, cell in enumerate(cells):
        new_id = f"c{i + offset}"
        remap_ids[cell.id] = new_id
        cell.id = new_id
    return cells, remap_ids


def _sort_elements(elements, prefix="t"):
    if len(elements) == 0:
        return elements
    min_height = min(elem.box[3] - elem.box[1] for elem in elements)
    elements = sorted(elements, key=lambda x: (x.box[1] // min_height, x.box[0]))
    for i, elem in enumerate(elements):
        elem.id = f"{prefix}{i}"
    return elements


def _assign_ids(table_information, cell_offset=0):
    """Reference :345."""
    for i, grid in enumerate(table_information["grids"]):
        grid.id = f"g{i}"
    for i, kv in enumerate(table_information["kv_items"]):
        kv.id = f"kv{i}"

    cells, remap_ids = sort_cells(
        table_information["cells"].values(), offset=cell_offset
    )
    table_information["cells"] = {cell.id: cell for cell in cells}

    for kv in table_information["kv_items"]:
        kv.key = [remap_ids[k] for k in kv.key]
        kv.value = remap_ids[kv.value]

    for grid in table_information["grids"]:
        grid.data = [
            [remap_ids[cid] if cid is not None else None for cid in row]
            for row in grid.data
        ]
        grid.col_headers = [
            [remap_ids[ck] if ck is not None else None for ck in header]
            for header in grid.col_headers
        ]
    return cell_offset + len(cells)


def dag_visualizer(dag, img):
    for u, v, attrs in dag.edges(data=True):
        if attrs["dir"] in ("L", "U"):
            continue
        cx1 = (dag.nodes[u]["bbox"][0] + dag.nodes[u]["bbox"][2]) / 2
        cy1 = (dag.nodes[u]["bbox"][1] + dag.nodes[u]["bbox"][3]) / 2
        cx2 = (dag.nodes[v]["bbox"][0] + dag.nodes[v]["bbox"][2]) / 2
        cy2 = (dag.nodes[v]["bbox"][1] + dag.nodes[v]["bbox"][3]) / 2
        color = (0, 255, 0) if attrs["dir"] == "R" else (255, 0, 0)
        img = cv2.arrowedLine(
            img, (int(cx1), int(cy1)), (int(cx2), int(cy2)), color, 2
        )
    return img


def _layout_visualizer(results, img, prefix="Element"):
    vis = img.copy()
    for paragraph in results:
        box = paragraph.box
        cv2.rectangle(vis, (box[0], box[1]), (box[2], box[3]), (0, 255, 0), 2)
        cv2.putText(
            vis,
            f"{prefix}: {paragraph.id}",
            (box[0], box[1] - 10),
            cv2.FONT_HERSHEY_SIMPLEX,
            0.8,
            (255, 0, 0),
            2,
        )
    return vis


def _ocr_visualizer(img, outputs, font_path, font_size=12, font_color=(255, 0, 0)):
    from PIL import Image, ImageDraw, ImageFont, features

    out = img.copy()
    pillow_img = Image.fromarray(out)
    draw = ImageDraw.Draw(pillow_img)
    has_raqm = features.check_feature(feature="raqm")
    font = ImageFont.truetype(font_path, font_size)
    for word in outputs.words:
        quad = np.array(word.points).astype(np.int32)
        draw.polygon([tuple(p) for p in quad], outline=(0, 255, 0), fill=None)
        if word.direction == "horizontal" or not has_raqm:
            draw.text(
                (quad[0][0], quad[0][1] - font_size),
                word.content, font=font, fill=font_color,
            )
        else:
            draw.text(
                (quad[0][0] - font_size, quad[0][1]),
                word.content, font=font, fill=font_color, direction="ttb",
            )
    return np.array(pillow_img)


class TableSemanticParser:
    """The layout parser, the cell detector, the text detector and the
    text recognizer with the JAX package's arguments: ``device``,
    ``visualize`` and ``num_devices`` go to every module; ``configs``
    holds each one's own arguments under "table_detector",
    "table_cell_parser", "text_detector" and "text_recognizer"."""

    def __init__(self, configs=None, device="cuda", visualize=True,
                 num_devices=None):
        configs = configs or {}
        if not isinstance(configs, dict):
            raise ValueError("configs must be a dict.")
        table_detector_kwargs = {
            "device": device, "visualize": visualize, "num_devices": num_devices,
        }
        table_cell_parser_kwargs = dict(table_detector_kwargs)
        text_detector_kwargs = {"device": device, "num_devices": num_devices}
        text_recognizer_kwargs = dict(text_detector_kwargs)
        table_detector_kwargs.update(configs.get("table_detector", {}))
        table_cell_parser_kwargs.update(configs.get("table_cell_parser", {}))
        text_detector_kwargs.update(configs.get("text_detector", {}))
        text_recognizer_kwargs.update(configs.get("text_recognizer", {}))

        self.layout_parser = LayoutParser(**table_detector_kwargs)
        self.cell_detector = CellDetector(**table_cell_parser_kwargs)
        self.text_detector = TextDetector(**text_detector_kwargs)
        self.text_recognizer = TextRecognizer(**text_recognizer_kwargs)
        self.num_devices = num_devices
        self.visualize = visualize
        self.merge_same_column_values = False
        #: the detector's and the layout parser's threads, kept across
        #: calls (see the module docstring); they start at the first call
        #: and end when the parser is collected
        self._workers = ThreadPoolExecutor(
            max_workers=2, thread_name_prefix="TableSemanticParser")
        #: the fused page program, built at the first fused page, and the
        #: fused route's recognizer pool
        self._fused_page_program = None
        self._fused_page_lock = threading.Lock()
        self._rec_pool = None
        #: the page-axis route's device-leg and tail pools, kept
        self._dp_pools = KeptPools("TableSemanticParser")

    def _rec_executor(self):
        """The fused route's pool for the recognizer's leg, kept for the
        parser's life: eight threads, so that ``batch``'s pages (four by
        default) never wait for one another there."""
        if self._rec_pool is None:
            with self._fused_page_lock:
                if self._rec_pool is None:
                    self._rec_pool = ThreadPoolExecutor(
                        max_workers=8, thread_name_prefix="tsp-rec")
        return self._rec_pool

    def aggregate(self, ocr_res, cells, overlap_th=0.2):
        """Assign each word to its best-overlap cell (reference :471),
        vectorized: one (cells, words) overlap matrix + argmax instead of
        O(words x cells) scalar ratio calls."""
        cell_words = defaultdict(list)
        cand = [c for c in cells if c.role != "group"]
        if ocr_res.words and cand:
            word_boxes = [quad_to_xyxy(w.points) for w in ocr_res.words]
            ratios = overlap_ratio_matrix([c.box for c in cand], word_boxes)
            best = ratios.argmax(axis=0)  # first max == scalar loop's ">"
            best_ratio = ratios[best, range(len(word_boxes))]
            for wi, word in enumerate(ocr_res.words):
                # scalar loop skipped when no cell overlapped (ratio 0)
                # or the best ratio was under the threshold
                if best_ratio[wi] < overlap_th or best_ratio[wi] <= 0:
                    continue
                cell_words[cand[best[wi]].id].append(
                    ParagraphSchema(
                        box=word_boxes[wi], contents=word.content,
                        direction=word.direction, order=0, role=None,
                    )
                )

        for cell in cells:
            contained = cell_words.get(cell.id, [])
            if not contained:
                cell.contents = ""
                continue
            dirs = [w.direction for w in contained]
            direction = (
                "horizontal"
                if dirs.count("horizontal") >= dirs.count("vertical")
                else "vertical"
            )
            order = "left2right" if direction == "horizontal" else "right2left"
            prediction_reading_order(contained, order)
            contained = sorted(contained, key=lambda x: x.order)
            text = "\n".join(w.contents for w in contained)
            cell.contents = text.replace("\n", "").strip()

    def replace_table_to_paragraphs(self, tables, paragraphs):
        """Tables with <2 real cells become paragraphs (reference :519)."""
        new_table_list = []
        for table in tables:
            cnt_cell = sum(
                1 for cell in table.cells if cell.role in ("cell", "header")
            )
            if cnt_cell < 2:
                paragraphs.append(
                    Element(
                        id=None, box=table.box, contents="", score=1.0, role=None
                    )
                )
            else:
                new_table_list.append(table)
        return new_table_list

    @staticmethod
    def _fused_page_enabled():
        return not os.environ.get("YOMITOKU_TPU_NO_FUSED_PAGE")

    def _ensure_fused_program(self):
        """The fused page program with the cell detector in the region
        slot, built once (see DocumentAnalyzer._ensure_fused_program)."""
        if self._fused_page_program is None:
            with self._fused_page_lock:
                if self._fused_page_program is None:
                    lp, cell = self.layout_parser, self.cell_detector
                    table_label = next(
                        i for i, c in lp.label_mapper.items() if c == "tables")
                    self._fused_page_program = FusedPageAnalysis(
                        self.text_detector.model, lp.model, cell.model,
                        lay_top_k=lp.postprocessor.num_top_queries,
                        tsr_top_k=cell.postprocessor.num_top_queries,
                        table_label=table_label,
                        lay_thresh=lp.thresh_score,
                        trace_label="det+layout+cell",
                    )
        return self._fused_page_program

    def _fused_sizes(self, img):
        """(the detector's /32 size, the layout's size, the cell crops'
        size) for one page."""
        det = self.text_detector
        ori_h, ori_w = img.shape[:2]
        det_hw = shortest_edge_size(
            ori_h, ori_w, det._cfg.data.shortest_size, det._cfg.data.limit_size)
        return (det_hw, tuple(self.layout_parser._cfg.data.img_size),
                tuple(self.cell_detector._cfg.data.img_size))

    def _run_fused_models(self, img, page):
        """The fused page route: the program's two legs on the parser's
        worker threads, one readback, then its host side."""
        det_hw, lay_hw, cell_hw = self._fused_sizes(img)
        wire = self._ensure_fused_program()(
            page, page.hw, det_hw, lay_hw, cell_hw, executor=self._workers)
        return self._fused_host_postwire(img, page, *wire)

    def _fused_host_postwire(self, img, page, prob, packed, packed_c, sel, sel_valid):
        """The host side of one page's wire: the layout filter, each kept
        table matched to its slot (the misses take the chunked region
        route, enqueued before the contours and read back after them), the
        contours, the recognizer on the side pool while the cell
        postprocess and hole mining run -> (OCRSchema, tables,
        paragraphs)."""
        det, lp, cell = self.text_detector, self.layout_parser, self.cell_detector
        ori_h, ori_w = img.shape[:2]
        cell_hw = tuple(cell._cfg.data.img_size)
        outputs = lp.postprocessor.filter_packed(packed, [[ori_w, ori_h]], lp.thresh_score)
        results_layout = LayoutParserSchema(**lp.filtering_elements(outputs[0]))

        tables = list(results_layout.tables)
        cell_data = cell._preprocess_meta(img, tables)
        filtered, missing_idx, missing_data = self._ensure_fused_program().consume_region_slots(
            cell_data, packed_c, sel, sel_valid, cell.postprocessor, cell.thresh_score)
        chunks = (dispatch_regions_from_page(cell.model, page, missing_data, cell_hw)
                  if missing_data else [])

        with segment("det", "contours"):
            quads, scores = det.postprocess({"binary": prob}, (ori_h, ori_w))
        results_det = TextDetectorSchema(points=quads, scores=scores)

        rec_page = page if lies_on(page, self.text_recognizer.device) else None
        rec_future = self._rec_executor().submit(
            self.text_recognizer, img, results_det.points, page=rec_page)
        try:
            for i, one in zip(missing_idx, collect_filtered_regions(
                    chunks, cell.postprocessor, cell.thresh_score)):
                filtered[i] = one
            results_table = []
            for one, d, table in zip(filtered, cell_data, tables):
                cells = cell.postprocess(one, d, table.box)
                if len(cells) == 0:
                    continue
                results_table.append(TableDetectorSchema(
                    id=None, box=table.box, role=table.role, cells=cells))
            results_table = self.replace_table_to_paragraphs(
                results_table, results_layout.paragraphs)
        finally:
            results_rec, _ = rec_future.result()
        results_ocr = OCRSchema(words=ocr_aggregate(results_det, results_rec))
        return results_ocr, results_table, results_layout.paragraphs

    def _takes_fused_route(self, page):
        """The fused route: a DevicePage, the switch unset, and the
        detector, the layout parser and the cell detector on the page's
        device."""
        return (page is not None and self._fused_page_enabled() and all(
            lies_on(page, m.device)
            for m in (self.text_detector, self.layout_parser, self.cell_detector)))

    async def run_models(self, img):
        """The models on one BGR page -> (OCRSchema, [TableDetectorSchema],
        paragraphs): the fused page route where it applies (see the module
        docstring); else the detector and the layout parser on the
        parser's two worker threads over one DevicePage (where device crops
        are on), then the cell detector on the layout's tables, then the
        recognizer on the same page."""
        device = self.text_detector.device
        page = DevicePage(img, device) if device_crops_enabled(device) else None
        if self._takes_fused_route(page):
            return self._run_fused_models(img, page)

        def page_for(module):
            if page is None or lies_on(page, module.device):
                return page
            return DevicePage(img, module.device)

        loop = asyncio.get_running_loop()
        (results_det, _), (results_layout, _) = await asyncio.gather(
            loop.run_in_executor(self._workers, self.text_detector, img, page),
            loop.run_in_executor(self._workers, self.layout_parser, img,
                                 page_for(self.layout_parser)),
        )

        results_table = self.cell_detector(
            img, list(results_layout.tables), page=page_for(self.cell_detector)
        )
        results_table = self.replace_table_to_paragraphs(
            results_table, results_layout.paragraphs
        )

        results_rec, _ = self.text_recognizer(
            img, results_det.points, page=page_for(self.text_recognizer)
        )
        results_ocr = OCRSchema(words=ocr_aggregate(results_det, results_rec))
        return results_ocr, results_table, results_layout.paragraphs

    def visualizer_ocr(self, img, semantic_info):
        return _ocr_visualizer(
            img,
            semantic_info,
            font_size=self.text_recognizer._cfg.visualize.font_size,
            font_color=tuple(self.text_recognizer._cfg.visualize.color[::-1]),
            font_path=self.text_recognizer._cfg.visualize.font,
        )

    def visualizer_layout(self, img, semantic_info):
        from .utils.visualizer import cell_detector_visualizer

        vis = _layout_visualizer(semantic_info.tables, img.copy(), prefix="Table")
        vis = _layout_visualizer(
            semantic_info.paragraphs, vis, prefix="Paragraph"
        )
        for results_table in semantic_info.tables:
            vis, _ = cell_detector_visualizer(
                vis, vis, list(results_table.cells.values())
            )
            for grid in results_table.grids:
                box = grid.box
                cv2.rectangle(
                    vis, (box[0], box[1]), (box[2], box[3]), (255, 0, 0), 3
                )
        return vis

    def batch(self, imgs, max_in_flight=4, template=None, grid_only=False,
              kv_only=False):
        """Up to ``max_in_flight`` pages at once, each one ``__call__`` on a
        thread of its own, so that one page's host stages (contours, cell
        postprocess and hole mining, clustering, grid and key-value
        parsing) overlap another page's device work -> [(semantic_info,
        vis_layout, vis_ocr)] in input order.  The models are shared: their
        kernels queue on the device's stream, the pages' detector and
        layout calls (on the fused route, the program's two legs) share
        the parser's two worker threads, which keep cuDNN's plans, and the
        recognizer's AR loop takes one page at a time.

        With ``num_devices`` above 1, two or more pages and no
        ``visualize``, pages on the fused route take the page axis
        (``_batch_dp_fused``), as in the JAX package; elsewhere they run
        on threads, as the JAX package's do."""
        if not imgs:
            return []
        if (self.num_devices and self.num_devices > 1 and len(imgs) > 1
                and not self.visualize):
            device = self.text_detector.device
            if (device_crops_enabled(device) and self._fused_page_enabled()
                    and all(same_device(m.device, device)
                            for m in (self.layout_parser, self.cell_detector))):
                return self._batch_dp_fused(imgs, template=template,
                                            grid_only=grid_only, kv_only=kv_only)
        with ThreadPoolExecutor(max_workers=max_in_flight) as executor:
            return list(
                executor.map(
                    lambda im: self(
                        im, template=template, grid_only=grid_only,
                        kv_only=kv_only,
                    ),
                    imgs,
                )
            )

    def _batch_dp_fused(self, imgs, template=None, grid_only=False, kv_only=False):
        """Page-axis batching over the fused page program with the cell
        detector in the region slot: DocumentAnalyzer._batch_dp_fused's
        schedule (``ops.fused_page.run_page_chunks``); each page's tail is
        the host side of its wire (the recognizer on the side pool) and
        ``_finalize``."""
        prog = self._ensure_fused_program()
        mesh = dp_mesh(self.num_devices, device_type=self.text_detector.device.type)
        det_hws = [self._fused_sizes(img)[0] for img in imgs]
        lay_hw, cell_hw = self._fused_sizes(imgs[0])[1:]

        def post_one(i, page, wire):
            results_ocr, results_table, paragraphs = self._fused_host_postwire(
                imgs[i], page, *wire)
            return self._finalize(imgs[i], results_ocr, results_table, paragraphs,
                                  template=template, grid_only=grid_only, kv_only=kv_only)

        return run_page_chunks(
            prog, imgs, det_hws, lay_hw, cell_hw, self.text_detector.device,
            dp_chunk_pages(mesh, len(imgs)), post_one, self._dp_pools, self._workers)

    def __call__(self, img, template=None, id=None, grid_only=False, kv_only=False):
        """Parse one BGR page -> (TableSemanticParserSchema, vis_layout,
        vis_ocr); the pictures are None unless ``visualize``.  Keeps
        nothing of the page on the parser (``batch`` calls it on several
        threads)."""
        results_ocr, results_table, paragraphs = asyncio.run(self.run_models(img))
        return self._finalize(
            img, results_ocr, results_table, paragraphs,
            template=template, grid_only=grid_only, kv_only=kv_only,
        )

    def _finalize(self, img, results_ocr, results_table, paragraphs,
                  template=None, grid_only=False, kv_only=False):
        """Host-only semantic stage: OCR-word aggregation, clustering,
        grid/kv parsing, id assignment, schema build."""
        with segment("aggregate", "host"):
            for table in results_table:
                self.aggregate(results_ocr, table.cells)
            self.aggregate(results_ocr, paragraphs)

        # the page-sized copies and the DAG overlay only exist when
        # visualization is requested; the CLI handles None
        vis_layout = img.copy() if self.visualize else None
        vis_ocr = img.copy() if self.visualize else None

        with segment("semantic", "parse"):
            semantic_info = []
            cell_offset = 0
            for i, table in enumerate(results_table):
                cells = {}
                for cell in table.cells:
                    if isinstance(cell, TableCellSchema):
                        cell = CellSchema(
                            meta={}, id=cell.id, box=cell.box, role=cell.role,
                            row=cell.row, col=cell.col, row_span=cell.row_span,
                            col_span=cell.col_span, contents=cell.contents,
                        )
                    cells[cell.id] = cell

                table_information = {
                    "id": f"t{i}",
                    "box": table.box,
                    "cells": {},
                    "style": "border",
                    "kv_items": [],
                    "grids": [],
                }
                if template is None:
                    nodes = _split_nodes_with_role(table.cells)
                    if not grid_only:
                        clusters, dag = _weakly_cluster_nodes_with_graph(nodes)
                        cluster_nodes_list = _get_cluster_nodes(clusters, nodes)
                    else:
                        clusters = [[cell.id for cell in table.cells]]
                        cluster_nodes_list = [nodes]

                    for clustered_nodes in cluster_nodes_list:
                        if not kv_only and is_grid_cluster(clustered_nodes):
                            parsed = parse_grid_from_bottom_up(
                                cells, clustered_nodes, self.merge_same_column_values
                            )
                            if parsed is None:
                                continue
                            grid, grid_cells, dag = parsed
                            table_information["grids"].append(grid)
                            table_information["cells"].update(grid_cells)
                            if self.visualize:
                                vis_layout = dag_visualizer(dag, vis_layout)
                        else:
                            kv_items, dag, kv_cells = parse_kv_items(
                                clustered_nodes, nodes, cells
                            )
                            table_information["kv_items"].extend(kv_items)
                            table_information["cells"].update(kv_cells)
                            if self.visualize:
                                vis_layout = dag_visualizer(dag, vis_layout)

                for cell in cells.values():
                    if cell.id not in table_information["cells"]:
                        table_information["cells"][cell.id] = cell

                table_information["kv_items"] = sorted(
                    table_information["kv_items"],
                    key=lambda kv: table_information["cells"][kv.value].box[1],
                )
                table_information["grids"] = sorted(
                    table_information["grids"], key=lambda g: g.box[1]
                )
                for gi, grid in enumerate(table_information["grids"]):
                    grid.id = f"g{gi}"
                for ki, kv in enumerate(table_information["kv_items"]):
                    kv.id = f"kv{ki}"

                cell_offset = _assign_ids(table_information, cell_offset)
                semantic_info.append(TableSemanticContentsSchema(**table_information))

        semantic_info = _sort_elements(semantic_info, prefix="t")
        paragraphs = _sort_elements(paragraphs, prefix="p")

        semantic_info = TableSemanticParserSchema(
            tables=semantic_info,
            paragraphs=paragraphs,
            words=results_ocr.words,
        )

        if template is not None:
            semantic_info.load_template_json(template)

        if self.visualize:
            vis_layout = self.visualizer_layout(vis_layout, semantic_info)
            vis_ocr = self.visualizer_ocr(vis_ocr, semantic_info)

        return semantic_info, vis_layout, vis_ocr
