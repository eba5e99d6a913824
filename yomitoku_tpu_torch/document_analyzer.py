"""DocumentAnalyzer: the full-page pipeline (the port's counterpart of
yomitoku_tpu/document_analyzer.py): the detector and the layout analysis
on two threads, the optional split of detected quads at table-cell
boundaries, recognition, then aggregation on the host (words to cells and
paragraphs by 0.5-containment, the ruby filter, figures absorbing the
paragraphs they contain, reading order with header, body and footer
offsets).  The aggregation helpers are the JAX module's, numpy on the host
as there: one containment matrix drives word-to-element assignment, figure
absorption and the quad split.

``run`` takes the JAX package's routes.  Where device crops are on for
the detector's device (CUDA, by default) the page is uploaded once, as
one DevicePage.  Where the detector, the layout parser and the table
recognizer all lie on that page's device and YOMITOKU_TPU_NO_FUSED_PAGE
is unset, the page takes the fused page program (ops/fused_page.py, the
CUDA default as the JAX package's is on an accelerator): the detector,
the layout, the device's selection of up to four tables and the table
recognizer on them, read back once; then on the host the layout filter,
the slots' matching, the chunked region route for the tables the slots
missed (overlapped with the contours), the recognizer and the
aggregation.  Everywhere else the unfused route runs: the detector and
the layout analyzer on the page, each module on another device uploading
its own.  Neither the page nor the image is kept on the analyzer, so
``batch`` may run ``__call__`` on several threads; the models' shared
state is guarded where they keep it (PARSeq's AR loop,
models/parseq.py), and the fused program, built once, under its lock.

``num_devices`` goes to every module, which counts devices as the JAX
package's ``dp_mesh`` does and, where two or more take part, keeps one
replica of its model per device (``parallel/``).  With ``num_devices``
above 1, ``batch`` takes the page axis (``_batch_dp``): on the fused route
chunks of pages through ``FusedPageAnalysis.batch_call`` (the mesh's dp
size a chunk, else YOMITOKU_TPU_DP_CHUNK, default 1), with the pages'
host tails behind them; elsewhere one forward per stage over every page.

The detector and the layout analyzer (on the fused route: the program's
two legs) run on two worker threads that the analyzer keeps for its
lifetime, where the JAX package makes two for each page (and runs its
fused program on the caller's thread): PyTorch keeps cuDNN's convolution
plans per thread, so on a new thread every convolution of DBNet and
RT-DETRv2 is planned again, which on an H100 costs more than the models'
own time (chip_smoke.py phase 9 measures both, and the detector with
cuDNN off).
"""

import asyncio
import math
import os
import re
import threading
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .data.dataset import ParseqDataset
from .data.functions import shortest_edge_size
from .layout_analyzer import LayoutAnalyzer
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
    DocumentAnalyzerSchema,
    FigureSchema,
    LayoutAnalyzerSchema,
    LayoutParserSchema,
    OCRSchema,
    ParagraphSchema,
    TextDetectorSchema,
    TextRecognizerSchema,
)
from .text_detector import TextDetector
from .text_recognizer import TextRecognizer
from .utils.misc import containment_matrix, overlap_ratio_matrix, quad_to_xyxy
from .utils.stagetrace import segment


def combine_flags(flag1, flag2):
    return [f1 or f2 for f1, f2 in zip(flag1, flag2)]


def _box_areas(elements):
    """(N,) float areas of .box xyxy attributes."""
    if not elements:
        return np.zeros(0)
    b = np.asarray([e.box for e in elements], np.float64)
    return (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])


def judge_page_direction(paragraphs):
    """The direction covering more total paragraph area wins; anything
    not explicitly "horizontal" (including None) counts as vertical, and
    the tie goes to horizontal."""
    areas = _box_areas(paragraphs)
    horiz = np.fromiter(
        (p.direction == "horizontal" for p in paragraphs), bool, len(areas)
    )
    return "vertical" if areas[~horiz].sum() > areas[horiz].sum() else "horizontal"


def extract_paragraph_within_figure(paragraphs, figures):
    """Each figure absorbs the paragraphs 0.7-contained in it (shared
    objects, re-ordered internally by the figure's own voted direction).
    Returns (figure schemas, per-paragraph absorbed mask)."""
    inside = containment_matrix(
        [f.box for f in figures], [p.box for p in paragraphs], threshold=0.7
    )
    new_figures = []
    for figure, row in zip(figures, inside):
        members = [paragraphs[i] for i in np.nonzero(row)[0]]
        direction = judge_page_direction(members)
        prediction_reading_order(
            members, "left2right" if direction == "horizontal" else "right2left"
        )
        new_figures.append(
            FigureSchema(
                box=figure.box, order=0, direction=direction,
                paragraphs=sorted(members, key=lambda p: p.order),
            )
        )
    absorbed = inside.any(axis=0) if len(figures) else np.zeros(len(paragraphs), bool)
    return new_figures, absorbed.tolist()


#: a pure-kana token: entirely hiragana, or entirely katakana
_RE_KANA_ONLY = re.compile(r"^(?:[぀-ゟ]+|[゠-ヿ]+)$")


def _upper_median(values):
    """sorted(values)[n // 2] — the upper-median convention the size
    statistics use throughout."""
    return np.sort(values)[values.size // 2]


def _compute_ruby_threshold(sizes, k):
    """Size cut separating a furigana mode from the body-text mode.

    The log-size histogram is scanned for its two dominant peaks; when
    the valley between them is deep enough (peak mass / valley mass >=
    ``k``) the split lands at the valley center, otherwise — and when no
    second peak exists at all — a robust median - 2*MAD cut is used.
    Returns None when no defensible split exists."""
    s = np.asarray(sizes, np.float64)
    if s.size < 3:
        return None
    logs = np.log(s)
    lo, hi = logs.min(), logs.max()
    if hi - lo < 1e-9:
        return None
    nbins = max(8, int(math.sqrt(s.size)))
    width = (hi - lo) / nbins
    bins = np.minimum(((logs - lo) / width).astype(np.int64), nbins - 1)
    hist = np.bincount(bins, minlength=nbins)

    p1 = int(hist.argmax())
    eligible = np.abs(np.arange(nbins) - p1) >= 2
    if not eligible.any():
        return _mad_cut(s)
    p2 = int(np.where(eligible, hist, -1).argmax())
    a, b = sorted((p1, p2))
    if b - a <= 1:
        return _mad_cut(s)
    between = hist[a + 1 : b]
    ties = np.nonzero(between == between.min())[0]
    valley = a + 1 + int(ties[ties.size // 2])
    bimodality = (hist[p1] + hist[p2]) / (2 * hist[valley] + 1e-6)
    if bimodality >= k:
        return math.exp(lo + (valley + 0.5) * width)
    return _mad_cut(s)


def _mad_cut(s):
    """median - 2*MAD, or None when the center/spread collapses."""
    med = _upper_median(s)
    if med == 0:
        return None
    mad = _upper_median(np.abs(s - med))
    if mad == 0:
        return None
    cut = med - 2 * mad
    return float(cut) if cut > 0 else None



def filter_ruby(contained_words, element_direction, ruby_threshold):
    """Drop words that sit below the furigana size split AND consist of
    kana only (spaces ignored).  ``element_direction`` is unused but kept
    for signature parity."""
    if len(contained_words) <= 1:
        return contained_words
    area = _box_areas(contained_words)
    with np.errstate(invalid="ignore"):
        sizes = np.sqrt(area)
    positive = sizes[sizes > 0]
    if positive.size < 2:
        return contained_words
    cut = _compute_ruby_threshold(positive, ruby_threshold)
    if cut is None:
        return contained_words
    small = (sizes > 0) & (sizes < cut)
    return [
        w for w, is_small in zip(contained_words, small)
        if not (is_small and _RE_KANA_ONLY.match(w.contents.replace(" ", "")))
    ]


class _BlockWord:
    """Slotted stand-in for ParagraphSchema in the per-block ordering path:
    aggregate() orders the member words of every cell and paragraph, and a
    pydantic object validates each ``.order`` write."""

    __slots__ = ("box", "contents", "direction", "order")

    def __init__(self, box, contents, direction):
        self.box = box
        self.contents = contents
        self.direction = direction
        self.order = 0


def _assemble_text_block(words, word_boxes, member_idx, ignore_ruby,
                         ruby_threshold):
    """Compose the text block for one element from its member word
    indices: majority direction vote (ties vertical), optional ruby
    filtering, intra-element reading order, newline join.  Returns
    (text, direction) — (None, None) when nothing remains."""
    if len(member_idx) == 0:
        return None, None
    members = [
        _BlockWord(word_boxes[i], words[i].content, words[i].direction)
        for i in member_idx
    ]
    n_horizontal = sum(m.direction == "horizontal" for m in members)
    n_vertical = sum(m.direction == "vertical" for m in members)
    direction = "horizontal" if n_horizontal > n_vertical else "vertical"
    if ignore_ruby:
        members = filter_ruby(members, direction, ruby_threshold)
        if not members:
            return None, None
    prediction_reading_order(
        members, "left2right" if direction == "horizontal" else "right2left"
    )
    members.sort(key=lambda m: m.order)
    return "\n".join(m.contents for m in members), direction


def extract_words_within_element(
    pred_words, element, ignore_ruby=False, ruby_threshold=2.0,
    word_boxes=None,
):
    """API-parity wrapper over ``_assemble_text_block``: selects the words
    0.5-contained in ``element`` and composes their text block.  Callers
    looping over many elements should precompute ``word_boxes`` once
    (aggregate() builds one containment matrix for ALL elements instead)."""
    if not pred_words:
        return None, None, []
    if word_boxes is None:
        word_boxes = [quad_to_xyxy(w.points) for w in pred_words]
    inside = containment_matrix([element.box], word_boxes, threshold=0.5)[0]
    text, direction = _assemble_text_block(
        pred_words, word_boxes, np.nonzero(inside)[0], ignore_ruby,
        ruby_threshold,
    )
    return text, direction, inside.tolist()


def _quad_edges(points):
    """(N,4,2) float quads -> (quads, widths, heights) where width/height
    are the p0-p1 / p1-p2 edge norms."""
    q = np.asarray(points, np.float64).reshape(-1, 4, 2)
    w = np.linalg.norm(q[:, 0] - q[:, 1], axis=1)
    h = np.linalg.norm(q[:, 1] - q[:, 2], axis=1)
    return q, w, h


def is_vertical(quad, thresh_aspect=2):
    _, w, h = _quad_edges([quad])
    return bool(h[0] > w[0] * thresh_aspect)


def is_noise(quad, thresh=15):
    _, w, h = _quad_edges([quad])
    return bool(w[0] < thresh or h[0] < thresh)


def recursive_update(original, new_data):
    for key, value in new_data.items():
        if (
            isinstance(value, dict)
            and key in original
            and isinstance(original[key], dict)
        ):
            recursive_update(original[key], value)
        else:
            original[key] = value
    return original


_NOISE_MIN_EDGE = 15  # min clipped-piece edge norm (reference is_noise)


def _clip_quads_to_cells(quads, scores, lines, cells, axis):
    """Clip word quads to the cells of their best-overlapping table line.

    ``axis`` 0: horizontal words, allocated to a row by overlap, clipped
    in x against every cell whose row-span covers that row.  ``axis`` 1:
    vertical words vs columns, clipped in y.  Pieces shorter than the
    noise floor on either edge are dropped.  Fully vectorized over the
    (word x cell) pair grid; emission order is word-major then cell order,
    matching the reference's nested loops."""
    if len(quads) == 0 or not lines or not cells:
        return [], []
    boxes = np.concatenate([quads.min(axis=1), quads.max(axis=1)], axis=1)
    # fraction of each word box covered by each line (reference allocates
    # by calc_overlap_ratio against the word box, first argmax wins)
    ratio = overlap_ratio_matrix([ln.box for ln in lines], boxes)
    alloc = ratio.argmax(axis=0)

    start = np.asarray([c.row if axis == 0 else c.col for c in cells])
    span = np.asarray(
        [c.row_span if axis == 0 else c.col_span for c in cells]
    )
    line_no = alloc[:, None] + 1  # 1-based
    covers = (start[None, :] <= line_no) & (line_no < start[None, :] + span[None, :])

    # integer intersection intervals per (word, cell), calc_intersection
    # truncation semantics; empty on either axis kills the pair
    wb = np.trunc(boxes).astype(np.int64)
    cb = np.trunc(np.asarray([c.box for c in cells], np.float64)).astype(np.int64)
    lo = np.maximum(wb[:, None, :2], cb[None, :, :2])
    hi = np.minimum(wb[:, None, 2:], cb[None, :, 2:])
    pairs = covers & (hi > lo).all(axis=2)

    wi, ci = np.nonzero(pairs)
    if wi.size == 0:
        return [], []
    pieces = quads[wi].copy()
    # clip the two leading/trailing corners along the chosen axis
    head, tail = ((0, 3), (1, 2)) if axis == 0 else ((0, 1), (2, 3))
    pieces[:, head, axis] = np.maximum(
        pieces[:, head, axis], lo[wi, ci, axis, None]
    )
    pieces[:, tail, axis] = np.minimum(
        pieces[:, tail, axis], hi[wi, ci, axis, None]
    )
    pw = np.linalg.norm(pieces[:, 0] - pieces[:, 1], axis=1)
    ph = np.linalg.norm(pieces[:, 1] - pieces[:, 2], axis=1)
    keep = np.nonzero((pw >= _NOISE_MIN_EDGE) & (ph >= _NOISE_MIN_EDGE))[0]
    return [pieces[i].tolist() for i in keep], [scores[wi[i]] for i in keep]


def _split_text_across_cells(results_det, results_layout):
    """Split detected quads at table row/col boundaries so each piece
    lands in a single cell; words outside every table pass through."""
    n = len(results_det.points)
    if n == 0:
        return results_det
    quads, edge_w, edge_h = _quad_edges(results_det.points)
    vertical = edge_h > 2 * edge_w
    boxes = np.concatenate([quads.min(axis=1), quads.max(axis=1)], axis=1)
    scores = list(results_det.scores)

    in_any_table = np.zeros(n, bool)
    new_points, new_scores = [], []
    for table in results_layout.tables:
        inside = overlap_ratio_matrix([table.box], boxes)[0] > 0.5
        in_any_table |= inside
        for mask, lines, axis in (
            (inside & ~vertical, table.rows, 0),
            (inside & vertical, table.cols, 1),
        ):
            idx = np.nonzero(mask)[0]
            pts, scs = _clip_quads_to_cells(
                quads[idx], [scores[i] for i in idx], lines, table.cells,
                axis,
            )
            new_points.extend(pts)
            new_scores.extend(scs)

    for i in np.nonzero(~in_any_table)[0]:
        new_points.append(results_det.points[i])
        new_scores.append(scores[i])

    results_det.points = new_points
    results_det.scores = new_scores
    return results_det


class DocumentAnalyzer:
    """Detector, recognizer and layout analyzer with the JAX package's
    arguments: ``device``, ``visualize`` and ``num_devices`` go to every
    module, under its entry in ``configs`` ({"ocr": {"text_detector": ...,
    "text_recognizer": ...}, "layout_analyzer": {"layout_parser": ...,
    "table_structure_recognizer": ...}}, merged recursively)."""

    def __init__(
        self,
        configs=None,
        device="cuda",
        visualize=False,
        num_devices=None,
        ignore_meta=False,
        reading_order="auto",
        split_text_across_cells=False,
        ignore_ruby=False,
        ruby_threshold=2.0,
    ):
        common = {"device": device, "visualize": visualize,
                  "num_devices": num_devices}
        default_configs = {
            "ocr": {
                "text_detector": dict(common),
                "text_recognizer": dict(common),
            },
            "layout_analyzer": {
                "layout_parser": dict(common),
                "table_structure_recognizer": dict(common),
            },
        }
        self.reading_order = reading_order
        if configs is not None:
            if not isinstance(configs, dict):
                raise ValueError("configs must be a dict.")
            recursive_update(default_configs, configs)

        self.text_detector = TextDetector(**default_configs["ocr"]["text_detector"])
        self.text_recognizer = TextRecognizer(
            **default_configs["ocr"]["text_recognizer"]
        )
        self.layout = LayoutAnalyzer(configs=default_configs["layout_analyzer"])
        self.num_devices = num_devices
        self.visualize = visualize
        self.ignore_meta = ignore_meta
        self.split_text_across_cells = split_text_across_cells
        self.ignore_ruby = ignore_ruby
        self.ruby_threshold = ruby_threshold
        #: the detector's and the layout analyzer's threads, kept across
        #: calls (see the module docstring); they start at the first call
        #: and end when the analyzer is collected
        self._workers = ThreadPoolExecutor(
            max_workers=2, thread_name_prefix="DocumentAnalyzer")
        #: the fused page program, built at the first fused page
        self._fused_page_program = None
        self._fused_page_lock = threading.Lock()
        #: the page-axis route's device-leg and tail pools, kept as the two
        #: workers are
        self._dp_pools = KeptPools("DocumentAnalyzer")

    def aggregate(self, ocr_res, layout_res):
        """Assign words to table cells and layout paragraphs, then order
        the page.  One containment matrix covers every (element, word)
        pair; each element's members come from its row."""
        words = ocr_res.words
        word_boxes = [quad_to_xyxy(w.points) for w in words]
        cells = [c for table in layout_res.tables for c in table.cells]
        inside = containment_matrix(
            [c.box for c in cells] + [p.box for p in layout_res.paragraphs],
            word_boxes, threshold=0.5,
        )
        claimed = np.zeros(len(words), bool)

        def _block(row):
            return _assemble_text_block(
                words, word_boxes, np.nonzero(row)[0],
                self.ignore_ruby, self.ruby_threshold,
            )

        # cells claim their contained words even when ruby filtering
        # empties the block
        for cell, row in zip(cells, inside):
            text, _ = _block(row)
            cell.contents = text if text is not None else ""
            claimed |= row

        # a paragraph whose block comes back empty claims nothing
        paragraphs = []
        for paragraph, row in zip(layout_res.paragraphs, inside[len(cells):]):
            text, direction = _block(row)
            if text is None:
                continue
            claimed |= row
            paragraphs.append(
                ParagraphSchema(
                    contents=text,
                    box=paragraph.box,
                    direction=direction,
                    order=0,
                    role=paragraph.role,
                )
            )

        # every unclaimed word becomes its own paragraph
        for i in np.nonzero(~claimed)[0]:
            paragraphs.append(
                ParagraphSchema(
                    contents=words[i].content,
                    box=word_boxes[i],
                    direction=words[i].direction,
                    order=0,
                    role=None,
                )
            )

        figures, check_list = extract_paragraph_within_figure(
            paragraphs, layout_res.figures
        )
        paragraphs = [p for p, f in zip(paragraphs, check_list) if not f]

        page_direction = judge_page_direction(paragraphs)

        headers = [
            p for p in paragraphs if p.role == "page_header" and not self.ignore_meta
        ]
        footers = [
            p for p in paragraphs if p.role == "page_footer" and not self.ignore_meta
        ]
        page_contents = [
            p for p in paragraphs if p.role is None or p.role == "section_headings"
        ]
        elements = page_contents + layout_res.tables + figures

        prediction_reading_order(headers, "left2right")
        prediction_reading_order(footers, "left2right")

        if self.reading_order == "auto":
            reading_order = (
                "right2left" if page_direction == "vertical" else "top2bottom"
            )
        else:
            reading_order = self.reading_order
        prediction_reading_order(elements, reading_order)

        for element in elements:
            element.order += len(headers)
        for footer in footers:
            footer.order += len(elements) + len(headers)

        paragraphs = sorted(headers + page_contents + footers, key=lambda x: x.order)
        figures = sorted(figures, key=lambda x: x.order)
        tables = sorted(layout_res.tables, key=lambda x: x.order)

        return {
            "paragraphs": paragraphs,
            "tables": tables,
            "figures": figures,
            "words": ocr_res.words,
        }

    def _ensure_fused_program(self):
        """The fused page program, built once: ``batch`` runs several
        pages at once, and each would otherwise build its own."""
        if self._fused_page_program is None:
            with self._fused_page_lock:
                if self._fused_page_program is None:
                    lp = self.layout.layout_parser
                    tsr = self.layout.table_structure_recognizer
                    table_label = next(
                        i for i, c in lp.label_mapper.items() if c == "tables")
                    self._fused_page_program = FusedPageAnalysis(
                        self.text_detector.model, lp.model, tsr.model,
                        lay_top_k=lp.postprocessor.num_top_queries,
                        tsr_top_k=tsr.postprocessor.num_top_queries,
                        table_label=table_label,
                        lay_thresh=lp.thresh_score,
                    )
        return self._fused_page_program

    def _fused_host_postwire(self, img, page, prob, packed, packed_t, sel, sel_valid):
        """The host side of one page's wire: the layout filter, each kept
        table matched to its slot (the misses take the chunked region
        route, enqueued before the contours and read back after them), the
        detector's contours, the split across cells -> (results_det,
        results_layout, layout_schema)."""
        det = self.text_detector
        lp = self.layout.layout_parser
        tsr = self.layout.table_structure_recognizer
        ori_h, ori_w = img.shape[:2]
        tsr_hw = tuple(tsr._cfg.data.img_size)

        outputs = lp.postprocessor.filter_packed(packed, [[ori_w, ori_h]], lp.thresh_score)
        results_layout = LayoutParserSchema(**lp.filtering_elements(outputs[0]))

        tsr_data = tsr._preprocess_meta(img, [t.box for t in results_layout.tables])
        filtered, missing_idx, missing_data = self._ensure_fused_program().consume_region_slots(
            tsr_data, packed_t, sel, sel_valid, tsr.postprocessor, tsr.thresh_score)
        chunks = (dispatch_regions_from_page(tsr.model, page, missing_data, tsr_hw)
                  if missing_data else [])

        with segment("det", "contours"):
            quads, scores = det.postprocess({"binary": prob}, (ori_h, ori_w))
        results_det = TextDetectorSchema(points=quads, scores=scores)

        for i, one in zip(missing_idx, collect_filtered_regions(
                chunks, tsr.postprocessor, tsr.thresh_score)):
            filtered[i] = one
        tables = tsr.tables_from_filtered(tsr_data, filtered)
        layout_schema = LayoutAnalyzerSchema(
            paragraphs=results_layout.paragraphs,
            tables=tables,
            figures=results_layout.figures,
        )
        if self.split_text_across_cells:
            results_det = _split_text_across_cells(results_det, layout_schema)
        return results_det, results_layout, layout_schema

    def _run_fused(self, img, page):
        """The fused page route: the program's two legs on the analyzer's
        worker threads, one readback, the host side of the wire, then the
        recognizer on this thread and the aggregation."""
        det = self.text_detector
        lp = self.layout.layout_parser
        tsr = self.layout.table_structure_recognizer
        ori_h, ori_w = img.shape[:2]
        det_hw = shortest_edge_size(
            ori_h, ori_w, det._cfg.data.shortest_size, det._cfg.data.limit_size)
        wire = self._ensure_fused_program()(
            page, page.hw, det_hw, tuple(lp._cfg.data.img_size),
            tuple(tsr._cfg.data.img_size), executor=self._workers)
        results_det, results_layout, layout_schema = self._fused_host_postwire(
            img, page, *wire)

        vis_det = None
        layout_vis = None
        if self.visualize:
            from .utils.visualizer import (
                det_visualizer,
                layout_visualizer,
                table_visualizer,
            )

            vis_det = det_visualizer(img, results_det.points)
            layout_vis = layout_visualizer(results_layout, img)
            for table in layout_schema.tables:
                layout_vis = table_visualizer(layout_vis, table)

        rec_page = page if lies_on(page, self.text_recognizer.device) else None
        results_rec, ocr = self.text_recognizer(
            img, results_det.points, vis_det, page=rec_page)
        with segment("aggregate", "host"):
            results_ocr = OCRSchema(words=ocr_aggregate(results_det, results_rec))
            outputs = self.aggregate(results_ocr, layout_schema)
        return DocumentAnalyzerSchema(**outputs), ocr, layout_vis

    @staticmethod
    def _fused_page_enabled():
        return not os.environ.get("YOMITOKU_TPU_NO_FUSED_PAGE")

    def _takes_fused_route(self, page):
        """The fused route: a DevicePage, the switch unset, and the
        detector, the layout parser and the table recognizer on the page's
        device."""
        return (page is not None and self._fused_page_enabled() and all(
            lies_on(page, m.device) for m in (
                self.text_detector, self.layout.layout_parser,
                self.layout.table_structure_recognizer)))

    async def run(self, img):
        """Analyse one BGR page -> (DocumentAnalyzerSchema, ocr vis, layout
        vis): the fused page route where it applies (see the module
        docstring); else the detector and the layout analyzer on the
        analyzer's two worker threads over one DevicePage (where device
        crops are on), then the recognizer on the same page, then the
        aggregation."""
        device = self.text_detector.device
        page = DevicePage(img, device) if device_crops_enabled(device) else None
        if self._takes_fused_route(page):
            return self._run_fused(img, page)
        loop = asyncio.get_running_loop()
        (results_det, _), (results_layout, layout) = await asyncio.gather(
            loop.run_in_executor(self._workers, self.text_detector, img, page),
            loop.run_in_executor(self._workers, self.layout, img, page),
        )

        if self.split_text_across_cells:
            results_det = _split_text_across_cells(results_det, results_layout)

        vis_det = None
        if self.visualize:
            from .utils.visualizer import det_visualizer

            vis_det = det_visualizer(img, results_det.points)

        if page is not None and not lies_on(page, self.text_recognizer.device):
            page = None
        results_rec, ocr = self.text_recognizer(
            img, results_det.points, vis_det, page=page
        )
        with segment("aggregate", "host"):
            results_ocr = OCRSchema(words=ocr_aggregate(results_det, results_rec))
            outputs = self.aggregate(results_ocr, results_layout)
        return DocumentAnalyzerSchema(**outputs), ocr, layout

    def __call__(self, img):
        """Analyse one BGR page -> (DocumentAnalyzerSchema, ocr vis, layout
        vis); with ``visualize`` the layout picture also shows the reading
        order.  Keeps nothing of the page on the analyzer (``batch`` calls
        it on several threads)."""
        results, ocr, layout = asyncio.run(self.run(img))
        if self.visualize:
            from .utils.visualizer import reading_order_visualizer

            layout = reading_order_visualizer(layout, results)
        return results, ocr, layout

    def batch(self, imgs, max_in_flight=4):
        """Up to ``max_in_flight`` pages at once, each one ``__call__`` on
        a thread of its own, so that one page's host stages (contours, maps,
        tokenizer, aggregation) overlap another page's device work ->
        [(DocumentAnalyzerSchema, ocr vis, layout vis)] in input order.
        The models are shared: their kernels queue on the device's stream,
        the pages' detector and layout calls (on the fused route, the
        program's two legs) share the analyzer's two worker threads, so
        four pages in flight queue their legs on two threads, as intended:
        those threads keep cuDNN's plans.  The recognizer's AR loop takes
        one page at a time.

        With ``num_devices`` above 1, two or more pages and no
        ``visualize``, the page axis itself batches (``_batch_dp``), as in
        the JAX package, whether or not two devices take part."""
        if not imgs:
            return []
        if (self.num_devices and self.num_devices > 1 and len(imgs) > 1
                and not self.visualize):
            return self._batch_dp(imgs)
        with ThreadPoolExecutor(max_workers=max_in_flight) as executor:
            return list(executor.map(self, imgs))

    def _batch_dp(self, imgs):
        """The page-axis route: the fused program over chunks of pages
        (``_batch_dp_fused``) where device crops and the fused page are on
        and the detector, the layout parser and the table recognizer share
        one device; else the stage-batched host route
        (``_batch_dp_host``).  Neither falls back to the other, nor to the
        threads of ``batch``, once taken."""
        device = self.text_detector.device
        if (device_crops_enabled(device) and self._fused_page_enabled()
                and all(same_device(m.device, device)
                        for m in (self.layout.layout_parser,
                                  self.layout.table_structure_recognizer))):
            return self._batch_dp_fused(imgs)
        return self._batch_dp_host(imgs)

    def _batch_dp_fused(self, imgs):
        """Page-axis batching over the fused page program
        (``ops.fused_page.run_page_chunks``): chunks of pages of one padded
        shape and detector size, each one ``batch_call`` (the detector and
        the layout as one batch each, the region model on every page's
        slots at once, one readback), the dp size of the mesh at a time
        (each batch split over the replicas), else
        YOMITOKU_TPU_DP_CHUNK pages (default 1); then per page, on the
        kept tail workers, the host side of its wire, the recognizer on
        its page in the stack, and the aggregation."""
        prog = self._ensure_fused_program()
        det, rec = self.text_detector, self.text_recognizer
        lp = self.layout.layout_parser
        tsr = self.layout.table_structure_recognizer
        mesh = dp_mesh(self.num_devices, device_type=det.device.type)
        det_hws = [shortest_edge_size(*img.shape[:2], det._cfg.data.shortest_size,
                                      det._cfg.data.limit_size) for img in imgs]

        def post_one(i, page, wire):
            results_det, _, layout_schema = self._fused_host_postwire(imgs[i], page, *wire)
            rec_page = page if lies_on(page, rec.device) else None
            results_rec, _ = rec(imgs[i], results_det.points, None, page=rec_page)
            with segment("aggregate", "host"):
                results_ocr = OCRSchema(words=ocr_aggregate(results_det, results_rec))
                outputs = self.aggregate(results_ocr, layout_schema)
            return DocumentAnalyzerSchema(**outputs), None, None

        return run_page_chunks(
            prog, imgs, det_hws, tuple(lp._cfg.data.img_size), tuple(tsr._cfg.data.img_size),
            det.device, dp_chunk_pages(mesh, len(imgs)), post_one, self._dp_pools,
            self._workers)

    def _batch_dp_host(self, imgs):
        """Stage-batched analysis with the host's crops (the JAX package's
        route where device crops are off): each stage runs one forward over
        every page's inputs (same-size detector pages, layout tiles, table
        crops, then every page's lines in one bucketed recognizer stream),
        split over the replicas where a mesh is attached and the batch
        divides (``place_batch``); the host steps stay per page."""
        det, rec = self.text_detector, self.text_recognizer
        lp = self.layout.layout_parser
        tsr = self.layout.table_structure_recognizer
        n = len(imgs)

        # the detector: same-size pages in one forward
        buckets = defaultdict(list)
        for i, img in enumerate(imgs):
            tensor = det.preprocess_u8(img)
            buckets[tensor.shape[1:3]].append((i, tensor[0]))
        det_results = [None] * n
        for members in buckets.values():
            maps = det.model.forward_binary_u8(np.stack([t for _, t in members]))
            for (i, _), prob in zip(members, maps):
                with segment("det", "contours"):
                    quads, scores = det.postprocess({"binary": prob[None]}, imgs[i].shape[:2])
                det_results[i] = TextDetectorSchema(points=quads, scores=scores)

        # the layout: every page's tile in one forward
        preds = lp.model(np.concatenate([lp.preprocess(img) for img in imgs]))
        sizes = [[img.shape[1], img.shape[0]] for img in imgs]
        layout_results = [LayoutParserSchema(**lp.filtering_elements(one))
                          for one in lp.postprocessor(preds, sizes, lp.thresh_score)]

        # the table recognizer: every table of every page in one forward
        tsr_data, owners = [], []
        for i, lres in enumerate(layout_results):
            data = tsr.preprocess(imgs[i], [t.box for t in lres.tables])
            tsr_data.extend(data)
            owners.extend([i] * len(data))
        page_tables = [[] for _ in range(n)]
        if tsr_data:
            preds = tsr.model(np.stack([d["array"] for d in tsr_data]))
            sizes = [[d["size"][1], d["size"][0]] for d in tsr_data]
            filtered = tsr.postprocessor(preds, sizes, tsr.thresh_score)
            for owner, d, one in zip(owners, tsr_data, filtered):
                page_tables[owner].extend(tsr.tables_from_filtered([d], [one]))
        layouts = [
            LayoutAnalyzerSchema(paragraphs=lres.paragraphs, tables=page_tables[i],
                                 figures=lres.figures)
            for i, lres in enumerate(layout_results)]
        if self.split_text_across_cells:
            det_results = [_split_text_across_cells(d, lay)
                           for d, lay in zip(det_results, layouts)]

        # the recognizer: every page's lines in one bucketed stream
        datasets = [ParseqDataset(rec._cfg, imgs[i], det_results[i].points)
                    for i in range(n)]
        crops = [ds.as_u8_array() for ds in datasets]
        all_points = [q for ds in datasets for q in ds.valid_quads]
        nonempty = [c for c in crops if len(c)]
        preds = scores = directions = []
        if nonempty:
            preds, scores, directions = rec._run_batch_inference(
                np.concatenate(nonempty), all_points)

        results, offset = [], 0
        for i, ds in enumerate(datasets):
            c = len(crops[i])
            p = list(preds[offset:offset + c])
            s = list(scores[offset:offset + c])
            d = list(directions[offset:offset + c])
            offset += c
            if rec.rec_orientation_fallback and c:
                rec._apply_orientation_fallback(ds, ds.valid_quads, p, s, d)
            rec_res = TextRecognizerSchema(contents=p, scores=s, points=ds.valid_quads,
                                           directions=d)
            with segment("aggregate", "host"):
                ocr = OCRSchema(words=ocr_aggregate(det_results[i], rec_res))
                outputs = self.aggregate(ocr, layouts[i])
            results.append((DocumentAnalyzerSchema(**outputs), None, None))
        return results
