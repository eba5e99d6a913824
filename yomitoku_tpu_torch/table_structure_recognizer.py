"""TableStructureRecognizer task module, RT-DETRv2 with classes {row, col,
span} (counterpart of yomitoku_tpu/table_structure_recognizer.py): every
table box of the page cropped and resized to 640x640 on the host, one
batched forward over all of them, one readback of every table's top-k;
then cells are the row x col intersections, cells under a span box merge
into one, and boxes go back to page coordinates.  Given ``page=`` (a
shared ops.device_crop.DevicePage), the crops run on the device, in
chunks of at most 64 tables and with no padding: the model runs eagerly,
so the JAX package's batch buckets (which reuse compiled programs) would
only add work.

The JAX module imports JAX at module level, so its host helpers are
repeated here.
"""

import cv2
import numpy as np

from .base import BaseModelCatalog, BaseModule
from .configs import TableStructureRecognizerRTDETRv2Config
from .layout_parser import filter_contained_rectangles_within_category
from .models.rtdetr import RTDETRv2
from .ops.device_crop import (  # noqa: F401  (the region helpers' old home)
    collect_filtered_regions,
    dispatch_regions_from_page,
    filtered_regions_from_page,
    region_mats,
)
from .postprocessor.rtdetr_postprocessor import RTDETRPostProcessor
from .schemas import TableStructureRecognizerSchema
from .utils.misc import calc_intersection, filter_by_flag, is_contained


class TableStructureRecognizerModelCatalog(BaseModelCatalog):
    def __init__(self):
        super().__init__()
        self.register("rtdetrv2", TableStructureRecognizerRTDETRv2Config, RTDETRv2)


def extract_cells(row_boxes, col_boxes):
    """Cells are the row x col box intersections."""
    cells = []
    for i, row_box in enumerate(row_boxes):
        for j, col_box in enumerate(col_boxes):
            intersection = calc_intersection(row_box, col_box)
            if intersection is None:
                continue
            cells.append({
                "col": j + 1,
                "row": i + 1,
                "col_span": 1,
                "row_span": 1,
                "box": intersection,
                "contents": None,
            })
    return cells


def filter_contained_cells_within_spancell(cells, span_boxes):
    """Merge the cells inside a span box into one row/col-span cell."""
    check_list = [True] * len(cells)
    child_boxes = [[] for _ in span_boxes]
    for i, span_box in enumerate(span_boxes):
        for j, sub_cell in enumerate(cells):
            if is_contained(span_box, sub_cell["box"]):
                check_list[j] = False
                child_boxes[i].append(sub_cell)
    cells = filter_by_flag(cells, check_list)
    for span_box, child in zip(span_boxes, child_boxes):
        if not child:
            continue
        row = min(c["row"] for c in child)
        col = min(c["col"] for c in child)
        cells.append({
            "col": col,
            "row": row,
            "col_span": max(c["col"] for c in child) - col + 1,
            "row_span": max(c["row"] for c in child) - row + 1,
            "box": list(map(int, span_box)),
            "contents": None,
        })
    return sorted(cells, key=lambda x: (x["row"], x["col"]))


class TableStructureRecognizer(BaseModule):
    model_catalog = TableStructureRecognizerModelCatalog()

    def __init__(
        self,
        model_name="rtdetrv2",
        path_cfg=None,
        device="cuda",
        visualize=False,
        from_pretrained=True,
        infer_onnx=False,  # accepted, as in the JAX package; unused
        num_devices=None,
        dtype=None,
    ):
        super().__init__()
        self.load_model(model_name, path_cfg, device=device,
                        from_pretrained=from_pretrained, dtype=dtype)
        self.use_num_devices(num_devices)
        self.visualize = visualize
        self.postprocessor = RTDETRPostProcessor(
            num_classes=self._cfg.RTDETRTransformerv2.num_classes,
            num_top_queries=self._cfg.RTDETRTransformerv2.num_queries,
        )
        self.postprocessor.trace_stage = "tsr"
        self.thresh_score = self._cfg.thresh_score
        self.label_mapper = dict(enumerate(self._cfg.category))

    def preprocess(self, img, boxes):
        rgb = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
        h, w = self._cfg.data.img_size
        table_imgs = []
        for box in boxes:
            x1, y1, x2, y2 = map(int, box)
            crop = rgb[y1:y2, x1:x2, :]
            table_imgs.append({
                "array": cv2.resize(crop, (w, h), interpolation=cv2.INTER_AREA),
                "size": crop.shape[:2],
                "offset": (x1, y1),
            })
        return table_imgs

    def _preprocess_meta(self, img, boxes):
        """The page route's preprocess: sizes and offsets only, the boxes
        clamped to the page as the host route's array slicing clamps them."""
        h, w = img.shape[:2]
        out = []
        for box in boxes:
            x1, y1, x2, y2 = map(int, box)
            x1, y1 = max(0, x1), max(0, y1)
            x2, y2 = min(w, x2), min(h, y2)
            out.append({"size": (y2 - y1, x2 - x1), "offset": (x1, y1)})
        return out

    def postprocess(self, preds, data):
        """``preds``: one table's filtered {labels, boxes, scores}."""
        category_elements = {c: [] for c in self.label_mapper.values()}
        dx, dy = data["offset"]
        for box, score, label in zip(preds["boxes"], preds["scores"], preds["labels"]):
            x1, y1, x2, y2 = box.astype(int).tolist()
            category_elements[self.label_mapper[int(label)]].append(
                {"box": [x1 + dx, y1 + dy, x2 + dx, y2 + dy], "score": float(score)})
        category_elements = filter_contained_rectangles_within_category(
            category_elements)
        cells, rows, cols, spans = self.extract_cell_elements(category_elements)
        th, tw = data["size"]
        return TableStructureRecognizerSchema(
            box=[dx, dy, dx + tw, dy + th],
            n_row=len(rows),
            n_col=len(cols),
            rows=rows,
            cols=cols,
            spans=spans,
            cells=cells,
            order=0,
        )

    def extract_cell_elements(self, elements):
        row_boxes = sorted((e["box"] for e in elements["row"]), key=lambda x: x[1])
        col_boxes = sorted((e["box"] for e in elements["col"]), key=lambda x: x[0])
        span_boxes = [e["box"] for e in elements["span"]]
        cells = filter_contained_cells_within_spancell(
            extract_cells(row_boxes, col_boxes), span_boxes)
        rows = sorted(elements["row"], key=lambda x: x["box"][1])
        cols = sorted(elements["col"], key=lambda x: x["box"][0])
        spans = sorted(elements["span"], key=lambda x: x["box"][1])
        return cells, rows, cols, spans

    def tables_from_filtered(self, data, filtered):
        """Per-table filtered detections -> schemas; tables with no rows or
        no columns are dropped."""
        tables = [self.postprocess(one, d) for d, one in zip(data, filtered)]
        return [t for t in tables if t.n_row > 0 and t.n_col > 0]

    def __call__(self, img, table_boxes, vis=None, page=None):
        """Recognise the tables at ``table_boxes`` of a BGR image ->
        (list of TableStructureRecognizerSchema, vis).  With ``page`` (a
        DevicePage of ``img``) the crops run on the device."""
        if page is not None:
            data = self._preprocess_meta(img, table_boxes)
        else:
            data = self.preprocess(img, table_boxes)
        outputs = []
        if data:
            # one batched forward over all tables, one readback for all
            if page is not None:
                filtered = filtered_regions_from_page(
                    self.model, page, data, tuple(self._cfg.data.img_size),
                    self.postprocessor, self.thresh_score)
            else:
                preds = self.model(np.stack([d["array"] for d in data]))
                sizes = [[d["size"][1], d["size"][0]] for d in data]
                filtered = self.postprocessor(preds, sizes, self.thresh_score)
            outputs = self.tables_from_filtered(data, filtered)
        if vis is None and self.visualize:
            vis = img.copy()
        if self.visualize:
            from .utils.visualizer import table_visualizer

            for table in outputs:
                vis = table_visualizer(vis, table)
        return outputs, vis
