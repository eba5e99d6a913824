"""CellDetector (beta): per-table cell and role detection with hole
mining (the port's copy of yomitoku_tpu/table_cell_detector.py).

RT-DETRv2 at 640x640 with 2,500 queries over 8 classes {table, cell,
form, header, check, select, group, empty}: the page's tables cropped
and resized (on the host, or on the device from ``page=``, a shared
ops.device_crop.DevicePage, through the table recognizer's
``filtered_regions_from_page``), one batched forward and one readback of
every table's top-k, then the host filters: containment within a
category keeps the smaller box, groups contained in another group go,
headers and empties inside a cell go, holes (uncovered rectangles found
by masking the cells, morphology and a flood fill) adjacent to cells in
at least three directions take the majority role, and the whole table
stands in as group and cell where the model found none.

The JAX module imports JAX at module level, so its host helpers are
repeated here.
"""

import cv2
import numpy as np

from .base import BaseModelCatalog, BaseModule, check_num_devices
from .configs import TableCellParserRTDETRv2BetaConfig
from .models.rtdetr import RTDETRv2
from .postprocessor.rtdetr_postprocessor import RTDETRPostProcessor
from .schemas.table_semantic_parser import CellSchema, TableDetectorSchema
from .table_structure_recognizer import filtered_regions_from_page
from .utils.misc import (
    calc_iou,
    containment_matrix,
    filter_by_flag,
    is_bottom_adjacent,
    is_right_adjacent,
)


class TableParserModelCatalog(BaseModelCatalog):
    def __init__(self):
        super().__init__()
        self.register("rtdetrv2_beta", TableCellParserRTDETRv2BetaConfig, RTDETRv2)


def filter_contained_rectangles_with_category(category_elements, ignore_categories=()):
    """Within a category, mutual containment keeps the SMALLER box and
    one-way containment drops the OUTER box (reference
    table_cell_detector.py:31 — note: opposite of the layout-parser rule)."""
    for category, elements in category_elements.items():
        if category in ignore_categories:
            continue
        boxes = [e["box"] for e in elements]
        n = len(boxes)
        if n <= 1:
            continue
        # vectorized pairwise containment: inside[i, j] ==
        # is_contained(box_i, box_j)
        inside = containment_matrix(boxes, boxes)
        b = np.asarray(boxes, np.float64)
        area = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
        upper = np.triu(np.ones((n, n), bool), 1)  # pairs i < j
        both = inside & inside.T
        ij_only = inside & ~inside.T
        ji_only = inside.T & ~inside
        a_gt = area[:, None] > area[None, :]
        drop_j = upper & ((both & a_gt) | ji_only)     # marks column j
        drop_i = upper & ((both & ~a_gt) | ij_only)    # marks row i
        dropped = drop_i.any(axis=1) | drop_j.any(axis=0)
        category_elements[category] = filter_by_flag(
            elements, (~dropped).tolist()
        )
    return category_elements


def filter_contained_groups(category_elements):
    """Drop groups contained (0.9) in another group (keep the outer)."""
    groups = category_elements.get("group", [])
    n = len(groups)
    if n <= 1:
        return category_elements
    boxes = [g["box"] for g in groups]
    inside = containment_matrix(boxes, boxes, threshold=0.9)
    # pairs with identical boxes (or self) never drop each other
    b = np.asarray(boxes, np.float64)
    same = (b[:, None, :] == b[None, :, :]).all(-1)
    # drop i when some j (box differs) contains i: inside[j, i]
    dropped = (inside.T & ~same).any(axis=1)
    category_elements["group"] = filter_by_flag(groups, (~dropped).tolist())
    return category_elements


def filter_contained_rectangles_across_categories(category_elements, source, target):
    src_boxes = [e["box"] for e in category_elements[source]]
    tgt_boxes = [e["box"] for e in category_elements[target]]
    if src_boxes and tgt_boxes:
        dropped = containment_matrix(src_boxes, tgt_boxes).any(axis=0)
        check_list = (~dropped).tolist()
    else:
        check_list = [True] * len(tgt_boxes)
    category_elements[target] = filter_by_flag(category_elements[target], check_list)
    return category_elements


def find_holes_as_rects(table_shape, cell_boxes, pad=2, close_ksize=5, min_area=300):
    """Mask detected cells, morphology-open, floodfill from the border;
    remaining white regions are uncovered holes (reference :105)."""
    mask = np.full((table_shape[0], table_shape[1]), 255, np.uint8)
    for bx1, by1, bx2, by2 in cell_boxes:
        cv2.rectangle(
            mask, (int(bx1), int(by1)), (int(bx2), int(by2)), 0, thickness=-1
        )
    if close_ksize > 1:
        k = cv2.getStructuringElement(cv2.MORPH_RECT, (close_ksize, close_ksize))
        mask = cv2.morphologyEx(mask, cv2.MORPH_OPEN, k, iterations=3)
    ff = mask.copy()
    h, w = ff.shape
    flood_mask = np.zeros((h + 2, w + 2), np.uint8)
    cv2.floodFill(ff, flood_mask, (0, 0), 0)
    cnts, _ = cv2.findContours(ff, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)
    rects = []
    for c in cnts:
        x, y, rw, rh = cv2.boundingRect(c)
        if rw * rh < min_area:
            continue
        rects.append([x - pad, y - pad, x + rw + pad, y + rh + pad])
    return rects


def choose_role(role_counts):
    if not role_counts:
        return None
    max_count = max(role_counts.values())
    candidates = [r for r, c in role_counts.items() if c == max_count]
    if len(candidates) > 1 and "cell" in candidates:
        return "cell"
    return candidates[0]


def calc_adjacent_holes_to_cells(holes, cells):
    """Keep holes adjacent (R/L/D/U) to cells in >2 directions; assign the
    majority role of the adjacent cells (reference :148)."""
    kept_holes = []
    for hole in holes:
        edge_counts = {d: 0 for d in "RLDU"}
        role_counts = {r: 0 for r in ("cell", "header", "empty")}
        for node in cells:
            if is_right_adjacent(hole["box"], node["box"]):
                edge_counts["R"] += 1
                role_counts[node["role"]] += 1
            if is_right_adjacent(node["box"], hole["box"]):
                edge_counts["L"] += 1
                role_counts[node["role"]] += 1
            if is_bottom_adjacent(hole["box"], node["box"]):
                edge_counts["D"] += 1
                role_counts[node["role"]] += 1
            if is_bottom_adjacent(node["box"], hole["box"]):
                edge_counts["U"] += 1
                role_counts[node["role"]] += 1
        if sum(c > 0 for c in edge_counts.values()) > 2:
            hole["role"] = choose_role(role_counts)
            kept_holes.append(hole)
    return kept_holes


class CellDetector(BaseModule):
    model_catalog = TableParserModelCatalog()

    def __init__(
        self,
        model_name="rtdetrv2_beta",
        path_cfg=None,
        device="cuda",
        visualize=False,
        from_pretrained=True,
        infer_onnx=False,  # accepted, as in the JAX package; unused
        num_devices=None,
        dtype=None,
    ):
        super().__init__()
        check_num_devices(num_devices)
        self.load_model(model_name, path_cfg, device=device,
                        from_pretrained=from_pretrained, dtype=dtype)
        self.visualize = visualize
        self.postprocessor = RTDETRPostProcessor(
            num_classes=self._cfg.RTDETRTransformerv2.num_classes,
            num_top_queries=self._cfg.RTDETRTransformerv2.num_queries,
        )
        self.postprocessor.trace_stage = "cell"
        self.thresh_score = self._cfg.thresh_score
        self.label_mapper = dict(enumerate(self._cfg.category))

    def preprocess(self, img, tables):
        cv_img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
        table_imgs = []
        for table in tables:
            x1, y1, x2, y2 = map(int, table.box)
            crop = cv_img[y1:y2, x1:x2, :]
            th, tw = crop.shape[:2]
            resized = cv2.resize(
                crop,
                (self._cfg.data.img_size[1], self._cfg.data.img_size[0]),
                interpolation=cv2.INTER_AREA,
            )
            table_imgs.append(
                {
                    "array": resized,  # uint8; scaled on the device
                    "size": (th, tw),
                    "offset": (x1, y1),
                }
            )
        return table_imgs

    def is_fully_contained(self, box1, box2, threshold=0.9):
        return calc_iou(box1, box2) >= threshold

    def postprocess(self, preds, data, table_box):
        """``preds``: one already-filtered {labels, boxes, scores} dict."""
        h, w = data["size"]  # crop size: boxes are in crop coordinates

        category_elements = {c: [] for c in self.label_mapper.values()}
        category_elements["hole"] = []
        for box, score, label in zip(
            preds["boxes"], preds["scores"], preds["labels"]
        ):
            category = self.label_mapper[int(label)]
            box = box.astype(int).tolist()
            # drop detections that are just the whole table
            if self.is_fully_contained(box, [0, 0, w, h]):
                continue
            category_elements[category].append(
                {"box": box, "score": float(score), "role": category}
            )

        category_elements = filter_contained_rectangles_with_category(
            category_elements, ignore_categories=["group"]
        )
        category_elements = filter_contained_groups(category_elements)
        category_elements = filter_contained_rectangles_across_categories(
            category_elements, source="cell", target="header"
        )
        category_elements = filter_contained_rectangles_across_categories(
            category_elements, source="cell", target="empty"
        )

        cell_boxes = (
            category_elements["cell"]
            + category_elements["header"]
            + category_elements["empty"]
        )
        for box in find_holes_as_rects(
            data["size"], [c["box"] for c in cell_boxes]
        ):
            category_elements["hole"].append(
                {"box": box, "score": 1.0, "role": "hole"}
            )

        for cells in category_elements.values():
            for cell in cells:
                cell["box"][0] += data["offset"][0]
                cell["box"][1] += data["offset"][1]
                cell["box"][2] += data["offset"][0]
                cell["box"][3] += data["offset"][1]

        # fallbacks: whole table as group / cell
        if len(category_elements["group"]) == 0:
            category_elements["group"] = [{"box": table_box, "role": "group"}]
        if (
            len(
                category_elements["cell"]
                + category_elements["empty"]
                + category_elements["header"]
            )
            == 0
        ):
            category_elements["cell"] = [{"box": table_box, "role": "cell"}]

        cells = self.extract_cell_elements(category_elements)
        return self.remove_noise_cells(cells, min_width=10, min_height=10)

    def remove_noise_cells(self, cells, min_width=30, min_height=30):
        return [
            c
            for c in cells
            if (c.box[2] - c.box[0]) > min_width
            and (c.box[3] - c.box[1]) > min_height
        ]

    def extract_cell_elements(self, elements):
        elements["hole"] = calc_adjacent_holes_to_cells(
            elements["hole"],
            elements["cell"] + elements["header"] + elements["empty"],
        )
        cells = []
        for category, values in elements.items():
            if category in ("cell", "header", "empty", "group", "hole"):
                for value in values:
                    cells.append(
                        CellSchema(
                            id=f"c{len(cells)}",
                            box=value["box"],
                            role=value["role"],
                            contents=None,
                            row=None,
                            col=None,
                            row_span=None,
                            col_span=None,
                        )
                    )
        return cells

    def _preprocess_meta(self, img, tables):
        """Page-path preprocess: sizes/offsets only (crop+resize on device)."""
        h, w = img.shape[:2]
        out = []
        for table in tables:
            x1, y1, x2, y2 = map(int, table.box)
            x1, y1 = max(0, x1), max(0, y1)
            x2, y2 = min(w, x2), min(h, y2)
            out.append({"size": (y2 - y1, x2 - x1), "offset": (x1, y1)})
        return out

    def __call__(self, img, tables, page=None):
        """Detect the cells of each table of a BGR image (``tables``: the
        layout parser's table elements) -> [TableDetectorSchema], one per
        table with cells.  With ``page`` (a DevicePage of ``img``) the
        crops run on the device."""
        data = (
            self._preprocess_meta(img, tables)
            if page is not None
            else self.preprocess(img, tables)
        )
        outputs = []
        if data:
            # one batched forward over all tables, one readback for all
            if page is not None:
                filtered = filtered_regions_from_page(
                    self.model, page, data,
                    tuple(self._cfg.data.img_size),
                    self.postprocessor, self.thresh_score,
                )
            else:
                preds = self.model(np.stack([d["array"] for d in data]))
                sizes = [[d["size"][1], d["size"][0]] for d in data]
                filtered = self.postprocessor(preds, sizes, self.thresh_score)
            for one, (d, table) in zip(filtered, zip(data, tables)):
                cells = self.postprocess(one, d, table.box)
                if len(cells) == 0:
                    continue
                outputs.append(
                    TableDetectorSchema(
                        id=None, box=table.box, role=table.role, cells=cells
                    )
                )
        return outputs
