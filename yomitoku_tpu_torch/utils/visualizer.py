"""Visualisation of the task results (the port's copy of
``det_visualizer``, ``rec_visualizer``, ``layout_visualizer``,
``table_visualizer``, ``cell_detector_visualizer`` and
``reading_order_visualizer`` of yomitoku_tpu/utils/visualizer.py):
detection quads and heatmap, recognized text (vertical top-to-bottom where
PIL has libraqm), boxes per category, table cells, the cell detector's
roles and ids, and the reading-order arrows, drawn with cv2 and PIL."""

import cv2
import numpy as np
from PIL import Image, ImageDraw, ImageFont, features

from ..constants import PALETTE
from .logger import set_logger

logger = set_logger(__name__, "INFO")


def det_visualizer(img, quads, preds=None, vis_heatmap=False, line_color=(0, 255, 0)):
    """preds: (H, W) float probability map, or the u8 map (value =
    prob * 255) that the detector brings back from the device."""
    out = img.copy()
    h, w = out.shape[:2]
    if vis_heatmap and preds is not None:
        preds = np.asarray(preds)
        if preds.dtype == np.uint8:
            binary = preds
        else:
            binary = (preds * 255).astype(np.uint8)
        binary = cv2.resize(binary, (w, h), interpolation=cv2.INTER_LINEAR)
        heatmap = cv2.applyColorMap(binary, cv2.COLORMAP_JET)
        out = cv2.addWeighted(out, 0.5, heatmap, 0.5, 0)
    for quad in quads:
        quad = np.array(quad).astype(np.int32)
        out = cv2.polylines(out, [quad], True, line_color, 1)
    return out


def rec_visualizer(img, outputs, font_path, font_size=12, font_color=(255, 0, 0)):
    out = img.copy()
    pillow_img = Image.fromarray(out)
    draw = ImageDraw.Draw(pillow_img)
    has_raqm = features.check_feature(feature="raqm")
    if not has_raqm:
        logger.warning(
            "libraqm is not installed. Vertical text rendering is not "
            "supported. Rendering horizontally instead."
        )
    font = ImageFont.truetype(font_path, font_size)
    for pred, quad, direction in zip(
        outputs.contents, outputs.points, outputs.directions
    ):
        quad = np.array(quad).astype(np.int32)
        if direction == "horizontal" or not has_raqm:
            pos = (quad[0][0], quad[0][1] - font_size)
            draw.text(pos, pred, font=font, fill=font_color)
        else:
            pos = (quad[0][0] - font_size, quad[0][1])
            draw.text(pos, pred, font=font, fill=font_color, direction="ttb")
    return np.array(pillow_img)


def layout_visualizer(results, img):
    out = img.copy()
    results_dict = results.model_dump()
    for idx, (category, preds) in enumerate(results_dict.items()):
        color = PALETTE[idx % len(PALETTE)]
        for element in preds:
            box = element["box"]
            role = element.get("role")
            label = category + (f"({role})" if role else "")
            x1, y1, x2, y2 = map(int, box)
            out = cv2.rectangle(out, (x1, y1), (x2, y2), color, 2)
            out = cv2.putText(
                out, label, (x1, y1), cv2.FONT_HERSHEY_SIMPLEX, 0.5, color, 2
            )
    return out


def table_visualizer(img, table):
    out = img.copy()
    for cell in table.cells:
        x1, y1, x2, y2 = map(int, cell.box)
        text = f"[{cell.row}, {cell.col}] ({cell.row_span}x{cell.col_span})"
        out = cv2.rectangle(out, (x1, y1), (x2, y2), (255, 0, 255), 2)
        out = cv2.putText(
            out, text, (x1, y1), cv2.FONT_HERSHEY_SIMPLEX, 0.5, (255, 0, 0), 2
        )
    return out


def cell_detector_visualizer(img1, img2, cells):
    out1 = img1.copy()
    out2 = img2.copy()
    fill = np.full_like(img1, 255)
    colors = {
        "cell": (255, 128, 0),
        "empty": (255, 0, 255),
        "header": (0, 255, 0),
        "group": (255, 255, 0),
    }
    for cell in cells:
        if cell.role in ("cell", "empty", "header"):
            x1, y1, x2, y2 = map(int, cell.box)
            color = colors.get(cell.role, (200, 200, 200))
            fill = cv2.rectangle(fill, (x1, y1), (x2, y2), color, -1)
            out1 = cv2.rectangle(out1, (x1, y1), (x2, y2), color, 2)
    out1 = np.where(
        fill == 255, img1.copy(), cv2.addWeighted(img1.copy(), 0.7, fill, 0.3, 0)
    )
    for c in cells:
        x1, y1, x2, y2 = map(int, c.box)
        target = out1 if c.role != "group" else out2
        cv2.rectangle(target, (x1, y1), (x2, y2), colors.get(c.role, (200, 200, 200)), 2)
        cv2.putText(
            target,
            c.id,
            (int((x1 + x2) / 2), int((y1 + y2) / 2)),
            cv2.FONT_HERSHEY_SIMPLEX,
            0.8,
            (0, 0, 255),
            2,
        )
    return out1, out2


def _reading_order_arrows(img, elements, line_color, tip_size):
    out = img.copy()
    prev_center = None
    for i, element in enumerate(elements):
        x1, y1, x2, y2 = element.box
        center = (x1 + (x2 - x1) / 2, y1 + (y2 - y1) / 2)
        cv2.putText(
            out,
            str(i),
            (int(center[0]), int(center[1])),
            cv2.FONT_HERSHEY_SIMPLEX,
            1,
            (0, 200, 0),
            2,
        )
        if prev_center is not None:
            length = float(np.linalg.norm(np.array(center) - np.array(prev_center)))
            tip = tip_size / length if length > 0 else 0
            cv2.arrowedLine(
                out,
                (int(prev_center[0]), int(prev_center[1])),
                (int(center[0]), int(center[1])),
                line_color,
                2,
                tipLength=tip,
            )
        prev_center = center
    return out


def reading_order_visualizer(
    img, results, line_color=(0, 0, 255), tip_size=10, visualize_figure_letter=False
):
    elements = sorted(
        results.paragraphs + results.tables + results.figures, key=lambda x: x.order
    )
    out = _reading_order_arrows(img, elements, line_color, tip_size)
    if visualize_figure_letter:
        for figure in results.figures:
            out = _reading_order_arrows(
                out, figure.paragraphs, line_color=(0, 255, 0), tip_size=5
            )
    return out
