"""Visualisation of the layout results (the port's copy of
``layout_visualizer`` and ``table_visualizer`` of
yomitoku_tpu/utils/visualizer.py): boxes per category and table cells,
drawn with cv2."""

import cv2

from ..constants import PALETTE


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
