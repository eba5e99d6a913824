"""DBNet postprocessor: probability map -> word quads + scores (the port's
copy of yomitoku_tpu/postprocessor/dbnet_postprocessor.py).

Threshold, connected contours, min-area-rect quads, box score,
size-adaptive unclip, rescale to the original image size.  The unclip of a
min-area-rect quad followed by a re-fitted min-area rect is exactly the
rect grown by the offset distance on every side, so it is computed
analytically (same center and angle, w+2d, h+2d), with no polygon-clipping
dependency.
"""

import math
import os

import cv2
import numpy as np

from ..utils.logger import set_logger

logger = set_logger(__name__, "INFO")


def _order_rect_points(points, sside):
    """cv2.boxPoints order -> [top-left, top-right, bottom-right,
    bottom-left] (the reference's get_mini_boxes)."""
    points = sorted(points, key=lambda x: x[0])
    i1, i4 = (0, 1) if points[1][1] > points[0][1] else (1, 0)
    i2, i3 = (2, 3) if points[3][1] > points[2][1] else (3, 2)
    return [points[i1], points[i2], points[i3], points[i4]], sside


class DBnetPostProcessor:
    """Probability map -> quads.  Two implementations, as in the JAX package:

      * native (default): C++ run-length CCL + rotating calipers
        (csrc/dbnet_post.cpp, the port's own build).  Box score = mean probability over the
        filled outer contour (foreground pixels + enclosed holes), the
        same region cv2.fillPoly covers in the reference.
      * cv2 fallback (YOMITOKU_TPU_NO_NATIVE_POST=1, or no C++ toolchain):
        cv2.findContours + minAreaRect; box score = mean over the filled
        outer-contour polygon, as in the reference.

    Remaining intentional divergence: the reference's RETR_LIST also emits
    each hole *boundary* as its own candidate contour; those score around
    the hole's sub-threshold probabilities and are dropped by box_thresh,
    so the native path does not emulate them.
    """

    _native_ok = None  # class-level tri-state: None=untried, False=failed

    def __init__(self, min_size, thresh, box_thresh, max_candidates, unclip_ratio):
        self.min_size = min_size
        self.thresh = thresh
        self.box_thresh = box_thresh
        self.max_candidates = max_candidates
        self.unclip_ratio = unclip_ratio

    def __call__(self, preds, image_size):
        """preds: {"binary": (1, H, W) float ndarray, or uint8 wire map
        (value = prob*255) on the accelerator path}; image_size (h, w)
        of the original image."""
        pred = np.asarray(preds["binary"])[0]
        height, width = image_size
        if self._native_ok is not False and not os.environ.get(
            "YOMITOKU_TPU_NO_NATIVE_POST"
        ):
            try:
                from ..native import dbnet_boxes

                out = dbnet_boxes(
                    pred,
                    self.thresh,
                    self.box_thresh,
                    self.unclip_ratio,
                    self.min_size,
                    self.max_candidates,
                    width,
                    height,
                )
                DBnetPostProcessor._native_ok = True
                return out
            except Exception as e:
                # Cache the failure: without a C++ toolchain the build
                # subprocess would otherwise be re-spawned on every page.
                DBnetPostProcessor._native_ok = False
                logger.warning(
                    "native dbnet_post unavailable (%s); using the cv2 "
                    "fallback for this process", e,
                )
        if pred.dtype == np.uint8:  # u8 wire map: only native skips this
            pred = pred.astype(np.float32) * (1.0 / 255.0)
        segmentation = pred > self.thresh
        return self.boxes_from_bitmap(pred, segmentation, width, height)

    def boxes_from_bitmap(self, pred, bitmap, dest_width, dest_height):
        height, width = bitmap.shape
        contours, _ = cv2.findContours(
            (bitmap * 255).astype(np.uint8), cv2.RETR_LIST, cv2.CHAIN_APPROX_SIMPLE
        )
        boxes, scores = [], []
        for contour in contours[: self.max_candidates]:
            contour = contour.squeeze(1)
            rect = cv2.minAreaRect(contour)
            if min(rect[1]) < self.min_size:
                continue
            score = self.box_score_fast(pred, contour)
            if score < self.box_thresh:
                continue

            box, sside = self.unclip_rect(rect)
            if sside < self.min_size + 2:
                continue
            box = np.array(box)
            box[:, 0] = np.clip(np.round(box[:, 0] / width * dest_width), 0, dest_width)
            box[:, 1] = np.clip(
                np.round(box[:, 1] / height * dest_height), 0, dest_height
            )
            boxes.append(box.astype(np.int16).tolist())
            scores.append(float(score))
        return boxes, scores

    def unclip_rect(self, rect):
        """Size-adaptive unclip (reference dbnet_postporcessor.py:84-98)
        applied analytically to the min-area rect."""
        (cx, cy), (rw, rh), angle = rect
        quad = cv2.boxPoints(rect)
        w = quad[:, 0].max() - quad[:, 0].min()
        h = quad[:, 1].max() - quad[:, 1].min()
        box_dist = min(w, h)
        if box_dist <= 0:
            return [p.tolist() for p in quad], 0.0
        ratio = self.unclip_ratio / math.sqrt(box_dist)
        area = rw * rh
        length = 2 * (rw + rh)
        if length <= 0:
            return [p.tolist() for p in quad], 0.0
        distance = area * ratio / length
        grown = ((cx, cy), (rw + 2 * distance, rh + 2 * distance), angle)
        pts = [p.tolist() for p in cv2.boxPoints(grown)]
        return _order_rect_points(pts, min(grown[1]))

    def box_score_fast(self, pred, contour):
        """Mean probability inside the contour polygon
        (reference dbnet_postporcessor.py:126)."""
        h, w = pred.shape[:2]
        box = contour.astype(np.float64).copy()
        xmin = int(np.clip(np.floor(box[:, 0].min()), 0, w - 1))
        xmax = int(np.clip(np.ceil(box[:, 0].max()), 0, w - 1))
        ymin = int(np.clip(np.floor(box[:, 1].min()), 0, h - 1))
        ymax = int(np.clip(np.ceil(box[:, 1].max()), 0, h - 1))
        mask = np.zeros((ymax - ymin + 1, xmax - xmin + 1), dtype=np.uint8)
        box[:, 0] -= xmin
        box[:, 1] -= ymin
        cv2.fillPoly(mask, box.reshape(1, -1, 2).astype(np.int32), 1)
        region = pred[ymin : ymax + 1, xmin : xmax + 1]
        denom = mask.sum()
        return float((region * mask).sum() / denom) if denom else 0.0
