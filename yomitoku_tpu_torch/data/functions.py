"""Host-side image preprocessing (the port's copy of what it calls of
yomitoku_tpu/data/functions.py): the detector's shortest-edge resize, the
ImageNet statistics DBNet standardises with, and the crop, rotate and pad
steps of the recognizer's ``ParseqDataset``; ``load_image`` and
``validate_image`` re-exported from ``.image``, and ``load_pdf`` and
``PdfPageIterator`` from ``.pdf``, as the JAX module does."""

import cv2
import numpy as np

from .image import load_image, validate_image  # re-export  # noqa: F401
from .pdf import load_pdf, PdfPageIterator  # re-export  # noqa: F401

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def shortest_edge_size(
    h: int, w: int, shortest_edge_length: int, max_length: int
):
    """Target (newh, neww) of resize_shortest_edge without resizing."""
    scale = shortest_edge_length / min(h, w)
    if h < w:
        new_h, new_w = shortest_edge_length, int(w * scale)
    else:
        new_h, new_w = int(h * scale), shortest_edge_length

    if max(new_h, new_w) > max_length:
        scale = float(max_length) / max(new_h, new_w)
        new_h, new_w = int(new_h * scale), int(new_w * scale)

    neww = max(int(new_w / 32) * 32, 32)
    newh = max(int(new_h / 32) * 32, 32)
    return newh, neww


def resize_shortest_edge(
    img: np.ndarray, shortest_edge_length: int, max_length: int
) -> np.ndarray:
    """Resize so the short side hits ``shortest_edge_length`` (long side capped
    at ``max_length``), then snap both dims down to multiples of 32."""
    h, w = img.shape[:2]
    newh, neww = shortest_edge_size(h, w, shortest_edge_length, max_length)
    return cv2.resize(img, (neww, newh), interpolation=cv2.INTER_AREA)


def validate_quads(img: np.ndarray, quad) -> bool:
    """Quad must have 4 two-value points and lie inside the image; returns
    None (falsy) on invalid input, as the JAX package does."""
    if len(quad) != 4:
        return None
    for point in quad:
        if len(point) != 2:
            return None
    q = np.array(quad, dtype=int)
    h, w = img.shape[:2]
    if q[:, 0].min() < 0 or q[:, 0].max() > w or q[:, 1].min() < 0 or q[:, 1].max() > h:
        return None
    return True


def extract_roi_with_perspective(img: np.ndarray, quad) -> np.ndarray:
    """Perspective-rectify one word quad to an axis-aligned crop: crop the
    bounding box first, then warp to the size (|p0-p1|, |p1-p2|)."""
    quad = np.array(quad, dtype=np.int64)
    roi = img[
        quad[:, 1].min() : quad[:, 1].max(),
        quad[:, 0].min() : quad[:, 0].max(),
        :,
    ]
    quad = quad - quad.min(axis=0)
    width = int(np.linalg.norm(quad[0] - quad[1]))
    height = int(np.linalg.norm(quad[1] - quad[2]))
    # Axis-aligned quads need no warp: the bbox crop IS the rectified crop
    # (bit-identical to the warp for identity transforms).
    x2, y2 = quad[:, 0].max(), quad[:, 1].max()
    if (
        quad[0, 0] == 0 and quad[0, 1] == 0
        and quad[1, 0] == x2 and quad[1, 1] == 0
        and quad[2, 0] == x2 and quad[2, 1] == y2
        and quad[3, 0] == 0 and quad[3, 1] == y2
        and width == x2 and height == y2
        # quads beyond the image clip the bbox crop; the warp pads those
        # rows/cols with black instead — fall through
        and roi.shape[0] == height and roi.shape[1] == width
    ):
        return np.ascontiguousarray(roi)
    src = np.float32(quad)
    dst = np.float32([[0, 0], [width, 0], [width, height], [0, height]])
    M = cv2.getPerspectiveTransform(src, dst)
    return cv2.warpPerspective(roi, M, (width, height))


def rotate_text_image(img: np.ndarray, thresh_aspect: float = 2) -> np.ndarray:
    """Rotate 90deg CCW when the crop is a vertical line (h > thresh * w)."""
    h, w = img.shape[:2]
    if h > thresh_aspect * w:
        img = cv2.rotate(img, cv2.ROTATE_90_COUNTERCLOCKWISE)
    return img


def resize_with_padding(img, target_size, background_color=(0, 0, 0)):
    """Fit into (target_h, target_w) canvas top-left, shrink-only, keep AR."""
    h, w = img.shape[:2]
    scale_w = target_size[1] / w if w > target_size[1] else 1.0
    scale_h = target_size[0] / h if h > target_size[0] else 1.0
    scale = min(scale_w, scale_h)
    new_w, new_h = int(w * scale), int(h * scale)

    resized = cv2.resize(img, (new_w, new_h), interpolation=cv2.INTER_AREA)
    canvas = np.zeros((target_size[0], target_size[1], 3), dtype=np.uint8)
    canvas[:, :] = background_color
    canvas[:new_h, :new_w, :] = resized
    return canvas
