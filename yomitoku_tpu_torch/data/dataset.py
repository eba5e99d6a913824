"""Line-crop dataset of the PARSeq recognizer (the port's copy of what it
calls of yomitoku_tpu/data/dataset.py): thread-pool perspective crop,
rotate and pad of the word quads at construction, keeping the unpadded
ROI crops for the 180-degree orientation fallback; the crops come out as
one NHWC uint8 batch."""

from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .functions import (
    extract_roi_with_perspective,
    resize_with_padding,
    rotate_text_image,
    validate_quads,
)


class ParseqDataset:
    def __init__(self, cfg, img, quads, num_workers: int = 8):
        self.img = img[:, :, ::-1]  # BGR -> RGB
        self.quads = quads
        self.cfg = cfg

        with ThreadPoolExecutor(max_workers=num_workers) as executor:
            data = list(executor.map(self.preprocess, self.quads))

        self.data = [d[0] for d in data if d is not None]
        self.roi_images = [d[1] for d in data if d is not None]
        self.valid_quads = [q for q, d in zip(self.quads, data) if d is not None]

    def preprocess(self, quad):
        if validate_quads(self.img, quad) is None:
            return None
        roi_img = extract_roi_with_perspective(self.img, quad)
        if roi_img is None or roi_img.size == 0:
            return None
        roi_img = rotate_text_image(roi_img, thresh_aspect=2)
        return resize_with_padding(roi_img, self.cfg.data.img_size), roi_img

    def __len__(self):
        return len(self.data)

    def as_u8_array(self) -> np.ndarray:
        """All crops as one (N, H, W, 3) uint8 batch (normalised on the
        device: a 4x smaller upload)."""
        if not self.data:
            h, w = self.cfg.data.img_size
            return np.zeros((0, h, w, 3), np.uint8)
        return np.stack(self.data)
