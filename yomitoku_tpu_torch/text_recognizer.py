"""TextRecognizer task module, PARSeq (counterpart of
yomitoku_tpu/text_recognizer.py).

The host-crop route: ``ParseqDataset`` cuts, rotates and pads each line
quad on the host; batches are padded to the buckets (1, 8, 32, 128) and
decoded on the device; only the greedy (ids, probs) come back; strings
are NFKC-normalised.  This is the route the JAX package takes wherever its
device crops are off.  On a real-checkpoint load with the int8 memory-K/V
cache at its default, the model audits that cache once, as in the JAX
package.  ``rec_orientation_fallback`` re-reads the lines that score below
its threshold rotated by 180 degrees and keeps the better reading, as the
JAX package's host route does.  Not ported yet: device crops (``page=``
raises), width buckets and ``num_devices`` beyond 1.
"""

import os
import unicodedata

import cv2
import numpy as np

from .base import BaseModelCatalog, BaseModule, check_no_page, check_num_devices
from .configs import (
    TextRecognizerPARSeqConfig,
    TextRecognizerPARSeqLargeV41Config,
    TextRecognizerPARSeqSmallConfig,
    TextRecognizerPARSeqTinyConfig,
    TextRecognizerPARSeqV2Config,
)
from .data.dataset import ParseqDataset
from .data.functions import resize_with_padding
from .models.parseq import PARSeq
from .postprocessor.parseq_tokenizer import ParseqTokenizer
from .schemas import TextRecognizerSchema
from .utils.misc import load_charset

#: Batch-size buckets (padded), as in the JAX package
BATCH_BUCKETS = (1, 8, 32, 128)


def bucket_batch_size(n: int, max_batch: int) -> int:
    for b in BATCH_BUCKETS:
        if n <= b and b <= max_batch:
            return b
    return max_batch


class TextRecognizerModelCatalog(BaseModelCatalog):
    def __init__(self):
        super().__init__()
        self.register("parseq", TextRecognizerPARSeqConfig, PARSeq)
        self.register("parseqv2", TextRecognizerPARSeqV2Config, PARSeq)
        self.register("parseq-small", TextRecognizerPARSeqSmallConfig, PARSeq)
        self.register("parseq-tiny", TextRecognizerPARSeqTinyConfig, PARSeq)
        self.register("parseq-large-v4_1", TextRecognizerPARSeqLargeV41Config, PARSeq)


class TextRecognizer(BaseModule):
    model_catalog = TextRecognizerModelCatalog()

    def __init__(
        self,
        model_name="parseq-large-v4_1",
        path_cfg=None,
        device="cuda",
        visualize=False,
        from_pretrained=True,
        infer_onnx=False,  # accepted, as in the JAX package; unused
        rec_orientation_fallback=False,
        rec_orientation_fallback_thresh=0.75,
        num_devices=None,
        dtype=None,
    ):
        super().__init__()
        check_num_devices(num_devices)
        self.load_model(model_name, path_cfg, device=device,
                        from_pretrained=from_pretrained, dtype=dtype)
        # audit the int8 memory-K/V default on real weights, unless the
        # user chose (YOMITOKU_TPU_INT8_KV) or asked to skip it
        if (
            self.model.int8_kv
            and self.model.pretrained_source is not None
            and not os.environ.get("YOMITOKU_TPU_INT8_KV")
            and not os.environ.get("YOMITOKU_TPU_SKIP_INT8_AUDIT")
        ):
            self.model.audit_int8_kv()
        self.charset = load_charset(self._cfg.charset)
        self.tokenizer = ParseqTokenizer(self.charset)
        self.visualize = visualize
        self.rec_orientation_fallback = rec_orientation_fallback
        self.rec_orientation_fallback_thresh = rec_orientation_fallback_thresh

    def preprocess(self, img, polygons):
        if polygons is None:
            h, w = img.shape[:2]
            polygons = [[[0, 0], [w, 0], [w, h], [0, h]]]
        return ParseqDataset(self._cfg, img, polygons), polygons

    def _infer_padded(self, chunk: np.ndarray):
        """Pad a chunk to its batch bucket, decode, strip the padding."""
        n = len(chunk)
        target = bucket_batch_size(n, self._cfg.data.batch_size)
        if n < target:
            pad = np.zeros((target - n,) + chunk.shape[1:], chunk.dtype)
            chunk = np.concatenate([chunk, pad], axis=0)
        ids, probs = self.model.forward_tokens(chunk)
        return ids[:n], probs[:n]

    def postprocess(self, ids_probs, points):
        preds, scores = self.tokenizer.decode_ids(*ids_probs)
        preds = [unicodedata.normalize("NFKC", x) for x in preds]
        directions = []
        for point in points:
            point = np.array(point)
            w = np.linalg.norm(point[0] - point[1])
            h = np.linalg.norm(point[1] - point[2])
            directions.append("vertical" if h > w * 2 else "horizontal")
        return preds, scores, directions

    def _run_batch_inference(self, batch: np.ndarray, points):
        preds, scores, directions = [], [], []
        bs = self._cfg.data.batch_size
        for i in range(0, len(batch), bs):
            p, s, d = self.postprocess(
                self._infer_padded(batch[i:i + bs]), points[i:i + bs]
            )
            preds.extend(p)
            scores.extend(s)
            directions.extend(d)
        return preds, scores, directions

    def _apply_orientation_fallback(self, dataset, points, preds, scores, directions):
        """Re-read the lines scoring below the threshold from their ROI
        crops rotated by 180 degrees; keep a reading that scores higher
        and reaches the threshold (JAX text_recognizer.py, host route)."""
        thresh = self.rec_orientation_fallback_thresh
        retry = [i for i, s in enumerate(scores) if s < thresh]
        if not retry:
            return
        img_size = self._cfg.data.img_size
        batch = np.stack([
            resize_with_padding(cv2.rotate(dataset.roi_images[i], cv2.ROTATE_180), img_size)
            for i in retry
        ])
        r_preds, r_scores, r_dirs = self._run_batch_inference(batch, [points[i] for i in retry])
        for j, idx in enumerate(retry):
            if r_scores[j] > scores[idx] and r_scores[j] >= thresh:
                preds[idx] = r_preds[j]
                scores[idx] = r_scores[j]
                directions[idx] = r_dirs[j]

    def __call__(self, img, points=None, vis=None, page=None):
        """Recognize text lines in ``img`` (BGR) at the given quads ->
        (TextRecognizerSchema, vis); ``vis`` is drawn on when given."""
        check_no_page(page)
        dataset, _ = self.preprocess(img, points)
        valid_points = dataset.valid_quads
        preds, scores, directions = self._run_batch_inference(
            dataset.as_u8_array(), valid_points
        )
        if self.rec_orientation_fallback:
            self._apply_orientation_fallback(dataset, valid_points, preds, scores, directions)
        results = TextRecognizerSchema(
            contents=preds, scores=scores, points=valid_points,
            directions=directions,
        )
        if self.visualize:
            from .utils.visualizer import rec_visualizer

            vis = rec_visualizer(
                img.copy() if vis is None else vis,
                results,
                font_size=self._cfg.visualize.font_size,
                font_color=tuple(self._cfg.visualize.color[::-1]),
                font_path=self._cfg.visualize.font,
            )
        return results, vis
