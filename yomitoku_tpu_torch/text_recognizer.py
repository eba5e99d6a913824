"""TextRecognizer task module, PARSeq (counterpart of
yomitoku_tpu/text_recognizer.py).

Two routes, as in the JAX package.  The device route (the default on
CUDA, ops.device_crop.device_crops_enabled): the page is uploaded once
(or shared by OCR as a DevicePage), each line quad becomes one 3x3
canvas->page map on the host, and the crops are sampled on the device
by the projective gather (the JAX package also has a separable program
for aligned lines, a TPU workaround for slow gathers; on the card the
gather is the faster).  Lines whose resized content fits a narrower
canvas may be routed to a width bucket (YOMITOKU_TPU_REC_WIDTH_BUCKETS, or
the load-time audit on real weights).  The host route
(YOMITOKU_TPU_HOST_CROPS=1, and the CPU's default): ``ParseqDataset``
cuts, rotates and pads each quad with cv2.  Either way batches are padded
to the buckets (1, 8, 32, 128) and decoded on the device; only the greedy
(ids, probs) come back; strings are NFKC-normalised.

On a real-checkpoint load with the int8 memory-K/V cache at its default,
the model audits that cache once, as in the JAX package.
``rec_orientation_fallback`` re-reads the lines that score below its
threshold rotated by 180 degrees and keeps the better reading: on the host
route from the rotated ROI, on the device route through the flip composed
into the map.  ``num_devices`` counts devices as the JAX package's
``dp_mesh`` does; where two or more take part the lines of a batch split
over one replica of PARSeq per device (``parallel/``).
"""

import os
import unicodedata

import cv2
import numpy as np

from .base import BaseModelCatalog, BaseModule
from .configs import (
    TextRecognizerPARSeqConfig,
    TextRecognizerPARSeqLargeV41Config,
    TextRecognizerPARSeqSmallConfig,
    TextRecognizerPARSeqTinyConfig,
    TextRecognizerPARSeqV2Config,
)
from .data.dataset import ParseqDataset
from .data.functions import resize_with_padding, validate_quads
from .models.parseq import PARSeq
from .ops.device_crop import (
    DevicePage,
    device_crops_enabled,
    line_homographies,
    page_on,
)
from .postprocessor.parseq_tokenizer import ParseqTokenizer
from .schemas import TextRecognizerSchema
from .utils.logger import set_logger
from .utils.misc import load_charset
from .utils.stagetrace import segment

logger = set_logger(__name__, "INFO")

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
        self.use_num_devices(num_devices)
        self.charset = load_charset(self._cfg.charset)
        self.tokenizer = ParseqTokenizer(self.charset)
        self.visualize = visualize
        self.rec_orientation_fallback = rec_orientation_fallback
        self.rec_orientation_fallback_thresh = rec_orientation_fallback_thresh
        # width buckets on real weights with the device route on: audit the
        # narrow canvas's greedy strings against the full canvas's and turn
        # the half-width bucket on only where all agree; random weights keep
        # buckets off (see _width_buckets)
        self._auto_width_buckets = None
        if (
            self.model.pretrained_source is not None
            and not os.environ.get("YOMITOKU_TPU_REC_WIDTH_BUCKETS")
            and not os.environ.get("YOMITOKU_TPU_SKIP_WIDTH_AUDIT")
            and self._use_device_crops()
        ):
            self._auto_width_buckets = self.audit_width_buckets()

    def _default_width_buckets(self):
        full_w = int(self._cfg.data.img_size[1])
        pw = int(self._cfg.encoder.patch_size[1])
        half = (full_w // 2) // pw * pw
        return [half] if 0 < half < full_w else None

    def audit_width_buckets(self):
        """Greedy-parity audit of the half-width bucket: a synthetic page of
        lines at several aspect ratios (wide, medium, near the bucket, one
        vertical) whose content all fits the bucket, decoded at the full
        and at the narrow canvas; the bucket is returned only when every
        string agrees.  The narrow crop is the left slice of the full one;
        what differs is the absent black padding patches, which take part
        in the encoder's attention, so the audit measures their effect on
        the loaded weights."""
        buckets = self._default_width_buckets()
        if not buckets:
            return None
        oh, ow = (int(x) for x in self._cfg.data.img_size)
        b = buckets[-1]
        rng = np.random.RandomState(0)
        h_line = min(10, oh)
        # (w_px, h_px) crops; the shrink-only resize keeps the content width
        # (a rotated line's: h_px), since every crop fits the canvas
        shapes = [(max(1, int(f * b)), h_line) for f in (0.3, 0.55, 0.8, 1.0)]
        shapes.append((max(1, min(6, int(0.2 * b))), max(1, int(0.8 * b))))
        page_w = max(w for w, _ in shapes) + 8
        page_h = sum(h + 4 for _, h in shapes) + 8
        page = np.full((page_h, page_w, 3), 255, np.uint8)
        quads, y = [], 4
        for w_px, h_px in shapes:
            page[y:y + h_px, 4:4 + w_px] = rng.randint(0, 255, (h_px, w_px, 3))
            quads.append([[4, y], [4 + w_px, y], [4 + w_px, y + h_px], [4, y + h_px]])
            y += h_px + 4
        mats, wh = line_homographies(quads, (oh, ow))
        assert int(wh[:, 0].max()) <= b, "audit line exceeds the bucket"
        page_dev = DevicePage(page, self.device).dev
        full_s, _ = self.tokenizer.decode_ids(
            *self.model.forward_tokens_from_page(page_dev, mats, wh))
        narrow_s, _ = self.tokenizer.decode_ids(
            *self.model.forward_tokens_from_page(page_dev, mats, wh, out_w=b))
        agree = sum(a == c for a, c in zip(full_s, narrow_s))
        if agree == len(full_s):
            logger.info(
                "recognizer width bucket w=%d enabled: narrow-canvas greedy "
                "audit matched the full canvas on all %d probes "
                "(YOMITOKU_TPU_REC_WIDTH_BUCKETS=0 to disable)", b, len(full_s))
            return buckets
        logger.warning(
            "recognizer width bucket disabled: narrow-canvas greedy audit "
            "diverged from the full canvas on %d/%d probes "
            "(YOMITOKU_TPU_REC_WIDTH_BUCKETS=%d to force)",
            len(full_s) - agree, len(full_s), b)
        return None

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

    # ------------------------------------------------------ device route

    def _use_device_crops(self) -> bool:
        return device_crops_enabled(self.device)

    def _infer_padded_page(self, page, mats, valid_wh, out_w=None):
        """Pad the maps to their batch bucket, crop and decode on the
        device, strip the padding."""
        n = len(mats)
        target = bucket_batch_size(n, self._cfg.data.batch_size)
        if n < target:
            pad = target - n
            # identity maps with zero extents, as the JAX package pads: the
            # padded lanes crop to black
            mats = np.concatenate([mats, np.tile(np.eye(3, dtype=np.float32), (pad, 1, 1))])
            valid_wh = np.concatenate([valid_wh, np.zeros((pad, 2), np.int32)])
        ids, probs = self.model.forward_tokens_from_page(page, mats, valid_wh, out_w=out_w)
        return ids[:n], probs[:n]

    def _width_buckets(self):
        """The width buckets in force.  A line goes to a narrower canvas
        only when its resized content width (valid_wh[0]) fits, and its
        narrow crop is the left slice of the full one; what differs from
        the reference's fixed canvas is the absent padding patches, which
        take part in the encoder's attention.  So the default is the
        load-time audit (audit_width_buckets): real weights turn the
        half-width bucket on where greedy strings agree, random weights
        keep buckets off.  YOMITOKU_TPU_REC_WIDTH_BUCKETS overrides:
        "0" / "off" turns them off, "400" or "256,512" forces those widths
        (multiples of the patch width below the full canvas), no audit."""
        env = os.environ.get("YOMITOKU_TPU_REC_WIDTH_BUCKETS", "").strip()
        if not env:
            return self._auto_width_buckets
        if env.lower() in ("0", "off", "none", "false"):
            return None
        full_w = int(self._cfg.data.img_size[1])
        pw = int(self._cfg.encoder.patch_size[1])
        buckets = []
        for tok in env.split(","):
            tok = tok.strip()
            if not tok:
                continue
            w = int(tok)
            if 0 < w < full_w and w % pw == 0:
                buckets.append(w)
        return sorted(set(buckets)) or None

    def _padded_cost(self, count, width):
        """Encoder cost of ``count`` lines at canvas ``width``, each chunk
        padded to its batch bucket: padded batch x width."""
        bs = self._cfg.data.batch_size
        whole, rem = divmod(count, bs)
        cost = whole * bs * width
        if rem:
            cost += bucket_batch_size(rem, bs) * width
        return cost

    def _run_batch_inference_page(self, page, mats, valid_wh, points):
        """Route each line to the narrowest width bucket its content fits
        (or the full canvas), then run each group; the split is taken only
        when its padded cost is below one full-width run's."""
        buckets = self._width_buckets()
        if not buckets:
            return self._run_batch_inference_page_w(page, mats, valid_wh, points)
        n = len(mats)
        groups = {}
        for i in range(n):
            w = int(valid_wh[i][0])
            groups.setdefault(next((b for b in buckets if w <= b), None), []).append(i)
        if len(groups) == 1:
            (b,) = groups
            return self._run_batch_inference_page_w(page, mats, valid_wh, points, out_w=b)
        # cost guard: batch-bucket padding can make a split dearer than one
        # full-width run (64 narrow + 64 wide pad to 128 at half + 128 at
        # full, 1.5x the work of 128 at full)
        full_w = int(self._cfg.data.img_size[1])
        routed = sum(self._padded_cost(len(idx), b if b is not None else full_w)
                     for b, idx in groups.items())
        if routed >= self._padded_cost(n, full_w):
            return self._run_batch_inference_page_w(page, mats, valid_wh, points)
        return self._merged(n, [
            (idx, self._run_batch_inference_page_w(
                page, mats[idx], valid_wh[idx], [points[i] for i in idx], out_w=b))
            for b, idx in groups.items()])

    @staticmethod
    def _merged(n, parts):
        """[(indices, (preds, scores, directions))] -> the three lists in
        input order."""
        preds, scores, directions = [None] * n, [None] * n, [None] * n
        for idx, (p, s, d) in parts:
            for j, i in enumerate(idx):
                preds[i], scores[i], directions[i] = p[j], s[j], d[j]
        return preds, scores, directions

    def _run_batch_inference_page_w(self, page, mats, valid_wh, points, out_w=None):
        """The lines at one canvas width, in chunks of the batch size."""
        preds, scores, directions = [], [], []
        bs = self._cfg.data.batch_size
        for i in range(0, len(mats), bs):
            ids_probs = self._infer_padded_page(
                page, mats[i:i + bs], valid_wh[i:i + bs], out_w=out_w)
            with segment("rec", "tokenize"):
                p, s, d = self.postprocess(ids_probs, points[i:i + bs])
            preds.extend(p)
            scores.extend(s)
            directions.extend(d)
        return preds, scores, directions

    def _apply_orientation_fallback_page(self, page, points, preds, scores, directions):
        """The device route's fallback: re-read the lines scoring below the
        threshold through maps with the 180-degree flip composed in."""
        thresh = self.rec_orientation_fallback_thresh
        retry = [i for i, s in enumerate(scores) if s < thresh]
        if not retry:
            return
        retry_points = [points[i] for i in retry]
        mats, valid_wh = line_homographies(
            retry_points, tuple(self._cfg.data.img_size), rot180=True)
        r_preds, r_scores, r_dirs = self._run_batch_inference_page(
            page, mats, valid_wh, retry_points)
        for j, idx in enumerate(retry):
            if r_scores[j] > scores[idx] and r_scores[j] >= thresh:
                preds[idx] = r_preds[j]
                scores[idx] = r_scores[j]
                directions[idx] = r_dirs[j]

    def _call_device(self, img, points, page=None):
        """The device route: one page upload (or the shared DevicePage),
        the lines' maps on the host, crops and decode on the device ->
        (preds, scores, directions, valid_points)."""
        if points is None:
            h, w = img.shape[:2]
            points = [[[0, 0], [w, 0], [w, h], [0, h]]]

        def _nonzero_area(q):
            # as ParseqDataset drops a quad whose warped ROI is empty
            qa = np.asarray(q, dtype=np.int64).astype(np.float64)
            return (int(np.linalg.norm(qa[0] - qa[1])) > 0
                    and int(np.linalg.norm(qa[1] - qa[2])) > 0)

        with segment("rec", "host_prep"):
            valid_points = [q for q in points
                            if validate_quads(img, q) is not None and _nonzero_area(q)]
            if not valid_points:
                return [], [], [], []
            mats, valid_wh = line_homographies(valid_points, tuple(self._cfg.data.img_size))
        page = page_on(page, self.device) if page is not None else DevicePage(img, self.device).dev
        preds, scores, directions = self._run_batch_inference_page(
            page, mats, valid_wh, valid_points)
        if self.rec_orientation_fallback:
            self._apply_orientation_fallback_page(page, valid_points, preds, scores, directions)
        return preds, scores, directions, valid_points

    def __call__(self, img, points=None, vis=None, page=None):
        """Recognize text lines in ``img`` (BGR) at the given quads ->
        (TextRecognizerSchema, vis); ``vis`` is drawn on when given.
        ``page``: a DevicePage of ``img`` (shared with the detector) for
        the device route; where device crops are off it is not used."""
        with segment("rec", "call"):
            if self._use_device_crops():
                preds, scores, directions, valid_points = self._call_device(img, points, page)
            else:
                dataset, _ = self.preprocess(img, points)
                valid_points = dataset.valid_quads
                preds, scores, directions = self._run_batch_inference(
                    dataset.as_u8_array(), valid_points
                )
                if self.rec_orientation_fallback:
                    self._apply_orientation_fallback(
                        dataset, valid_points, preds, scores, directions)
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
