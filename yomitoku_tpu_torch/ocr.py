"""OCR pipeline: text detection -> line recognition -> word aggregation
(counterpart of yomitoku_tpu/ocr.py).  Where device crops are on for the
detector's device (CUDA, by default) the page is uploaded once, as one
DevicePage that both modules crop on the device; a recognizer on another
device is not handed it, and uploads its own where its crops are on."""

from .ops.device_crop import DevicePage, device_crops_enabled, lies_on
from .schemas import OCRSchema
from .text_detector import TextDetector
from .text_recognizer import TextRecognizer


def ocr_aggregate(det_outputs, rec_outputs):
    """The JAX package's yomitoku_tpu.ocr.ocr_aggregate, repeated here
    because that module imports the JAX detector."""
    return [
        {
            "points": points,
            "content": pred,
            "direction": direction,
            "det_score": det_score,
            "rec_score": rec_score,
        }
        for points, det_score, pred, rec_score, direction in zip(
            rec_outputs.points, det_outputs.scores, rec_outputs.contents,
            rec_outputs.scores, rec_outputs.directions,
        )
    ]


class OCR:
    """Detector + recognizer, with the JAX package's arguments: each
    module's ``configs`` entry is merged over ``device``, ``visualize`` and
    ``num_devices``."""

    def __init__(self, configs=None, device="cuda", visualize=False,
                 num_devices=None):
        configs = configs or {}
        if not isinstance(configs, dict):
            raise ValueError("configs must be a dict.")
        common = {"device": device, "visualize": visualize,
                  "num_devices": num_devices}
        self.detector = TextDetector(**{**common, **configs.get("text_detector", {})})
        self.recognizer = TextRecognizer(**{**common, **configs.get("text_recognizer", {})})

    def __call__(self, img):
        """Run OCR on a BGR image -> (OCRSchema, vis)."""
        device = self.detector.device
        page = DevicePage(img, device) if device_crops_enabled(device) else None
        det_outputs, vis = self.detector(img, page=page)
        if page is not None and not lies_on(page, self.recognizer.device):
            page = None
        rec_outputs, vis = self.recognizer(img, det_outputs.points, vis=vis, page=page)
        return OCRSchema(words=ocr_aggregate(det_outputs, rec_outputs)), vis
