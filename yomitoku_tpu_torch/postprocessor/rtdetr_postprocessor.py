"""RT-DETR postprocessor: logits and boxes -> thresholded labelled boxes
(counterpart of yomitoku_tpu/postprocessor/rtdetr_postprocessor.py).

Sigmoid (focal) scores, one flat top-k over queries x classes, the boxes
of the picked queries converted from cxcywh to xyxy in the original
image's pixels: all on the device, packed into one (B, k, 6) tensor
[label, score, x1, y1, x2, y2], so one readback serves the whole batch.
The host then thresholds and clamps (``filter_packed``).
"""

import numpy as np
import torch

from ..utils.stagetrace import segment


def topk_packed(logits, boxes, orig_sizes, num_top_queries):
    """logits (B, Q, C), boxes (B, Q, 4) cxcywh in [0, 1], orig_sizes
    (B, 2) as (w, h), all on one device -> (B, k, 6) float32 there."""
    C = logits.shape[-1]
    scores_all = torch.sigmoid(logits.float())
    scores, index = torch.topk(scores_all.flatten(1), num_top_queries, dim=1)
    labels = index % C
    qidx = index // C
    cxcy, wh = boxes[..., :2], boxes[..., 2:]
    xyxy = torch.cat([cxcy - wh / 2, cxcy + wh / 2], dim=-1).float()
    xyxy = xyxy * orig_sizes.float().repeat(1, 2)[:, None, :]
    picked = torch.gather(xyxy, 1, qidx[..., None].expand(-1, -1, 4))
    return torch.cat([labels[..., None].float(), scores[..., None], picked], -1)


class RTDETRPostProcessor:
    #: stage label for utils.stagetrace accounting (task modules override)
    trace_stage = "rtdetr"

    def __init__(self, num_classes, num_top_queries=300, use_focal_loss=True):
        self.num_classes = int(num_classes)
        self.num_top_queries = int(num_top_queries)
        #: kept as the JAX package keeps it; both score with the sigmoid
        #: (the reference checkpoints are focal-loss trained)
        self.use_focal_loss = use_focal_loss

    def topk_on_device(self, outputs, orig_sizes):
        """Device half: the (B, k, 6) packed [label, score, xyxy] tensor."""
        logits = outputs["pred_logits"]
        sizes = torch.as_tensor(
            np.asarray(orig_sizes, np.float32).reshape(-1, 2), device=logits.device
        )
        return topk_packed(logits, outputs["pred_boxes"], sizes,
                           self.num_top_queries)

    def __call__(self, outputs, orig_sizes, threshold):
        """outputs {"pred_logits", "pred_boxes"} on the device; orig_sizes
        (B, 2) of (w, h) -> list of {labels, boxes, scores} numpy dicts."""
        with segment(self.trace_stage, "dispatch"):
            dev = self.topk_on_device(outputs, orig_sizes)
        with segment(self.trace_stage, "sync", nbytes=dev.numel() * 4):
            packed = dev.cpu().numpy()
        return self.filter_packed(packed, orig_sizes, threshold)

    def filter_packed(self, packed, orig_sizes, threshold):
        """Host half: threshold and clamp a fetched packed array."""
        orig_sizes = np.asarray(orig_sizes, np.float32).reshape(-1, 2)
        results = []
        for row, (w, h) in zip(packed, orig_sizes):
            keep = row[:, 1] > threshold
            box = row[keep, 2:6].copy()
            box[:, 0] = np.clip(box[:, 0], 0, None)
            box[:, 1] = np.clip(box[:, 1], 0, None)
            box[:, 2] = np.clip(box[:, 2], 0, w)
            box[:, 3] = np.clip(box[:, 3], 0, h)
            results.append(dict(labels=row[keep, 0].astype(np.int64), boxes=box,
                                scores=row[keep, 1]))
        return results
