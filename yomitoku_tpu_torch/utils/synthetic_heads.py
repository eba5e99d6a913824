"""Detections from random weights (the port's counterpart of
yomitoku_tpu/utils/synthetic_heads.py, acting on the port's RT-DETRv2
``nn.Module`` in place of a parameter tree).

With no checkpoint, the RT-DETR score heads give near-uniform sigmoid
scores: whole classes can miss the detection threshold, and ties at the
top-k boundary flip on rounding.  A harness that needs non-empty, stable
detection sets from seeded weights applies both transforms:

  * ``spread_score_heads`` scales every score head's weight and bias so
    that the sigmoid scores saturate toward 0 or 1;
  * ``balance_final_score_head`` re-centres the per-class bias of the
    score head that the forward reads (``decoder.eval_idx``) on one
    calibration forward, so that every class appears in the flat
    (queries x classes) top-k.

For the cell detector, ``pinned_filter_packed`` swaps the detections for
fixed grid and key-value layouts after the real filter.

Nothing on the library's path calls them.
"""

import torch


def _score_heads(model):
    dec = model.decoder
    return [dec.enc_score_head, *dec.dec_score_head]


@torch.no_grad()
def spread_score_heads(model, factor=6.0):
    """Scale the encoder's and every decoder layer's score head by
    ``factor``, in place."""
    for head in _score_heads(model):
        head.weight.mul_(factor)
        head.bias.mul_(factor)
    return model


@torch.no_grad()
def balance_final_score_head(model, calibration_batch):
    """Zero the mean per-class logit of the score head the forward reads,
    over one forward of ``calibration_batch`` (uint8 (B, H, W, 3) RGB, as
    ``RTDETRv2.forward`` takes it), in place."""
    logits = model(calibration_batch)["pred_logits"].float()
    head = model.decoder.dec_score_head[model.decoder.eval_idx]
    head.bias.sub_(logits.mean(dim=(0, 1)).to(head.bias.dtype))
    return model


def pinned_cells(w, h, index, label_of):
    """Deterministic cell detections for a table crop of ``w`` x ``h``
    pixels, keyed by ``index``: at an even index a 4x4 grid
    (row 0 headers, rows 1-3 cells), which the semantic parser reads as a
    grid; at an odd index 4 stacked (header | value) pairs with gaps
    between the rows, one hard-adjacency line per role, which it reads as
    key-value items.  ``label_of``: category name -> class index.
    -> {labels, boxes, scores} as the postprocessor's filter returns."""
    import numpy as np

    boxes, labels = [], []
    if index % 2 == 0:
        cw, ch = w / 4.0, h / 4.0
        for r in range(4):
            for c in range(4):
                x0, y0 = c * cw + 2.0, r * ch + 2.0
                boxes.append([x0, y0, x0 + cw - 4.0, y0 + ch - 4.0])
                labels.append(label_of["header" if r == 0 else "cell"])
    else:
        cw, ch = w / 2.0, h / 4.0
        gap = max(2.0, 0.15 * ch)
        for r in range(4):
            y0, y1 = r * ch + gap, (r + 1) * ch - gap
            boxes.append([2.0, y0, cw - 4.0, y1])
            labels.append(label_of["header"])
            boxes.append([cw + 2.0, y0, w - 4.0, y1])
            labels.append(label_of["cell"])
    return dict(labels=np.asarray(labels, np.int64),
                boxes=np.asarray(boxes, np.float32),
                scores=np.full(len(boxes), 0.9, np.float32))


def pinned_filter_packed(detector):
    """A stand-in for ``detector.postprocessor.filter_packed`` (the host
    filter after the top-k's readback) that runs the real filter, then
    returns ``pinned_cells`` for each crop of the call.  Random weights
    at 2,500 queries pass hundreds of boxes a crop, whose quadratic host
    filters would time a load no checkpoint makes; the pinned sets keep
    the forward, the readback and the real filter in the path and give
    the semantic parser both a grid and key-value items.  The choice
    depends only on the crop's size, keyed by the parity of w + h, so
    every route sees the same detections for a table: the unfused route
    filters a page's tables in one call, the fused route each slot in a
    call of its own."""
    import numpy as np

    real = detector.postprocessor.filter_packed
    label_of = {c: i for i, c in detector.label_mapper.items()}

    def filter_packed(packed, orig_sizes, threshold):
        real(packed, orig_sizes, threshold)
        sizes = np.asarray(orig_sizes, np.float32).reshape(-1, 2)
        return [pinned_cells(w, h, int(w) + int(h), label_of) for w, h in sizes]

    return filter_packed
