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
