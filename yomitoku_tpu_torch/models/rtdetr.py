"""RT-DETRv2 detector: layout, table structure and, later, table cells
(counterpart of yomitoku_tpu/models/rtdetr.py).

PResNet-50-d -> HybridEncoder -> deformable-attention decoder.  The public
forward takes NHWC images, as the JAX package's does; a uint8 batch is
scaled to [0, 1] on the device, so the host uploads a quarter of the bytes.
Outputs stay on the device for the postprocessor's top-k.
"""

import torch

from .base import TorchModel
from .layers.presnet import PResNet
from .layers.rtdetr_decoder import RTDETRTransformerv2
from .layers.rtdetr_encoder import HybridEncoder


class RTDETRv2(TorchModel):
    #: reference-checkpoint keys inference never reads: training-only
    #: denoising embeddings and the decoder's precomputed buffers
    ignored_checkpoint_keys = (
        "num_batches_tracked", "denoising_class_embed", "anchors",
        "valid_mask", "num_points_scale",
    )
    #: stage label for utils.stagetrace accounting
    trace_stage = "rtdetr"

    def __init__(self, cfg, device="cpu", dtype=None):
        super().__init__(cfg, device, dtype)
        bcfg, ecfg = cfg.PResNet, cfg.HybridEncoder
        dcfg = cfg.RTDETRTransformerv2
        self.backbone = PResNet(bcfg.depth, bcfg.variant, tuple(bcfg.return_idx),
                                bcfg.num_stages)
        self.encoder = HybridEncoder(
            in_channels=tuple(ecfg.in_channels), hidden_dim=ecfg.hidden_dim,
            use_encoder_idx=tuple(ecfg.use_encoder_idx),
            num_encoder_layers=ecfg.num_encoder_layers, nhead=ecfg.nhead,
            dim_feedforward=ecfg.dim_feedforward, enc_act=ecfg.enc_act,
            expansion=ecfg.expansion, depth_mult=ecfg.depth_mult, act=ecfg.act,
        )
        self.decoder = RTDETRTransformerv2(
            num_classes=dcfg.num_classes, hidden_dim=dcfg.hidden_dim,
            num_queries=dcfg.num_queries,
            feat_channels=tuple(dcfg.feat_channels),
            num_levels=dcfg.num_levels, num_points=tuple(dcfg.num_points),
            nhead=8, num_layers=dcfg.num_layers, eval_idx=dcfg.eval_idx,
        )
        self.finish_init()

    @torch.no_grad()
    def forward(self, images):
        """(B, H, W, 3) uint8 RGB, or float already in [0, 1] -> {"pred_logits"
        (B, Q, C), "pred_boxes" (B, Q, 4) cxcywh in [0, 1]}, float32 on the
        device.  Under a mesh the batch splits over the replicas
        (``place_batch``) and the outputs are gathered on this device."""
        return self.run_placed(RTDETRv2._forward, images)

    @staticmethod
    def _forward(model, images):
        x = images.to(model.device)
        if x.dtype == torch.uint8:
            x = x.to(model.dtype) * (1.0 / 255.0)
        x = x.to(model.dtype).permute(0, 3, 1, 2)
        return model.decoder(model.encoder(model.backbone(x)))

    @torch.no_grad()
    def forward_from_page(self, page, mats, out_hw):
        """The page route: crop and resize the regions of (B, 3, 3)
        canvas->page maps ``mats`` out of the padded uint8 BGR page on this
        model's device (separable, 2x2 supersampled, ~ crop + cv2
        INTER_AREA; RGB), scale to [0, 1] in the compute dtype and run the
        detector -> the outputs of ``forward``, on the device."""
        from ..ops.separable_resize import sample_regions_separable

        mats = torch.as_tensor(mats, dtype=torch.float32, device=page.device)
        x = sample_regions_separable(page, mats, tuple(out_hw), flip_bgr=True)
        return self.forward(x.to(self.dtype) * (1.0 / 255.0))

    @torch.no_grad()
    def forward_from_pages(self, pages, mats, out_hw):
        """The page route over a stack of pages: (N, H, W, 3) padded uint8
        pages on one device and (N, K, 3, 3) maps, K regions of each page
        -> the outputs of ``forward`` on the N * K crops, page-major."""
        from ..ops.separable_resize import sample_regions_separable

        x = torch.cat([
            sample_regions_separable(page, m.to(page.device, torch.float32), tuple(out_hw),
                                     flip_bgr=True)
            for page, m in zip(pages, mats)])
        return self.forward(x.to(self.dtype) * (1.0 / 255.0))
