"""DBNet+ text detector (counterpart of yomitoku_tpu/models/dbnet.py).

Dilated ResNet-50 -> FPN-style decoder -> scale-feature-selection
attention -> binarize head at full resolution.  The adaptive-threshold head
of the reference checkpoints is never evaluated at inference and is not
built.  Parameter names follow the reference ``state_dict``
(yomitoku/models/dbnet_plus.py).  The public forward functions take NHWC
images, as the JAX package's do; the convolutions run NCHW inside, in
channels_last memory when a fused-backbone switch is on
(models/layers/resnet.py), which the NHWC input already is.
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..data.functions import IMAGENET_MEAN, IMAGENET_STD

from .base import TorchModel
from .layers.resnet import FrozenBatchNorm, ResNetFeatures


def _resize_bilinear(x, h, w):
    """Bilinear upsampling with half-pixel centres (the JAX package's
    jax.image.resize; the decoder only upsamples)."""
    return F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False)


def _conv(cin, cout, k, bias=False):
    return nn.Conv2d(cin, cout, k, padding=(k - 1) // 2, bias=bias)


class ScaleChannelSpatialAttention(nn.Module):
    """Reference models/layers/dbnet_feature_attention.py:36-81."""

    def __init__(self, in_planes, out_planes, num_features):
        super().__init__()
        self.channel_wise = nn.Sequential(
            nn.AdaptiveAvgPool2d(1), _conv(in_planes, out_planes, 1), nn.ReLU(),
            _conv(out_planes, in_planes, 1),
        )
        self.spatial_wise = nn.Sequential(
            _conv(1, 1, 3), nn.ReLU(), _conv(1, 1, 1),
        )
        self.attention_wise = nn.Sequential(_conv(in_planes, num_features, 1))

    def forward(self, x):  # (B, C, H, W)
        g = torch.sigmoid(self.channel_wise(x)) + x
        s = self.spatial_wise(g.mean(dim=1, keepdim=True))
        g = torch.sigmoid(s) + g
        return torch.sigmoid(self.attention_wise(g))


class ScaleFeatureSelection(nn.Module):
    """Reference dbnet_feature_attention.py:118-166 (scale_channel_spatial)."""

    def __init__(self, in_channels, inter_channels, out_features_num=4):
        super().__init__()
        self.out_features_num = out_features_num
        self.conv = _conv(in_channels, inter_channels, 3, bias=True)
        self.enhanced_attention = ScaleChannelSpatialAttention(
            inter_channels, inter_channels // 4, out_features_num
        )

    def forward(self, concat_x, features_list):
        score = self.enhanced_attention(self.conv(concat_x))
        return torch.cat(
            [score[:, i:i + 1] * features_list[i]
             for i in range(self.out_features_num)],
            dim=1,
        )


class DBNetDecoder(nn.Module):
    """FPN decoder + attention fuse + binarize head (dbnet_plus.py:41-230)."""

    LAYERS = ("layer1", "layer2", "layer3", "layer4")

    def __init__(self, in_channels=(256, 512, 1024, 2048), hidden_dim=256):
        super().__init__()
        d = hidden_dim
        self.input_proj = nn.ModuleDict(
            {name: _conv(c, d, 1) for name, c in zip(self.LAYERS, in_channels)}
        )
        # the reference wraps layer2..4's conv with an Upsample (no params)
        self.out_proj = nn.ModuleDict({
            name: _conv(d, d // 4, 3) if name == "layer1"
            else nn.Sequential(_conv(d, d // 4, 3))
            for name in self.LAYERS
        })
        self.binarize = nn.Sequential(
            _conv(d, d // 4, 3), FrozenBatchNorm(d // 4), nn.ReLU(),
            nn.ConvTranspose2d(d // 4, d // 4, 2, 2), FrozenBatchNorm(d // 4),
            nn.ReLU(), nn.ConvTranspose2d(d // 4, 1, 2, 2),
        )
        self.concat_attention = ScaleFeatureSelection(d, d // 4)

    def forward(self, feats):
        proj = {n: self.input_proj[n](feats[n]) for n in self.LAYERS}
        # top-down pathway: layer4 -> layer1, resize-to-match then add
        for top, bottom in (("layer3", "layer4"), ("layer2", "layer3"),
                            ("layer1", "layer2")):
            b, t = proj[bottom], proj[top]
            if b.shape[-2:] != t.shape[-2:]:
                b = _resize_bilinear(b, *t.shape[-2:])
            proj[top] = b + t
        h1, w1 = proj["layer1"].shape[-2:]
        outs = {}
        for n in self.LAYERS:
            o = self.out_proj[n](proj[n])
            if o.shape[-2:] != (h1, w1):
                o = _resize_bilinear(o, h1, w1)
            outs[n] = o
        # channel order layer4..layer1 (reference fp[::-1])
        fp = [outs["layer4"], outs["layer3"], outs["layer2"], outs["layer1"]]
        fuse = self.concat_attention(torch.cat(fp, dim=1), fp)
        return torch.sigmoid(self.binarize(fuse).float())  # (B, 1, H, W)


class Backbone(nn.Module):
    def __init__(self):
        super().__init__()
        self.body = ResNetFeatures()

    def forward(self, x):
        return self.body(x)


class DBNet(TorchModel):
    #: the adaptive-threshold head is in the reference checkpoints but
    #: never evaluated at inference
    ignored_checkpoint_keys = ("num_batches_tracked", "decoder.thresh.")

    def __init__(self, cfg, device="cpu", dtype=None):
        super().__init__(cfg, device, dtype)
        self.backbone = Backbone()
        self.decoder = DBNetDecoder(
            tuple(cfg.decoder.in_channels), cfg.decoder.hidden_dim
        )
        self.finish_init()

    @torch.no_grad()
    def forward(self, images):
        """(B, H, W, 3) standardized -> (B, H, W) float32 probability map."""
        x = images.to(self.device, self.dtype).permute(0, 3, 1, 2)
        return self.decoder(self.backbone(x))[:, 0]

    def standardize_u8(self, images_u8):
        """(B, H, W, 3) uint8 resized page, or its float resample in
        [0, 255] -> the standardized float32 input of ``forward``, computed
        on the device.  The BGR input meets RGB-ordered ImageNet
        statistics, because the reference flips the channels twice
        (text_detector.py:69-94)."""
        mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32) * 255.0
        inv = 1.0 / (torch.tensor(IMAGENET_STD, dtype=torch.float32) * 255.0)
        return (images_u8.to(self.device).float() - mean.to(self.device)) * inv.to(self.device)

    @staticmethod
    def _wire(prob):
        """prob -> uint8 wire map (prob * 255, rounded half to even)."""
        return torch.clamp(torch.round(prob * 255.0), 0, 255).to(torch.uint8)

    @torch.no_grad()
    def forward_u8(self, images_u8):
        """(B, H, W, 3) uint8 resized page -> (B, H, W) uint8 wire map."""
        return self._wire(self.forward(self.standardize_u8(images_u8)))

    @torch.no_grad()
    def forward_from_page(self, page, src_hw, out_hw):
        """The page route: the padded uint8 page (H, W, 3) on this model's
        device, of which the top-left ``src_hw`` is the image, resized to
        ``out_hw`` on the device (separable, 2x2 supersampled, ~ cv2
        INTER_AREA), standardized as float (the resample is not rounded
        to uint8), DBNet -> (1, oh, ow) uint8 wire map on the device."""
        from ..ops.device_crop import staged_page_mat
        from ..ops.separable_resize import sample_regions_separable

        mat = staged_page_mat(src_hw, out_hw, page.device)
        x = sample_regions_separable(page, mat, tuple(out_hw), flip_bgr=False)
        return self._wire(self.forward(self.standardize_u8(x)))

    def forward_binary_from_page(self, page, src_hw, out_hw) -> np.ndarray:
        """Host entry of ``forward_from_page`` -> (1, oh, ow) uint8 map."""
        return self.forward_from_page(page, src_hw, out_hw).cpu().numpy()

    def forward_binary_u8(self, images_u8: np.ndarray) -> np.ndarray:
        """Host entry: (B, H, W, 3) uint8 ndarray -> (B, H, W) uint8 map."""
        return self.forward_u8(torch.from_numpy(np.ascontiguousarray(images_u8))).cpu().numpy()

    def forward_binary(self, images: np.ndarray) -> np.ndarray:
        """Host entry: (B, H, W, 3) standardized float32 -> (B, H, W) map."""
        return self.forward(torch.from_numpy(np.ascontiguousarray(images))).float().cpu().numpy()
