"""TextDetector task module, DBNet (counterpart of
yomitoku_tpu/text_detector.py): resize the uint8 page on the host
(shortest edge 1280, limit 1600, /32-snapped), standardise and run DBNet
on the device, bring back the uint8 probability map, and extract quads
with the port's copy of the JAX package's postprocessor (native C++
contours and unclip, csrc/dbnet_post.cpp).  Given ``page=`` (a shared
ops.device_crop.DevicePage), the resize and the standardisation run on
the device from the page uploaded once.  The constructor takes the JAX
package's arguments; ``num_devices`` counts devices as the JAX package's
``dp_mesh`` does, and where two or more take part a batch of pages splits
over one replica of DBNet per device (``parallel/``)."""

import numpy as np

from .base import BaseModelCatalog, BaseModule
from .configs import (
    TextDetectorDBNetConfig,
    TextDetectorDBNetV2_1Config,
    TextDetectorDBNetV2_1LiteConfig,
    TextDetectorDBNetV2Config,
)
from .data.functions import (
    array_to_nhwc,
    resize_shortest_edge,
    shortest_edge_size,
    standardization_image,
)
from .models.dbnet import DBNet
from .ops.device_crop import page_on
from .postprocessor.dbnet_postprocessor import DBnetPostProcessor
from .schemas import TextDetectorSchema
from .utils.stagetrace import segment


class TextDetectorModelCatalog(BaseModelCatalog):
    def __init__(self):
        super().__init__()
        self.register("dbnet", TextDetectorDBNetConfig, DBNet)
        self.register("dbnetv2", TextDetectorDBNetV2Config, DBNet)
        self.register("dbnetv2_1", TextDetectorDBNetV2_1Config, DBNet)
        self.register("dbnetv2_1-lite", TextDetectorDBNetV2_1LiteConfig, DBNet)


class TextDetector(BaseModule):
    model_catalog = TextDetectorModelCatalog()

    def __init__(
        self,
        model_name="dbnetv2_1",
        path_cfg=None,
        device="cuda",
        visualize=False,
        from_pretrained=True,
        infer_onnx=False,  # accepted, as in the JAX package; unused
        num_devices=None,
        dtype=None,
    ):
        super().__init__()
        self.load_model(model_name, path_cfg, device=device,
                        from_pretrained=from_pretrained, dtype=dtype)
        self.use_num_devices(num_devices)
        self.visualize = visualize
        self.post_processor = DBnetPostProcessor(**self._cfg.post_process)

    def preprocess(self, img):
        """The float parity path: the reference flips BGR to RGB here and
        the standardisation flips again, so the checkpoint meets BGR order
        under RGB statistics -> (1, H, W, 3) float32 for
        ``model.forward_binary``."""
        img = img[:, :, ::-1].astype(np.float32)
        resized = resize_shortest_edge(
            img, self._cfg.data.shortest_size, self._cfg.data.limit_size
        )
        return array_to_nhwc(standardization_image(resized))

    def preprocess_u8(self, img):
        """Resize the uint8 BGR page on the host; the standardisation runs
        on the device (DBNet.forward_u8)."""
        resized = resize_shortest_edge(
            img, self._cfg.data.shortest_size, self._cfg.data.limit_size
        )
        return resized[None, ...]

    def postprocess(self, preds, image_size):
        return self.post_processor(preds, image_size)

    def __call__(self, img, page=None):
        """Detect text quads in a BGR image -> (TextDetectorSchema, vis).
        With ``page`` (a DevicePage of ``img``) the resize and the
        standardisation run on the device."""
        with segment("det", "call"):
            ori_h, ori_w = img.shape[:2]
            if page is not None:
                out_hw = shortest_edge_size(
                    ori_h, ori_w, self._cfg.data.shortest_size, self._cfg.data.limit_size)
                binary = self.model.forward_binary_from_page(
                    page_on(page, self.device), page.hw, out_hw)
            else:
                binary = self.model.forward_binary_u8(self.preprocess_u8(img))
            with segment("det", "contours"):
                quads, scores = self.postprocess({"binary": binary}, (ori_h, ori_w))
            results = TextDetectorSchema(points=quads, scores=scores)
            vis = None
            if self.visualize:
                from .utils.visualizer import det_visualizer

                vis = det_visualizer(
                    img,
                    quads,
                    preds=binary[0],
                    vis_heatmap=self._cfg.visualize.heatmap,
                    line_color=tuple(self._cfg.visualize.color[::-1]),
                )
            return results, vis
