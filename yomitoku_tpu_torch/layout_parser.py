"""LayoutParser task module, RT-DETRv2 (counterpart of
yomitoku_tpu/layout_parser.py): the page resized to 640x640 RGB on the
host and uploaded as uint8, the detector and its top-k on the device, one
readback, then the host filters: containment within a category keeps the
larger box, paragraphs inside tables go, and the roles (section headings,
page header and footer) fold into paragraphs.  Given ``page=`` (a shared
ops.device_crop.DevicePage), the resize runs on the device instead.

The JAX module imports JAX at module level, so its host helpers are
repeated here.
"""

import cv2
import numpy as np

from .base import BaseModelCatalog, BaseModule
from .configs import LayoutParserRTDETRv2Config, LayoutParserRTDETRv2V2Config
from .models.rtdetr import RTDETRv2
from .ops.device_crop import page_on, staged_page_mat
from .postprocessor.rtdetr_postprocessor import RTDETRPostProcessor
from .schemas import LayoutParserSchema
from .utils.misc import containment_matrix, filter_by_flag


class LayoutParserModelCatalog(BaseModelCatalog):
    def __init__(self):
        super().__init__()
        self.register("rtdetrv2", LayoutParserRTDETRv2Config, RTDETRv2)
        self.register("rtdetrv2v2", LayoutParserRTDETRv2V2Config, RTDETRv2)


def filter_contained_rectangles_within_category(category_elements):
    """Drop rectangles contained in another of the same category; mutual
    containment keeps the larger."""
    for category, elements in category_elements.items():
        boxes = [element["box"] for element in elements]
        n = len(boxes)
        if n <= 1:
            continue
        inside = containment_matrix(boxes, boxes)  # [i, j]: j inside i
        b = np.asarray(boxes, np.float64)
        area = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
        upper = np.triu(np.ones((n, n), bool), 1)
        both = inside & inside.T
        ij_only = inside & ~inside.T  # j inside i -> drop j
        ji_only = inside.T & ~inside  # i inside j -> drop i
        a_gt = area[:, None] > area[None, :]
        drop_j = upper & ((both & a_gt) | ij_only)
        drop_i = upper & ((both & ~a_gt) | ji_only)
        dropped = drop_i.any(axis=1) | drop_j.any(axis=0)
        category_elements[category] = filter_by_flag(elements, (~dropped).tolist())
    return category_elements


def filter_contained_rectangles_across_categories(category_elements, source, target):
    """Drop ``target`` rectangles contained in a ``source`` rectangle."""
    src_boxes = [element["box"] for element in category_elements[source]]
    tgt_boxes = [element["box"] for element in category_elements[target]]
    if src_boxes and tgt_boxes:
        check_list = (~containment_matrix(src_boxes, tgt_boxes).any(axis=0)).tolist()
    else:
        check_list = [True] * len(tgt_boxes)
    category_elements[target] = filter_by_flag(category_elements[target], check_list)
    return category_elements


def preprocess_rtdetr(img_bgr, img_size):
    """BGR uint8 -> (1, H, W, 3) uint8 RGB at ``img_size`` (cv2 INTER_AREA,
    the closest to the reference's PIL bilinear with antialias when
    shrinking); the [0, 1] scaling runs on the device."""
    rgb = cv2.cvtColor(img_bgr, cv2.COLOR_BGR2RGB)
    resized = cv2.resize(rgb, (img_size[1], img_size[0]),
                         interpolation=cv2.INTER_AREA)
    return resized[None]


class LayoutParser(BaseModule):
    model_catalog = LayoutParserModelCatalog()

    def __init__(
        self,
        model_name="rtdetrv2v2",
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
        self.postprocessor = RTDETRPostProcessor(
            num_classes=self._cfg.RTDETRTransformerv2.num_classes,
            num_top_queries=self._cfg.RTDETRTransformerv2.num_queries,
        )
        self.postprocessor.trace_stage = "layout"
        self.thresh_score = self._cfg.thresh_score
        self.label_mapper = dict(enumerate(self._cfg.category))
        self.role = self._cfg.role

    def preprocess(self, img):
        return preprocess_rtdetr(img, self._cfg.data.img_size)

    def postprocess(self, preds, image_size):
        h, w = image_size
        outputs = self.postprocessor(preds, [[w, h]], self.thresh_score)
        return LayoutParserSchema(**self.filtering_elements(outputs[0]))

    def filtering_elements(self, preds):
        category_elements = {
            category: []
            for category in self.label_mapper.values()
            if category not in self.role
        }
        for box, score, label in zip(preds["boxes"], preds["scores"], preds["labels"]):
            category = self.label_mapper[int(label)]
            role = None
            if category in self.role:
                role, category = category, "paragraphs"
            category_elements[category].append({
                "id": None,
                "box": box.astype(int).tolist(),
                "score": float(score),
                "role": role,
                "contents": None,
            })
        category_elements = filter_contained_rectangles_within_category(
            category_elements)
        return filter_contained_rectangles_across_categories(
            category_elements, "tables", "paragraphs")

    def __call__(self, img, page=None):
        """Detect the layout of a BGR image -> (LayoutParserSchema, vis).
        With ``page`` (a DevicePage of ``img``) the resize runs on the
        device."""
        ori_h, ori_w = img.shape[:2]
        if page is not None:
            img_size = tuple(self._cfg.data.img_size)
            preds = self.model.forward_from_page(
                page_on(page, self.device),
                staged_page_mat((ori_h, ori_w), img_size, self.device), img_size)
        else:
            preds = self.model(self.preprocess(img))
        results = self.postprocess(preds, (ori_h, ori_w))
        vis = None
        if self.visualize:
            from .utils.visualizer import layout_visualizer

            vis = layout_visualizer(results, img)
        return results, vis
