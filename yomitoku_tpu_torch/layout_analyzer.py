"""LayoutAnalyzer pipeline: layout parsing, then table structure
recognition of every table found (counterpart of
yomitoku_tpu/layout_analyzer.py).  ``page=`` (an ops.device_crop.DevicePage
of the image, uploaded once) goes to both modules, which then resize and
crop on the device (a module on another device gets the image uploaded
to its own); without it both take the host route, as the JAX analyzer
does.  ``device``, ``visualize`` and ``num_devices`` go to both modules,
under each one's ``configs`` entry."""

from .layout_parser import LayoutParser
from .ops.device_crop import DevicePage, lies_on
from .schemas import LayoutAnalyzerSchema
from .table_structure_recognizer import TableStructureRecognizer


class LayoutAnalyzer:
    def __init__(self, configs=None, device="cuda", visualize=False,
                 num_devices=None):
        configs = configs or {}
        if not isinstance(configs, dict):
            raise ValueError("configs must be a dict.")
        common = {"device": device, "visualize": visualize,
                  "num_devices": num_devices}
        self.layout_parser = LayoutParser(
            **{**common, **configs.get("layout_parser", {})})
        self.table_structure_recognizer = TableStructureRecognizer(
            **{**common, **configs.get("table_structure_recognizer", {})})

    def __call__(self, img, page=None):
        """Analyse the layout of a BGR image -> (LayoutAnalyzerSchema, vis);
        ``page``: a DevicePage of ``img`` for the device route."""
        def page_for(module):
            if page is None or lies_on(page, module.device):
                return page
            return DevicePage(img, module.device)

        layout_results, vis = self.layout_parser(img, page=page_for(self.layout_parser))
        table_boxes = [table.box for table in layout_results.tables]
        tsr = self.table_structure_recognizer
        table_results, vis = tsr(img, table_boxes, vis=vis, page=page_for(tsr))
        return (
            LayoutAnalyzerSchema(
                paragraphs=layout_results.paragraphs,
                tables=table_results,
                figures=layout_results.figures,
            ),
            vis,
        )
