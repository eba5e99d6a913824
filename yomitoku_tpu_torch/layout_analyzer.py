"""LayoutAnalyzer pipeline: layout parsing, then table structure
recognition of every table found (counterpart of
yomitoku_tpu/layout_analyzer.py)."""

from .layout_parser import LayoutParser
from .schemas import LayoutAnalyzerSchema
from .table_structure_recognizer import TableStructureRecognizer


class LayoutAnalyzer:
    def __init__(self, configs=None, device="cuda", visualize=False):
        configs = configs or {}
        if not isinstance(configs, dict):
            raise ValueError("configs must be a dict.")
        common = {"device": device, "visualize": visualize}
        self.layout_parser = LayoutParser(
            **{**common, **configs.get("layout_parser", {})})
        self.table_structure_recognizer = TableStructureRecognizer(
            **{**common, **configs.get("table_structure_recognizer", {})})

    def __call__(self, img, page=None):
        """Analyse the layout of a BGR image -> (LayoutAnalyzerSchema, vis)."""
        layout_results, vis = self.layout_parser(img, page=page)
        table_boxes = [table.box for table in layout_results.tables]
        table_results, vis = self.table_structure_recognizer(
            img, table_boxes, vis=vis, page=page)
        return (
            LayoutAnalyzerSchema(
                paragraphs=layout_results.paragraphs,
                tables=table_results,
                figures=layout_results.figures,
            ),
            vis,
        )
