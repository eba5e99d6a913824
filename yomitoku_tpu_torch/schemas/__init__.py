from .document_analyzer import (
    Element,
    LayoutAnalyzerSchema,
    LayoutParserSchema,
    OCRSchema,
    TableCellSchema,
    TableLineSchema,
    TableStructureRecognizerSchema,
    TextDetectorSchema,
    TextRecognizerSchema,
    WordPrediction,
)

__all__ = [
    "Element",
    "LayoutAnalyzerSchema",
    "LayoutParserSchema",
    "OCRSchema",
    "TableCellSchema",
    "TableLineSchema",
    "TableStructureRecognizerSchema",
    "TextDetectorSchema",
    "TextRecognizerSchema",
    "WordPrediction",
]
