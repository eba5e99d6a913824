from .rtdetr import (
    LayoutParserRTDETRv2Config,
    LayoutParserRTDETRv2V2Config,
    TableStructureRecognizerRTDETRv2Config,
)
from .text_detector import (
    TextDetectorDBNetConfig,
    TextDetectorDBNetV2Config,
    TextDetectorDBNetV2_1Config,
    TextDetectorDBNetV2_1LiteConfig,
)
from .text_recognizer import (
    TextRecognizerPARSeqConfig,
    TextRecognizerPARSeqLargeV41Config,
    TextRecognizerPARSeqSmallConfig,
    TextRecognizerPARSeqTinyConfig,
    TextRecognizerPARSeqV2Config,
)

__all__ = [
    "TextDetectorDBNetConfig",
    "TextDetectorDBNetV2Config",
    "TextDetectorDBNetV2_1Config",
    "TextDetectorDBNetV2_1LiteConfig",
    "TextRecognizerPARSeqConfig",
    "TextRecognizerPARSeqTinyConfig",
    "TextRecognizerPARSeqSmallConfig",
    "TextRecognizerPARSeqV2Config",
    "TextRecognizerPARSeqLargeV41Config",
    "LayoutParserRTDETRv2Config",
    "LayoutParserRTDETRv2V2Config",
    "TableStructureRecognizerRTDETRv2Config",
]
