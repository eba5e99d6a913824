from .functions import (
    extract_roi_with_perspective,
    load_image,
    load_pdf,
    PdfPageIterator,
    resize_shortest_edge,
    resize_with_padding,
    rotate_text_image,
    validate_quads,
)

__all__ = [
    "load_image",
    "load_pdf",
    "PdfPageIterator",
    "resize_shortest_edge",
    "validate_quads",
    "extract_roi_with_perspective",
    "rotate_text_image",
    "resize_with_padding",
]
