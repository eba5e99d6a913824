from .functions import (
    array_to_nhwc,
    array_to_tensor,
    extract_roi_with_perspective,
    load_image,
    load_pdf,
    PdfPageIterator,
    resize_shortest_edge,
    resize_with_padding,
    rotate_text_image,
    standardization_image,
    validate_quads,
)

__all__ = [
    "load_image",
    "load_pdf",
    "PdfPageIterator",
    "resize_shortest_edge",
    "standardization_image",
    "array_to_nhwc",
    "array_to_tensor",
    "validate_quads",
    "extract_roi_with_perspective",
    "rotate_text_image",
    "resize_with_padding",
]
