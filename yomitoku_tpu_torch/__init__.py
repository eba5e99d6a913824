"""yomitoku_tpu_torch — the PyTorch/CUDA port of yomitoku_tpu.

The OCR path (DBNet text detection + PARSeq text recognition), layout
analysis (RT-DETRv2 layout parsing + table structure recognition) and the
DocumentAnalyzer that joins them (aggregation, reading order, the JSON,
Markdown, CSV and HTML exporters) in PyTorch, with hand-written Hopper
kernels (``csrc/``) where the JAX package runs Pallas kernels.  The host
layers it uses (configs, schemas, data, postprocessors, exporters, native
C++) are its own copies of the JAX package's, under the same module paths:
it imports ``torch`` and never ``jax``, ``flax`` or ``yomitoku_tpu``.
"""

__version__ = "0.1.0"

_LAZY = {
    "DocumentAnalyzer": ".document_analyzer",
    "LayoutAnalyzer": ".layout_analyzer",
    "LayoutParser": ".layout_parser",
    "OCR": ".ocr",
    "TableStructureRecognizer": ".table_structure_recognizer",
    "TextDetector": ".text_detector",
    "TextRecognizer": ".text_recognizer",
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name], __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = list(_LAZY) + ["__version__"]
