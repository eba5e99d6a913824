"""PDF page rendering.

Reference parity: yomitoku/data/functions.py:81-193 (PdfPageIterator,
load_pdf).  The reference delegates to pypdfium2 (C++ pdfium); this package
ships a self-contained renderer (``yomitoku_tpu_torch.data.pdf.render``) that
parses the PDF object model and rasterizes page content (images, vector
paths, embedded TrueType/CFF text) to BGR ndarrays.  If pypdfium2 happens to
be installed it is preferred as a backend for fidelity.
"""

from pathlib import Path

import numpy as np

from ...constants import SUPPORT_INPUT_FORMAT

_BACKEND = None


def _get_backend():
    global _BACKEND
    if _BACKEND is None:
        try:
            import pypdfium2  # noqa: F401

            _BACKEND = "pdfium"
        except ImportError:
            _BACKEND = "builtin"
    return _BACKEND


class PdfPageIterator:
    """Lazily renders PDF pages one at a time (OOM-safe for huge PDFs).

    Supports ``len()``, integer / negative / slice indexing, and iteration.
    Yields BGR uint8 ndarrays rendered at ``dpi`` (default 200).
    """

    def __init__(self, pdf_path, dpi: int = 200):
        self._pdf_path = Path(pdf_path)
        self._dpi = dpi
        self._backend = _get_backend()
        try:
            if self._backend == "pdfium":
                import pypdfium2

                doc = pypdfium2.PdfDocument(self._pdf_path)
                self.total_pages = len(doc)
                doc.close()
            else:
                from .document import PdfDocument

                doc = PdfDocument(self._pdf_path)
                self.total_pages = doc.n_pages
        except Exception as e:
            raise ValueError(f"Failed to open the PDF file: {self._pdf_path}") from e

    def __len__(self):
        return self.total_pages

    def _open(self):
        if self._backend == "pdfium":
            import pypdfium2

            return pypdfium2.PdfDocument(self._pdf_path)
        from .document import PdfDocument

        return PdfDocument(self._pdf_path)

    def _render_page(self, doc, index: int) -> np.ndarray:
        if self._backend == "pdfium":
            page = doc[index]
            bitmap = page.render(scale=self._dpi / 72)
            pil_image = bitmap.to_pil()
            return np.array(pil_image.convert("RGB"))[:, :, ::-1]
        from .render import render_page

        return render_page(doc, index, dpi=self._dpi)

    def _close(self, doc):
        if self._backend == "pdfium":
            doc.close()

    def __getitem__(self, index):
        if isinstance(index, slice):
            indices = range(*index.indices(self.total_pages))
            doc = self._open()
            try:
                return [self._render_page(doc, i) for i in indices]
            finally:
                self._close(doc)
        if isinstance(index, int):
            if index < 0:
                index += self.total_pages
            if not (0 <= index < self.total_pages):
                raise IndexError(f"page index {index} out of range")
            doc = self._open()
            try:
                return self._render_page(doc, index)
            finally:
                self._close(doc)
        raise TypeError(
            f"indices must be integers or slices, not {type(index).__name__}"
        )

    def __iter__(self):
        doc = self._open()
        try:
            for i in range(self.total_pages):
                yield self._render_page(doc, i)
        finally:
            self._close(doc)


def load_pdf(pdf_path, dpi: int = 200) -> PdfPageIterator:
    """Open a PDF and return a lazy page-image iterator (BGR ndarrays)."""
    pdf_path = Path(pdf_path)
    if not pdf_path.exists():
        raise FileNotFoundError(f"File not found: {pdf_path}")
    ext = pdf_path.suffix[1:].lower()
    if ext not in SUPPORT_INPUT_FORMAT:
        raise ValueError(
            f"Unsupported image format. Supported formats are {SUPPORT_INPUT_FORMAT}"
        )
    if ext != "pdf":
        raise ValueError(
            "image file is not supported by load_pdf(). Use load_image() instead."
        )
    return PdfPageIterator(pdf_path, dpi=dpi)
