"""Image loading and validation (the port's copy of
yomitoku_tpu/data/image.py).  Returns BGR uint8 ndarrays, one per page (a
multi-page TIFF yields several)."""

from pathlib import Path

import numpy as np
from PIL import Image

from ..constants import MIN_IMAGE_SIZE, SUPPORT_INPUT_FORMAT, WARNING_IMAGE_SIZE
from ..utils.logger import set_logger

logger = set_logger(__name__)


def validate_image(img: np.ndarray):
    h, w = img.shape[:2]
    if h < MIN_IMAGE_SIZE or w < MIN_IMAGE_SIZE:
        raise ValueError("Image size is too small.")
    if min(h, w) < WARNING_IMAGE_SIZE:
        logger.warning(
            "The image size is small, which may result in reduced OCR accuracy. "
            "A minimum of %d pixels on the shorter side is recommended.",
            WARNING_IMAGE_SIZE,
        )


def load_image(image_path: str) -> list:
    """Open an image file; returns list of BGR ndarrays (pages)."""
    image_path = Path(image_path)
    if not image_path.exists():
        raise FileNotFoundError(f"File not found: {image_path}")

    ext = image_path.suffix[1:].lower()
    if ext not in SUPPORT_INPUT_FORMAT:
        raise ValueError(
            f"Unsupported image format. Supported formats are {SUPPORT_INPUT_FORMAT}"
        )
    if ext == "pdf":
        raise ValueError(
            "PDF file is not supported by load_image(). Use load_pdf() instead."
        )

    try:
        img = Image.open(image_path)
    except OSError as e:  # PIL's UnidentifiedImageError is an OSError
        raise ValueError("Invalid image data.") from e

    pages = []
    if ext in ("tif", "tiff"):
        try:
            while True:
                arr = np.array(img.copy().convert("RGB"))
                validate_image(arr)
                pages.append(arr[:, :, ::-1])
                img.seek(img.tell() + 1)
        except EOFError:
            pass
    else:
        arr = np.array(img.convert("RGB"))
        validate_image(arr)
        pages.append(arr[:, :, ::-1])
    return pages
