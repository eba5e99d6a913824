"""The port's host C++ (counterpart of yomitoku_tpu/native/__init__.py,
without its TPU-only ``depth_to_space_u8``), each source built at first use
by ``ops._build.host_library`` and bound through ctypes:

  * ``csrc/dbnet_post.cpp`` — DBNet probability-map postprocessing
    (run-length connected components, rotating-calipers min-area rects,
    analytic unclip): ``dbnet_boxes``;
  * ``csrc/rasterizer.cpp`` — the built-in PDF renderer's anti-aliased
    path rasterizer: ``fill_edges``;
  * ``csrc/ccitt.cpp`` — CCITT Group 3/4 fax decoder for scanned PDFs:
    ``ccitt_decode``;
  * ``csrc/jbig2.cpp`` — JBIG2 (T.88) decoder for the PDF JBIG2Decode
    filter: ``jbig2_decode`` (its message: ``jbig2_last_error``).

A library that cannot be built raises ``KernelBuildError``; nothing here
has a pure-Python stand-in."""

import ctypes
import logging

import numpy as np

from ..ops._build import host_library

logger = logging.getLogger(__name__)

_SIGNED = set()
_U8P = ctypes.POINTER(ctypes.c_uint8)


def _load_dbnet_post():
    lib = host_library("dbnet_post")
    if "dbnet_post" not in _SIGNED:
        for name, ptr in (("dbnet_boxes", ctypes.c_float),
                          ("dbnet_boxes_u8", ctypes.c_uint8)):
            fn = getattr(lib, name)
            fn.argtypes = [
                ctypes.POINTER(ptr),
                ctypes.c_int, ctypes.c_int,
                ctypes.c_float, ctypes.c_float, ctypes.c_float,
                ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_int16),
                ctypes.POINTER(ctypes.c_float),
            ]
            fn.restype = ctypes.c_int
        _SIGNED.add("dbnet_post")
    return lib


def dbnet_boxes(
    prob: np.ndarray,
    thresh: float,
    box_thresh: float,
    unclip_ratio: float,
    min_size: int,
    max_candidates: int,
    dest_w: int,
    dest_h: int,
):
    """(H, W) probability map -> (quads list[(4,2) int], scores).

    Takes float32 maps, or uint8 wire maps (value = prob*255) directly:
    the u8 entry point thresholds and scores in the u8 domain."""
    lib = _load_dbnet_post()
    quads = np.zeros((max_candidates, 4, 2), dtype=np.int16)
    scores = np.zeros((max_candidates,), dtype=np.float32)
    if prob.dtype == np.uint8:
        prob = np.ascontiguousarray(prob)
        fn, ptr = lib.dbnet_boxes_u8, ctypes.c_uint8
    else:
        prob = np.ascontiguousarray(prob, dtype=np.float32)
        fn, ptr = lib.dbnet_boxes, ctypes.c_float
    h, w = prob.shape
    n = fn(
        prob.ctypes.data_as(ctypes.POINTER(ptr)),
        int(h), int(w),
        float(thresh), float(box_thresh), float(unclip_ratio),
        int(min_size), int(max_candidates),
        int(dest_w), int(dest_h),
        quads.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        scores.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return (
        [q.tolist() for q in quads[:n]],
        [float(s) for s in scores[:n]],
    )


def _load_rasterizer():
    lib = host_library("rasterizer")
    if "rasterizer" not in _SIGNED:
        lib.fill_edges.argtypes = [
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            _U8P,
        ]
        lib.fill_edges.restype = None
        _SIGNED.add("rasterizer")
    return lib


def fill_edges(edges: np.ndarray, w: int, h: int, fill_rule: str = "nonzero"):
    """Rasterize a flattened edge list to an (h, w) uint8 coverage mask.

    edges: (N, 4) float32 array of x0,y0,x1,y1 segments in pixel coords
    (closed contours: consecutive segments; closure edges must be
    included).  fill_rule: "nonzero" or "evenodd".
    """
    lib = _load_rasterizer()
    edges = np.ascontiguousarray(edges, dtype=np.float32)
    out = np.zeros((h, w), dtype=np.uint8)
    if len(edges) == 0 or w <= 0 or h <= 0:
        return out
    lib.fill_edges(
        edges.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        len(edges), int(w), int(h),
        0 if fill_rule == "nonzero" else 1,
        out.ctypes.data_as(_U8P),
    )
    return out


def _load_jbig2():
    lib = host_library("jbig2")
    if "jbig2" not in _SIGNED:
        lib.jbig2_decode.argtypes = [
            _U8P, ctypes.c_long, _U8P, ctypes.c_long,
            ctypes.c_int, ctypes.c_int, _U8P,
        ]
        lib.jbig2_decode.restype = ctypes.c_int
        lib.jbig2_last_error.argtypes = []
        lib.jbig2_last_error.restype = ctypes.c_char_p
        _SIGNED.add("jbig2")
    return lib


def jbig2_last_error() -> str:
    """The JBIG2 decoder's message for its last failed decode ("" if none)."""
    msg = _load_jbig2().jbig2_last_error()
    return msg.decode("utf-8", "replace") if msg else ""


def jbig2_decode(data: bytes, width: int, height: int, globals_data: bytes = b"") -> np.ndarray:
    """Decode a PDF-embedded JBIG2 stream -> (height, width) uint8, 1 = black.

    ``globals_data`` is the optional /JBIG2Globals stream (shared symbol
    dictionaries).  Raises ValueError with the decoder's message on
    unsupported or corrupt streams.  See csrc/jbig2.cpp.
    """
    if width <= 0 or height <= 0:
        return np.zeros((max(height, 0), max(width, 0)), np.uint8)
    lib = _load_jbig2()
    buf = np.frombuffer(data, np.uint8)
    gbuf = np.frombuffer(globals_data, np.uint8)
    out = np.zeros((height, width), np.uint8)
    r = lib.jbig2_decode(
        gbuf.ctypes.data_as(_U8P) if len(gbuf) else _U8P(),
        ctypes.c_long(len(gbuf)),
        buf.ctypes.data_as(_U8P) if len(buf) else _U8P(),
        ctypes.c_long(len(buf)),
        int(width), int(height),
        out.ctypes.data_as(_U8P),
    )
    if r != 0:
        raise ValueError("JBIG2 decode failed: %s" % (jbig2_last_error() or "?"))
    return out


def _load_ccitt():
    lib = host_library("ccitt")
    if "ccitt" not in _SIGNED:
        lib.ccitt_decode.argtypes = [
            _U8P, ctypes.c_long, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            _U8P, ctypes.c_int,
        ]
        lib.ccitt_decode.restype = ctypes.c_int
        _SIGNED.add("ccitt")
    return lib


def ccitt_decode(
    data: bytes, columns: int, rows: int, k: int = -1, byte_align: bool = False
) -> np.ndarray:
    """Decode CCITT Group 3/4 fax data -> (rows, columns) uint8, 1 = black.

    k < 0: Group 4 (T.6 MMR); k == 0: Group 3 1-D (MH); k > 0: Group 3
    mixed.  Rows the bitstream does not cover (truncated / corrupt tails)
    are left white.  See csrc/ccitt.cpp.
    """
    if rows <= 0 or columns <= 0:
        return np.zeros((max(rows, 0), max(columns, 0)), np.uint8)
    lib = _load_ccitt()
    buf = np.frombuffer(data, np.uint8)
    out = np.zeros((rows, columns), np.uint8)
    r = lib.ccitt_decode(
        buf.ctypes.data_as(_U8P),
        ctypes.c_long(len(buf)),
        int(columns), int(k),
        1 if byte_align else 0,
        out.ctypes.data_as(_U8P),
        int(rows),
    )
    if r < rows:
        logger.warning(
            "CCITT stream ended after %d of %d rows; remainder left white", r, rows
        )
    return out
