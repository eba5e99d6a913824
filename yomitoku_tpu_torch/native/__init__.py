"""The port's host C++ (counterpart of yomitoku_tpu/native/__init__.py,
reduced to ``dbnet_boxes``): DBNet probability-map postprocessing in
``csrc/dbnet_post.cpp`` (run-length connected components, rotating-calipers
min-area rects, analytic unclip), built at first use by
``ops._build.host_library`` and bound through ctypes."""

import ctypes

import numpy as np

from ..ops._build import host_library

_SIGNED = set()


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
