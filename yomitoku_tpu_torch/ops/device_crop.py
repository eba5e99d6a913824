"""Page crops and resizes on the device (counterpart of
yomitoku_tpu/ops/device_crop.py).

The page is uploaded once as uint8 (``DevicePage``), padded on the device
to a multiple of 512, and shared by the detector, the layout parser, the
table recognizer and the line recognizer.  Every crop is one composed
3x3 map per line or region, from the model's canvas to the page:

    canvas (32x800) --inverse pad/resize--> rotated crop --undo rotation-->
    rectified crop --homography--> page

The maps are computed on the host (``line_homographies``, ``region_mats``:
copies of the JAX package's numpy/cv2 code, equal bit for bit) and the
device samples the page through them: ``sample_lines`` here is the
2x2-supersampled bilinear gather for any projective map, which crops
every line; ``ops/separable_resize.py`` does the page-region resizes as
two matmuls.
The 2x2 supersample approximates the host's INTER_AREA shrink (exact for
scale >= 0.5); YOMITOKU_TPU_HOST_CROPS=1 keeps the host cv2 crops.
"""

import functools
import os

import cv2
import numpy as np
import torch

from ..utils.stagetrace import segment

#: supersample offsets in canvas pixel space (2x2 box for an INTER_AREA-like
#: shrink)
_OFFSETS = ((-0.25, -0.25), (-0.25, 0.25), (0.25, -0.25), (0.25, 0.25))


def line_homographies(
    quads, out_hw=(32, 800), thresh_aspect: float = 2.0, rot180: bool = False
):
    """Per-quad composed canvas->page homographies, following the host
    route: rect dims (|p0-p1|, |p1-p2|) as ints, a 90-degree CCW rotation
    when h > thresh_aspect * w, a shrink-only top-left fit into out_hw.
    ``rot180`` also flips the (possibly rotated) crop by 180 degrees, for
    the orientation fallback's retry.

    Returns (mats (N, 3, 3) float32, valid (N, 2) int32 [new_w, new_h]).
    """
    oh, ow = out_hw
    mats = np.zeros((len(quads), 3, 3), np.float32)
    valid = np.zeros((len(quads), 2), np.int32)
    for i, quad in enumerate(quads):
        # the host route casts quads to int64 before measuring and warping
        q = np.asarray(quad, dtype=np.int64).astype(np.float64)
        w = max(int(np.linalg.norm(q[0] - q[1])), 1)
        h = max(int(np.linalg.norm(q[1] - q[2])), 1)
        rect = np.float32([[0, 0], [w, 0], [w, h], [0, h]])
        M_rp = cv2.getPerspectiveTransform(rect, q.astype(np.float32))

        rotated = h > thresh_aspect * w
        if rotated:
            # rotated crop (h_rot, w_rot) = (w, h); rotated (x, y) ->
            # rect (x_r, y_r) = (w - 1 - y, x)
            R = np.array(
                [[0.0, -1.0, w - 1.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                np.float64,
            )
            rw, rh = h, w
        else:
            R = np.eye(3)
            rw, rh = w, h

        if rot180:
            # rotated-crop coords (x, y) -> (rw - 1 - x, rh - 1 - y)
            R = R @ np.array(
                [
                    [-1.0, 0.0, rw - 1.0],
                    [0.0, -1.0, rh - 1.0],
                    [0.0, 0.0, 1.0],
                ],
                np.float64,
            )

        scale = min(1.0, ow / rw, oh / rh)
        new_w = max(int(rw * scale), 1)
        new_h = max(int(rh * scale), 1)
        # cv2.resize maps canvas u to the crop coordinate
        # (u + 0.5) * rw / new_w - 0.5, per axis
        ix = rw / new_w
        iy = rh / new_h
        S = np.array(
            [
                [ix, 0.0, 0.5 * ix - 0.5],
                [0.0, iy, 0.5 * iy - 0.5],
                [0.0, 0.0, 1.0],
            ],
            np.float64,
        )
        mats[i] = (M_rp.astype(np.float64) @ R @ S).astype(np.float32)
        valid[i] = (new_w, new_h)
    return mats, valid


def pad_page(page: np.ndarray, align: int = 512):
    """Pad a (H, W, 3) uint8 page with black to multiples of ``align``;
    crops never sample the padding (quads are validated inside the page)."""
    h, w = page.shape[:2]
    ph = -(-h // align) * align
    pw = -(-w // align) * align
    if (ph, pw) == (h, w):
        return np.ascontiguousarray(page)
    out = np.zeros((ph, pw, 3), page.dtype)
    out[:h, :w] = page
    return out


def region_mats(regions, out_hw):
    """Axis-aligned page regions (x1, y1, x2, y2) -> canvas->page affine
    maps of an INTER_AREA-style resize to out_hw (the layout and table
    preprocess: crop, then cv2.resize INTER_AREA).

    Returns (mats (N, 3, 3) float32, valid (N, 2) int32 = full canvas).
    """
    oh, ow = out_hw
    mats = np.zeros((len(regions), 3, 3), np.float32)
    for i, (x1, y1, x2, y2) in enumerate(regions):
        sx = (x2 - x1) / ow
        sy = (y2 - y1) / oh
        mats[i] = np.array(
            [
                [sx, 0.0, x1 + 0.5 * sx - 0.5],
                [0.0, sy, y1 + 0.5 * sy - 0.5],
                [0.0, 0.0, 1.0],
            ],
            np.float32,
        )
    valid = np.tile(np.int32([ow, oh]), (len(regions), 1))
    return mats, valid


@functools.lru_cache(maxsize=512)
def _staged_page_mat(page_hw, out_hw, device):
    (h, w) = page_hw
    mat, _ = region_mats([(0, 0, w, h)], out_hw)
    return torch.from_numpy(mat).to(device)


def staged_page_mat(page_hw, out_hw, device):
    """The (1, 3, 3) affine of a full-page resize, on ``device``, cached
    per (page_hw, out_hw, device): page sizes repeat across a document, so
    the map is uploaded once.  Each entry lives on the device of its key."""
    return _staged_page_mat(tuple(page_hw), tuple(out_hw), torch.device(device))


def device_crops_enabled(device) -> bool:
    """Crops and resizes on the device: on for a CUDA device, off on the
    CPU, where the host cv2 route is the exact-parity reference.
    YOMITOKU_TPU_HOST_CROPS=1 forces the host route;
    YOMITOKU_TPU_DEVICE_CROPS=1 forces the device route, on the CPU too."""
    if os.environ.get("YOMITOKU_TPU_HOST_CROPS"):
        return False
    if os.environ.get("YOMITOKU_TPU_DEVICE_CROPS"):
        return True
    return torch.device(device).type == "cuda"


class DevicePage:
    """One uint8 BGR page uploaded once and shared by the detector, the
    layout parser, the table recognizer and the line recognizer.  The
    exact-size page crosses to ``device``; the padding to a multiple of
    ``align`` is made there."""

    def __init__(self, img_bgr: np.ndarray, device, align: int = 512):
        h, w = img_bgr.shape[:2]
        self.hw = (h, w)
        self.device = torch.device(device)
        ph = -(-h // align) * align
        pw = -(-w // align) * align
        with segment("page", "upload", nbytes=img_bgr.nbytes):
            src = torch.from_numpy(np.ascontiguousarray(img_bgr)).to(self.device)
            if (ph, pw) != (h, w):
                dev = torch.zeros((ph, pw, 3), dtype=torch.uint8, device=self.device)
                dev[:h, :w] = src
                src = dev
        self.dev = src


def lies_on(page, device) -> bool:
    """Whether ``page`` lies on ``device`` ("cuda" without an index takes
    a page of any card)."""
    dev, want = page.dev.device, torch.device(device)
    return dev.type == want.type and (want.index is None or dev.index == want.index)


def page_on(page, device):
    """``page.dev``, which must lie on ``device``: the page route never
    moves the page to another device."""
    if not lies_on(page, device):
        raise ValueError(f"the page lies on {page.dev.device}, the model on {device}")
    return page.dev


def sample_lines(page, mats, valid_wh, out_hw=(32, 800), flip_bgr=True,
                 supersample=True):
    """(H, W, 3) uint8 page + (B, 3, 3) canvas->page maps (float32 tensors
    on the page's device) -> (B, oh, ow, 3) float32 crops in [0, 255] (RGB
    when flip_bgr).

    2x2-supersampled bilinear gather with border clamping (one centred
    tap when supersample=False); canvas pixels beyond each line's
    (new_w, new_h) in ``valid_wh`` are zero (black padding)."""
    H, W = page.shape[0], page.shape[1]
    oh, ow = out_hw
    dev = page.device
    flat = page.reshape(-1, 3)
    mats = mats.to(dev, torch.float32)
    valid_wh = valid_wh.to(dev)
    yo, xo = torch.meshgrid(
        torch.arange(oh, dtype=torch.float32, device=dev),
        torch.arange(ow, dtype=torch.float32, device=dev),
        indexing="ij",
    )
    m = mats[:, None, None, :, :]  # (B, 1, 1, 3, 3)

    def gather_bilinear(x, y):
        x = x.clamp(0.0, W - 1.0)
        y = y.clamp(0.0, H - 1.0)
        x0 = torch.floor(x)
        y0 = torch.floor(y)
        fx = (x - x0)[..., None]
        fy = (y - y0)[..., None]
        x0 = x0.long()
        y0 = y0.long()
        x1 = torch.clamp(x0 + 1, max=W - 1)
        y1 = torch.clamp(y0 + 1, max=H - 1)

        def tap(yi, xi):
            return flat[yi * W + xi].float()

        top = tap(y0, x0) * (1 - fx) + tap(y0, x1) * fx
        bot = tap(y1, x0) * (1 - fx) + tap(y1, x1) * fx
        return top * (1 - fy) + bot * fy

    def sample_at(du, dv):
        u = xo + du
        v = yo + dv
        xs = m[..., 0, 0] * u + m[..., 0, 1] * v + m[..., 0, 2]
        ys = m[..., 1, 0] * u + m[..., 1, 1] * v + m[..., 1, 2]
        ws = m[..., 2, 0] * u + m[..., 2, 1] * v + m[..., 2, 2]
        ws = torch.where(ws.abs() < 1e-8, torch.full_like(ws, 1e-8), ws)
        return gather_bilinear(xs / ws, ys / ws)

    if supersample:
        acc = torch.zeros((mats.shape[0], oh, ow, 3), dtype=torch.float32, device=dev)
        for du, dv in _OFFSETS:
            acc = acc + sample_at(du, dv)
        crops = acc * 0.25
    else:
        crops = sample_at(0.0, 0.0)
    if flip_bgr:
        crops = crops.flip(-1)
    mask = (xo[None] < valid_wh[:, None, None, 0].float()) & (
        yo[None] < valid_wh[:, None, None, 1].float()
    )
    return torch.where(mask[..., None], crops, torch.zeros((), device=dev))
