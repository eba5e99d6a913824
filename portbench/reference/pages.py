"""The detector's page input and the recognizer's line crops, worked out
from the page and the quads alone.

Detector: the page resized so that its shorter side is 1280 and its
longer at most 1600, each side snapped down to a multiple of 32, by
area-like resampling (each output pixel the mean of a 2x2 grid of
bilinear taps at +-1/4 pixel), then standardized with ImageNet's RGB
statistics applied to the BGR channels in order (upstream flips the
channels twice).

Lines: each quad's rectangle (|p0 - p1| x |p1 - p2| as integers) shrunk
to fit the 32x800 canvas (never enlarged), at its top-left, by the same
2x2 supersampled bilinear taps; the rest of the canvas black; RGB;
scaled to [-1, 1].
"""

import numpy as np
import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
TAPS = (-0.25, 0.25)


def detector_size(h, w, shortest, limit):
    """(out_h, out_w) of the detector's resize."""
    scale = shortest / min(h, w)
    nh, nw = (shortest, int(w * scale)) if h < w else (int(h * scale), shortest)
    if max(nh, nw) > limit:
        s = float(limit) / max(nh, nw)
        nh, nw = int(nh * s), int(nw * s)
    return max(int(nh / 32) * 32, 32), max(int(nw / 32) * 32, 32)


def _axis_matrix(n_src, n_out, device):
    """(n_out, n_src) float64 weights of the area-like resample of one axis."""
    scale = n_src / n_out
    j = torch.arange(n_out, dtype=torch.float64, device=device)
    m = torch.zeros((n_out, n_src), dtype=torch.float64, device=device)
    for du in TAPS:
        x = (scale * (j + du) + 0.5 * scale - 0.5).clamp(0.0, n_src - 1.0)
        src = torch.arange(n_src, dtype=torch.float64, device=device)
        m += torch.clamp(1.0 - (src[None, :] - x[:, None]).abs(), min=0.0) / len(TAPS)
    return m


def detector_input(page_bgr, out_hw):
    """(H, W, 3) uint8 tensor -> (1, 3, oh, ow) standardized float32."""
    H, W = page_bgr.shape[:2]
    wy = _axis_matrix(H, out_hw[0], page_bgr.device)
    wx = _axis_matrix(W, out_hw[1], page_bgr.device)
    img = page_bgr.double().permute(2, 0, 1)  # (3, H, W), BGR
    resized = (wy @ img @ wx.T).float()
    mean = torch.tensor(IMAGENET_MEAN, device=page_bgr.device)[:, None, None] * 255.0
    std = torch.tensor(IMAGENET_STD, device=page_bgr.device)[:, None, None] * 255.0
    return ((resized - mean) / std)[None]


def line_crops(page_bgr, quads, out_hw=(32, 800)):
    """(H, W, 3) uint8 tensor and N axis-aligned integer quads [TL, TR, BR,
    BL] -> (N, oh, ow, 3) RGB crops in [-1, 1], float32."""
    H, W = page_bgr.shape[:2]
    oh, ow = out_hw
    dev = page_bgr.device
    page = page_bgr.double()
    out = torch.zeros((len(quads), oh, ow, 3), dtype=torch.float64, device=dev)
    for n, q in enumerate(np.asarray(quads, dtype=np.int64)):
        (x0, y0), (x1, _), (_, y1) = q[0], q[1], q[2]
        if not (q[0][1] == q[1][1] and q[1][0] == q[2][0] and q[3][0] == q[0][0]):
            raise NotImplementedError("the reference crops axis-aligned quads only")
        w, h = max(int(x1 - x0), 1), max(int(y1 - y0), 1)
        if h > 2 * w:
            raise NotImplementedError("the reference crops horizontal lines only")
        scale = min(1.0, ow / w, oh / h)
        nw, nh = max(int(w * scale), 1), max(int(h * scale), 1)
        ix, iy = w / nw, h / nh
        u = torch.arange(nw, dtype=torch.float64, device=dev)
        v = torch.arange(nh, dtype=torch.float64, device=dev)
        acc = 0.0
        for dv in TAPS:
            for du in TAPS:
                x = (x0 + ix * (u + du) + 0.5 * ix - 0.5).clamp(0.0, W - 1.0)
                y = (y0 + iy * (v + dv) + 0.5 * iy - 0.5).clamp(0.0, H - 1.0)
                xa, ya = x.floor().long(), y.floor().long()
                xb, yb = (xa + 1).clamp(max=W - 1), (ya + 1).clamp(max=H - 1)
                fx, fy = (x - xa)[None, :, None], (y - ya)[:, None, None]
                top = page[ya][:, xa] * (1 - fx) + page[ya][:, xb] * fx
                bot = page[yb][:, xa] * (1 - fx) + page[yb][:, xb] * fx
                acc = acc + top * (1 - fy) + bot * fy
        out[n, :nh, :nw] = acc / 4.0
    return out.flip(-1).float() / 127.5 - 1.0
