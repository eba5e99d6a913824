"""Separable resampling of axis-aligned page regions as two matmuls
(counterpart of yomitoku_tpu/ops/separable_resize.py's
``sample_regions_separable``).

``device_crop.sample_lines`` is a 2x2-supersampled bilinear gather for
any projective map.  The page-region crops of the pipeline (the
detector's and layout parser's full-page resize, the table crops) are
axis-aligned: x = sx*(u+du) + tx depends on the canvas column alone and y
on the row alone.  The 2x2 offsets form a product grid, so the averaged
bilinear kernel factors exactly into one clamped tent-weight matrix per
axis, and the crop becomes two dense contractions against them.

The contractions run in float64 and round to float32 at the end: never
on TF32, whatever the process-wide switches say (the JAX package runs
them at precision="highest"), and without touching those switches.  The
line crops take the gather: on the card it is the faster of the two, and
the separable program would contract the whole page for every line.
"""

import torch

#: per-axis supersample offsets: the 1-D factors of sample_lines' 2x2 grid
_TAPS = (-0.25, 0.25)
#: regions contracted at a time, so that the products stay a few hundred MB
_CHUNK = 4


def _axis_weights(scale, off, n_src, n_out, supersample):
    """(b,) scale and offset of an axis-aligned map -> (b, n_src, n_out)
    float32 weights: column j holds the clamped, supersample-averaged tent
    weights max(0, 1 - |l - x|) of the output coordinate
    x = scale * (j + du) + off.  A tent is nonzero at floor(x) and
    floor(x) + 1 only, so its two values are scattered into zeros: at most
    two meet in an entry, and the sum is the dense formula's to the bit, in
    any order, at a fraction of evaluating the tent over every source row."""
    j = torch.arange(n_out, dtype=torch.float32, device=scale.device)
    taps = _TAPS if supersample else (0.0,)
    w = torch.zeros((scale.shape[0], n_src, n_out), dtype=torch.float32, device=scale.device)
    for du in taps:
        xc = (scale[:, None] * (j[None, :] + du) + off[:, None]).clamp(0.0, n_src - 1.0)
        lo = torch.floor(xc)
        for src in (lo, lo + 1.0):
            # 0 past the last row
            weight = torch.clamp(1.0 - (src - xc).abs(), min=0.0) * (1.0 / len(taps))
            w.scatter_add_(1, src.clamp(max=n_src - 1.0).long()[:, None], weight[:, None])
    return w


def sample_regions_separable(page, mats, out_hw, flip_bgr=True, supersample=True):
    """sample_lines for axis-aligned region maps (m01 = m10 = 0, identity
    bottom row): (H, W, 3) uint8 page + (B, 3, 3) maps -> (B, oh, ow, 3)
    float32 crops in [0, 255], RGB when flip_bgr.

    The two contractions run in the cheaper order (the one whose first
    product has the smaller output), a few regions at a time."""
    H, W = page.shape[0], page.shape[1]
    oh, ow = out_hw
    paged = page.double()
    mats = mats.to(page.device, torch.float32)

    def resample(m):
        wx = _axis_weights(m[:, 0, 0], m[:, 0, 2], W, ow, supersample).double()
        wy = _axis_weights(m[:, 1, 1], m[:, 1, 2], H, oh, supersample).double()
        # FLOP of each order: W first = H*W*ow + H*ow*oh per region, H
        # first = H*W*oh + oh*W*ow
        if H * W * ow + H * ow * oh <= H * W * oh + oh * W * ow:
            t = torch.einsum("hwc,bwj->bhjc", paged, wx)
            return torch.einsum("bhjc,bhi->bijc", t, wy).float()
        t = torch.einsum("hwc,bhi->biwc", paged, wy)
        return torch.einsum("biwc,bwj->bijc", t, wx).float()

    out = torch.cat([resample(mats[s:s + _CHUNK]) for s in range(0, mats.shape[0], _CHUNK)])
    return out.flip(-1) if flip_bgr else out
