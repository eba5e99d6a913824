"""Multi-scale deformable attention of the port (replacing
``yomitoku_tpu/ops/pallas/deformable_attention.py``).

``ms_deformable_attention`` keeps the JAX function's name, argument order
and layouts: value (B, Len_v, nh, c) with the levels' maps flattened
row-major one after another, sampling locations (B, Lq, nh, P, 2) in [0, 1]
and attention weights (B, Lq, nh, P), the points of level 0 first ->
(B, Lq, nh * c).  Each point samples its level's map as ``grid_sample``
does (bilinear, zeros padding, align_corners=False) at
``loc * size - 0.5``.

On CPU tensors it runs the plain version ``ms_deformable_attention_reference``
(the JAX package's gather, ``deformable_attention_core``, in f32); on CUDA
tensors it launches the direct-gather kernel (csrc/deformable_attention.cu)
or raises.  Both upcast the locations and weights to f32, accumulate every
point of every level in f32 and round once to value's dtype, as the Pallas
kernel does.
"""

import ctypes

import torch

from ._build import library
from ._common import _code, _launch, launches, on_cpu, require_cuda


def _check(value, loc, att, spatial_shapes, num_points_list):
    """Shapes as int tuples, after checking that the arguments agree."""
    shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    points = tuple(int(n) for n in num_points_list)
    if value.dim() != 4:
        raise ValueError(f"value must be (B, Len_v, nh, c), got {tuple(value.shape)}")
    B, Len_v, nh, c = value.shape
    P = sum(points)
    Lq = loc.shape[1] if loc.dim() == 5 else -1
    if tuple(loc.shape) != (B, Lq, nh, P, 2) or tuple(att.shape) != (B, Lq, nh, P):
        raise ValueError(
            f"locations {tuple(loc.shape)} / weights {tuple(att.shape)} do not "
            f"match value {tuple(value.shape)} and {P} points"
        )
    if len(shapes) != len(points) or sum(h * w for h, w in shapes) != Len_v:
        raise ValueError(
            f"spatial shapes {shapes} (points {points}) do not cover Len_v={Len_v}"
        )
    return shapes, points


def ms_deformable_attention_reference(
    value, sampling_locations, attention_weights, spatial_shapes, num_points_list
):
    """Plain PyTorch version of ``ms_deformable_attention``: per level, the
    four bilinear taps as gathers, each masked to zero outside the map."""
    shapes, points = _check(value, sampling_locations, attention_weights,
                            spatial_shapes, num_points_list)
    B, _, nh, c = value.shape
    Lq = sampling_locations.shape[1]
    out = torch.zeros((B * nh, Lq, c), dtype=torch.float32, device=value.device)
    start = p0 = 0
    for (h, w), P in zip(shapes, points):
        v = value[:, start:start + h * w].float().permute(0, 2, 1, 3)
        v = v.reshape(B * nh, h * w, c)

        def heads_first(t):  # (B, Lq, nh, P) -> (B * nh, Lq * P)
            return t.float().permute(0, 2, 1, 3).reshape(B * nh, Lq * P)

        loc = sampling_locations[:, :, :, p0:p0 + P]
        px = heads_first(loc[..., 0]) * w - 0.5
        py = heads_first(loc[..., 1]) * h - 0.5
        att = heads_first(attention_weights[:, :, :, p0:p0 + P])
        x0, y0 = torch.floor(px), torch.floor(py)
        wx, wy = px - x0, py - y0
        sampled = torch.zeros((B * nh, Lq * P, c), dtype=torch.float32,
                              device=value.device)
        for dy in (0, 1):
            for dx in (0, 1):
                xi, yi = x0 + dx, y0 + dy
                inside = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
                idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).long()
                tap = torch.gather(v, 1, idx[..., None].expand(-1, -1, c))
                wt = (wx if dx else 1 - wx) * (wy if dy else 1 - wy)
                sampled += tap * (wt * inside)[..., None]
        out += (sampled * att[..., None]).reshape(B * nh, Lq, P, c).sum(2)
        start += h * w
        p0 += P
    out = out.reshape(B, nh, Lq, c).permute(0, 2, 1, 3).reshape(B, Lq, nh * c)
    return out.to(value.dtype)


def ms_deformable_attention(
    value, sampling_locations, attention_weights, spatial_shapes, num_points_list
):
    """Multi-scale deformable attention -> (B, Lq, nh * c) in value's dtype.
    One launch for all levels and any Lq."""
    shapes, points = _check(value, sampling_locations, attention_weights,
                            spatial_shapes, num_points_list)
    if on_cpu(value, sampling_locations, attention_weights):
        return ms_deformable_attention_reference(
            value, sampling_locations, attention_weights, shapes, points
        )
    name = "ms_deformable_attention"
    require_cuda(name, value, sampling_locations, attention_weights)
    B, Len_v, nh, c = value.shape
    Lq = sampling_locations.shape[1]
    if c > 128:
        raise ValueError(f"{name}: {c} channels per head > 128")
    value = value.contiguous()
    loc = sampling_locations.contiguous()
    att = attention_weights.contiguous()
    out = torch.empty((B, Lq, nh * c), dtype=value.dtype, device=value.device)
    lib = library()
    hw = (ctypes.c_int * (2 * len(shapes)))(*[n for s in shapes for n in s])
    npts = (ctypes.c_int * len(points))(*points)
    rc = _launch(
        value.device, lib.lib.yt_ms_deformable_attention,
        _code(value), value.data_ptr(), loc.data_ptr(), att.data_ptr(),
        out.data_ptr(), B, Len_v, nh, c, Lq, len(shapes), hw, npts,
    )
    lib.check(rc, "yt_ms_deformable_attention launch")
    launches[name] += 1
    return out
