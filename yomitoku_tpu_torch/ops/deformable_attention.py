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
tensors it launches the gather kernel (csrc/deformable_attention.cu) by the
route ``ops._common.deform_route`` picks, or raises.  Both upcast the
locations and weights to f32, accumulate every point of every level in f32
and round once to value's dtype, as the Pallas kernel does.
"""

import ctypes
import functools
from typing import NamedTuple

import torch

from ._build import library
from ._common import (
    DEFORM_ROUTES,
    _code,
    _launch,
    deform_route,
    deform_route_launches,
    launches,
    on_cpu,
    require_cuda,
)


class _Plan(NamedTuple):
    """The level layout of one (spatial_shapes, num_points_list)."""

    shapes: tuple  # ((H, W), ...) as ints
    points: tuple  # points per level, as ints
    len_v: int  # rows of value: sum of H * W
    total: int  # P: sum of the points
    hw: object  # ctypes int[2 * levels]: (H, W) per level
    npts: object  # ctypes int[levels]


@functools.lru_cache(maxsize=64)
def _plan(shapes, points):
    """The cached ``_Plan`` of hashable (shapes, points): built once per
    layout, so a call makes no ctypes array and sums no level sizes."""
    shapes = tuple((int(h), int(w)) for h, w in shapes)
    points = tuple(int(n) for n in points)
    return _Plan(
        shapes, points, sum(h * w for h, w in shapes), sum(points),
        (ctypes.c_int * (2 * len(shapes)))(*[n for s in shapes for n in s]),
        (ctypes.c_int * len(points))(*points),
    )


def _check(value, loc, att, spatial_shapes, num_points_list):
    """The plan of (spatial_shapes, num_points_list), after checking that
    the arguments agree."""
    plan = _plan(tuple(map(tuple, spatial_shapes)), tuple(num_points_list))
    if value.dim() != 4:
        raise ValueError(f"value must be (B, Len_v, nh, c), got {tuple(value.shape)}")
    B, Len_v, nh, c = value.shape
    P = plan.total
    Lq = loc.shape[1] if loc.dim() == 5 else -1
    if loc.shape != (B, Lq, nh, P, 2) or att.shape != (B, Lq, nh, P):
        raise ValueError(
            f"locations {tuple(loc.shape)} / weights {tuple(att.shape)} do not "
            f"match value {tuple(value.shape)} and {P} points"
        )
    if len(plan.shapes) != len(plan.points) or plan.len_v != Len_v:
        raise ValueError(
            f"spatial shapes {plan.shapes} (points {plan.points}) do not cover Len_v={Len_v}"
        )
    return plan


def ms_deformable_attention_reference(
    value, sampling_locations, attention_weights, spatial_shapes, num_points_list
):
    """Plain PyTorch version of ``ms_deformable_attention``: per level, the
    four bilinear taps as gathers, each masked to zero outside the map.  It
    walks (spatial_shapes, num_points_list) itself, apart from the kernel's
    cached plan."""
    B, _, nh, c = value.shape
    Lq = sampling_locations.shape[1]
    out = torch.zeros((B * nh, Lq, c), dtype=torch.float32, device=value.device)
    start = p0 = 0
    for (h, w), P in zip(spatial_shapes, num_points_list):
        h, w, P = int(h), int(w), int(P)
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
    One launch for all levels, any Lq and any points, c <= 128."""
    plan = _check(value, sampling_locations, attention_weights, spatial_shapes,
                  num_points_list)
    if on_cpu(value, sampling_locations, attention_weights):
        return ms_deformable_attention_reference(
            value, sampling_locations, attention_weights, spatial_shapes, num_points_list
        )
    name = "ms_deformable_attention"
    require_cuda(name, value, sampling_locations, attention_weights)
    B, Len_v, nh, c = value.shape
    Lq = sampling_locations.shape[1]
    value = value.contiguous()
    loc = sampling_locations.contiguous()
    att = attention_weights.contiguous()
    ptr = value.data_ptr()
    route = deform_route(value.dtype, c, ptr % 16 == 0)
    out = value.new_empty((B, Lq, nh * c))
    lib = library()
    rc = _launch(
        value.device, lib.lib.yt_ms_deformable_attention,
        DEFORM_ROUTES[route], _code(value), ptr, loc.data_ptr(), att.data_ptr(),
        out.data_ptr(), B, Len_v, nh, c, Lq, len(plan.shapes), plan.hw, plan.npts,
    )
    if rc:
        lib.check(rc, f"yt_ms_deformable_attention launch ({route})")
    launches[name] += 1
    deform_route_launches[route] += 1
    return out
