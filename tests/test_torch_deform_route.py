"""The deformable attention kernel's host side, pinned on the CPU: the
route ``ops._common.deform_route`` picks by dtype, channels and alignment,
the wrapper's cached level plan, and what the wrapper hands the C entry
through ``_launch`` (with ``on_cpu``, ``require_cuda`` and the library
replaced by stand-ins, so the CUDA branch runs on CPU tensors).  The kernel
itself runs only on the card (tests/test_torch_cuda.py, chip_smoke.py)."""

import ctypes

import numpy as np
import pytest
import torch

import chip_smoke
from yomitoku_tpu_torch import ops
from yomitoku_tpu_torch.ops import _common, deformable_attention
from yomitoku_tpu_torch.ops._common import DEFORM_ROUTES, deform_route

BF16, F32 = torch.bfloat16, torch.float32
SHAPES, POINTS = ((8, 8), (4, 4), (2, 2)), (4, 2, 1)


@pytest.mark.parametrize("dtype,c,aligned,want", [
    (BF16, 32, True, "vector"),    # RT-DETR: 64-byte rows, 4 lanes
    (F32, 32, True, "vector"),     # 128-byte rows, 8 lanes
    (BF16, 8, True, "vector"),     # one 16-byte piece
    (F32, 4, True, "vector"),
    (BF16, 24, True, "vector"),    # 48 bytes: 3 pieces on 4 lanes
    (F32, 24, True, "vector"),     # 96 bytes: 6 pieces on 8 lanes
    (BF16, 128, True, "vector"),
    (F32, 128, True, "vector"),    # 32 lanes
    (BF16, 20, True, "scalar"),    # 40 bytes: not whole pieces
    (F32, 6, True, "scalar"),
    (BF16, 4, True, "scalar"),
    (F32, 1, True, "scalar"),
    (BF16, 32, False, "scalar"),   # value's base off 16-byte alignment
    (F32, 128, False, "scalar"),
])
def test_route_by_dtype_channels_and_alignment(dtype, c, aligned, want):
    assert deform_route(dtype, c, aligned) == want


def test_the_layout_path_takes_the_vector_route():
    """RT-DETR's decoder (hidden 256, 8 heads) on a fresh bf16 tensor."""
    assert deform_route(BF16, chip_smoke.D_DETR // 8, True) == "vector"


@pytest.mark.parametrize("c", [0, 129, 256])
def test_channels_beyond_the_kernel_raise(c):
    with pytest.raises(ValueError, match="channels per head"):
        deform_route(BF16, c, True)


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_other_dtypes_raise(dtype):
    with pytest.raises(TypeError, match="float32, bfloat16"):
        deform_route(dtype, 32, True)


def test_routes_match_the_c_interface():
    assert DEFORM_ROUTES == {"vector": 1, "scalar": 2}
    assert set(_common.deform_route_launches) == set(DEFORM_ROUTES)


def _inputs(B=2, Lq=5, nh=2, c=32, dtype=F32, seed=0):
    rng = np.random.default_rng(seed)
    len_v, P = sum(h * w for h, w in SHAPES), sum(POINTS)
    att = rng.random((B, Lq, nh, P))
    arrays = [rng.standard_normal((B, len_v, nh, c)), rng.random((B, Lq, nh, P, 2)),
              att / att.sum(-1, keepdims=True)]
    return [torch.from_numpy(a.astype(np.float32)).to(dtype) for a in arrays]


def test_plan_is_built_once_per_layout():
    """The plan's ctypes arrays hold the shapes and points; a second call,
    with the shapes as a list as the models pass them, reuses it."""
    value, loc, att = _inputs()
    plan = deformable_attention._check(value, loc, att, SHAPES, POINTS)
    assert list(plan.hw) == [n for hw in SHAPES for n in hw]
    assert list(plan.npts) == list(POINTS)
    assert isinstance(plan.hw, ctypes.Array) and isinstance(plan.npts, ctypes.Array)
    assert (plan.shapes, plan.points, plan.len_v, plan.total) == (SHAPES, POINTS, 84, 7)
    again = deformable_attention._check(value, loc, att, [list(s) for s in SHAPES], list(POINTS))
    assert again is plan


def test_refusals_hold_with_a_cached_plan():
    value, loc, att = _inputs()
    deformable_attention._check(value, loc, att, SHAPES, POINTS)
    with pytest.raises(ValueError, match="do not cover"):
        ops.ms_deformable_attention(value, loc, att, SHAPES[:2], POINTS)
    with pytest.raises(ValueError, match="do not cover"):
        ops.ms_deformable_attention(value, loc, att, SHAPES + ((1, 1),), POINTS)
    with pytest.raises(ValueError, match="do not match"):
        ops.ms_deformable_attention(value, loc[:, :, :, :6], att, SHAPES, POINTS)
    with pytest.raises(ValueError, match="must be"):
        ops.ms_deformable_attention(value[0], loc, att, SHAPES, POINTS)


class _FakeLib:
    """Stands in for the kernel library: records the C entry's arguments."""

    def __init__(self, rc=0):
        self.rc = rc
        self.calls = []
        self.lib = self

    def yt_ms_deformable_attention(self, *args):
        raise AssertionError("the wrapper must call the C entry through _launch")

    def check(self, code, what):
        raise RuntimeError(f"{what}: CUDA error {code}")


@pytest.fixture
def on_card(monkeypatch):
    """The wrapper's CUDA branch on CPU tensors: ``_launch`` records the
    call, the library is a stand-in."""
    fake = _FakeLib()

    def launch(device, fn, *args):
        fake.calls.append((device, fn, args))
        return fake.rc

    monkeypatch.setattr(deformable_attention, "on_cpu", lambda *t: False)
    monkeypatch.setattr(deformable_attention, "require_cuda", lambda name, *t: None)
    monkeypatch.setattr(deformable_attention, "library", lambda: fake)
    monkeypatch.setattr(deformable_attention, "_launch", launch)
    ops.reset_launches()
    yield fake
    ops.reset_launches()


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_wrapper_launches_through_launch(on_card, dtype):
    """One ``_launch`` per call with the route's code, the storage code,
    the four data pointers, the shapes and the plan's cached arrays; one
    launch counted, on the route taken."""
    value, loc, att = _inputs(dtype=dtype)
    for n in (1, 2):
        out = ops.ms_deformable_attention(value, loc, att, SHAPES, POINTS)
        assert out.shape == (2, 5, 64) and out.dtype == dtype
        device, fn, args = on_card.calls[-1]
        assert device == value.device and fn == on_card.yt_ms_deformable_attention
        plan = deformable_attention._check(value, loc, att, SHAPES, POINTS)
        assert args == (DEFORM_ROUTES["vector"], _common._code(value), value.data_ptr(),
                        loc.data_ptr(), att.data_ptr(), out.data_ptr(), 2, 84, 2, 32, 5, 3,
                        plan.hw, plan.npts)
        assert ops.launches["ms_deformable_attention"] == n
        assert _common.deform_route_launches == {"vector": n, "scalar": 0}


@pytest.mark.parametrize("batch", [1, 2, 8, 16, 64])
def test_table_batches_take_the_vector_route(on_card, batch):
    """RT-DETR's decoder at 640x640 (value (B, 8400, 8, 32), 300 queries,
    4 points per level) at the table recognizer's page-route batches: the
    vector route, B handed to the C entry, the level plan of the batch-1
    layout reused (it does not depend on B)."""
    lv = sum(h * w for h, w in chip_smoke.LEVELS)
    value = torch.empty(batch, lv, 8, 32, dtype=BF16)  # never read here
    loc = torch.zeros(batch, 300, 8, 12, 2, dtype=BF16)
    att = torch.zeros(batch, 300, 8, 12, dtype=BF16)
    out = ops.ms_deformable_attention(value, loc, att, chip_smoke.LEVELS, chip_smoke.POINTS)
    assert out.shape == (batch, 300, 256)
    _, _, args = on_card.calls[-1]
    assert args[0] == DEFORM_ROUTES["vector"] and args[6:12] == (batch, lv, 8, 32, 300, 3)
    plan = deformable_attention._check(value, loc, att, chip_smoke.LEVELS, chip_smoke.POINTS)
    small = deformable_attention._check(value[:1], loc[:1], att[:1], chip_smoke.LEVELS,
                                        chip_smoke.POINTS)
    assert plan is small
    assert _common.deform_route_launches == {"vector": 1, "scalar": 0}


def test_offset_value_takes_the_scalar_route(on_card):
    """Value as a view one element off 16-byte alignment: the scalar route,
    on that view's own pointer (no copy)."""
    value, loc, att = _inputs(dtype=BF16)
    off = torch.empty(value.numel() + 1, dtype=BF16)[1:].view(value.shape).copy_(value)
    assert off.data_ptr() % 16
    ops.ms_deformable_attention(off, loc, att, SHAPES, POINTS)
    _, _, args = on_card.calls[-1]
    assert args[0] == DEFORM_ROUTES["scalar"] and args[2] == off.data_ptr()
    assert _common.deform_route_launches == {"vector": 0, "scalar": 1}


def test_strided_inputs_are_made_contiguous(on_card):
    value, loc, att = _inputs()
    t = value.transpose(1, 2).contiguous().transpose(1, 2)  # (B, Len_v, nh, c) view
    assert not t.is_contiguous()
    ops.ms_deformable_attention(t, loc, att, SHAPES, POINTS)
    _, _, args = on_card.calls[-1]
    assert args[2] != t.data_ptr()


def test_channels_beyond_the_kernel_raise_on_the_card(on_card):
    value, loc, att = _inputs(c=136)
    with pytest.raises(ValueError, match="channels per head"):
        ops.ms_deformable_attention(value, loc, att, SHAPES, POINTS)
    assert not on_card.calls and not ops.launches["ms_deformable_attention"]


def test_a_failed_launch_raises_and_counts_nothing(on_card):
    on_card.rc = 700
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        ops.ms_deformable_attention(*_inputs(), SHAPES, POINTS)
    assert not ops.launches["ms_deformable_attention"]
    assert not any(_common.deform_route_launches.values())


def test_reset_launches_clears_deform_routes():
    _common.deform_route_launches["scalar"] += 3
    _common.reset_launches()
    assert not any(_common.deform_route_launches.values())


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_cpu_tensors_take_the_plain_version(dtype):
    """On CPU tensors the wrapper returns the plain version's values and
    counts nothing: no launch, no route."""
    args = _inputs(dtype=dtype, seed=3)
    ops.reset_launches()
    got = ops.ms_deformable_attention(*args, SHAPES, POINTS)
    assert torch.equal(got, ops.ms_deformable_attention_reference(*args, SHAPES, POINTS))
    assert not any(ops.launches.values())
    assert not any(_common.deform_route_launches.values())


def test_plain_version_walks_the_levels_without_the_plan(monkeypatch):
    """The plain version derives the level layout itself, so a wrong cached
    plan cannot agree with it."""
    args = _inputs(seed=4)
    want = ops.ms_deformable_attention_reference(*args, SHAPES, POINTS)

    def no_plan(*a):
        raise AssertionError("the plain version reached the kernel's plan")

    monkeypatch.setattr(deformable_attention, "_plan", no_plan)
    assert torch.equal(ops.ms_deformable_attention_reference(*args, SHAPES, POINTS), want)


@pytest.mark.parametrize("spread", [1.0, 1.6])
def test_bound_counts_the_value_rows_the_taps_need(spread):
    """chip_smoke's deformable bound counts the value rows whose gradient
    through the plain version is not 0 (every weight is positive, so
    nothing cancels): in-map corners with a weight, off-map and zero-weight
    corners left out."""
    value, loc, att = _inputs(seed=5)
    loc = loc * spread - (spread - 1) / 2
    att[0, 0, 0, 0] = 0
    v = value.clone().requires_grad_(True)
    ops.ms_deformable_attention_reference(v, loc, att, SHAPES, POINTS).sum().backward()
    rows, taps = chip_smoke.deform_needed(value, loc, att, SHAPES, POINTS)
    assert rows == int((v.grad.abs().sum(-1) != 0).sum())
    assert rows <= taps <= value.shape[0] * loc.shape[1] * value.shape[2] * sum(POINTS) * 4
    out = torch.empty(2, 5, 64)
    bounds = chip_smoke.deform_bound([value, loc, att], out, SHAPES, POINTS)
    assert bounds["bound_rows"] == rows and bounds["value_rows"] == 2 * 84 * 2
    assert bounds["bound_ms"] <= bounds["bound_all_rows_ms"]
