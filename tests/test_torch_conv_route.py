"""The convolution kernel's plans (``ops._common.conv_route``,
``conv_patch``, ``conv_plan``, ``block_plans``), pinned on the CPU: which
route, patch and K splits each convolution of the fused backbone's path
reaches is plain Python, so it is checked here; the kernel itself runs only
on the card (tests/test_torch_cuda.py, chip_smoke.py).  Also: the wrappers
launch through ``_launch``, and CPU tensors take the plain version."""

import inspect

import numpy as np
import pytest
import torch

import chip_smoke
from yomitoku_tpu_torch import ops
from yomitoku_tpu_torch.ops import _common, bottleneck, deformable_attention, stage
from yomitoku_tpu_torch.ops._common import (
    CONV_ROUTES,
    CONV_TILE_ROWS,
    block_plans,
    conv_k_steps,
    conv_legal,
    conv_padding,
    conv_patch,
    conv_route,
    conv_splits,
    conv_units,
)

BF16, F32 = torch.bfloat16, torch.float32
SMS = (132, 114)  # H100 SXM and PCIe
WGMMA = ("wgmma", "wgmma_small", "wgmma_split")


def _path_blocks():
    """(label, H, W, Cin, Cm, Cout, proj) of every block shape of the fused
    backbone's path: chip_smoke's 7 bottleneck and 4 stage shapes."""
    blocks = [(label, H, W, cin, cm, cout, proj)
              for label, (H, W, cin, cm, cout, _, proj) in chip_smoke.BOTTLENECK_SHAPES.items()]
    blocks += [(label, H, W, c, cm, c, False)
               for label, (H, W, c, cm, _, _) in chip_smoke.STAGE_SHAPES.items()]
    return blocks


BLOCKS = _path_blocks()
#: (label, B, H, W, K, N, taps, K2) of each convolution of each block
CONVS = [
    (f"{label}/{conv}_b{B}", B, H, W, K, N, taps, K2)
    for label, H, W, cin, cm, cout, proj in BLOCKS
    for B in (1, 4)
    for conv, K, N, taps, K2 in (("reduce", cin, cm, 1, 0), ("conv3x3", cm, cm, 9, 0),
                                 ("expand", cm, cout, 1, cin if proj else 0))
]

#: PResNet's convolutions, which the table recognizer's page route runs at
#: every batch of 1 to 64 tables
TSR_CONVS = [
    (f"{label}/{conv}", H, W, K, N, taps, K2)
    for label, H, W, cin, cm, cout, proj in BLOCKS if label.startswith("presnet")
    for conv, K, N, taps, K2 in (("reduce", cin, cm, 1, 0), ("conv3x3", cm, cm, 9, 0),
                                 ("expand", cm, cout, 1, cin if proj else 0))
]


def test_the_path_has_eleven_block_shapes():
    assert len(BLOCKS) == 11 and len(CONVS) == 66


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("what,B,H,W,K,N,taps,K2", CONVS, ids=[c[0] for c in CONVS])
def test_path_convolutions_take_a_built_route(what, B, H, W, K, N, taps, K2, sms):
    """Every convolution of the path, at batch 1 and 4, takes a TMA +
    wgmma route whose patch fits its unit, and splits only on the split
    route."""
    _takes_a_built_route(B, H, W, K, N, taps, K2, sms)


def _takes_a_built_route(B, H, W, K, N, taps, K2, sms):
    route, bw, bh, splits = _common.conv_plan(BF16, B, H, W, K, N, taps, K2, True, sms)
    assert route in WGMMA
    assert 1 <= bw * bh <= CONV_TILE_ROWS[route]
    assert (splits > 1) == (route == "wgmma_split")
    if taps == 1:
        assert (bw, bh) == (CONV_TILE_ROWS[route], 1)  # a 1x1's pixels as one line
    else:
        assert bw <= W and bh <= H


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("what,B,H,W,K,N,taps,K2", CONVS, ids=[c[0] for c in CONVS])
def test_small_grids_fill_the_card(what, B, H, W, K, N, taps, K2, sms):
    """128-pixel units where they fill three quarters of the card; else as
    many 64-pixel units (times K splits) as fit in one wave: the split
    route fills the card as far as one wave, ``_MAX_CONV_SPLITS`` and the
    K steps allow, and never takes fewer units than 128-pixel ones would."""
    _fills_the_card(B, H, W, K, N, taps, K2, sms)


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("what,H,W,K,N,taps,K2", TSR_CONVS, ids=[c[0] for c in TSR_CONVS])
def test_table_batches_take_a_built_route(what, H, W, K, N, taps, K2, sms):
    """PResNet's convolutions at every batch of 1 to 64 tables: a built
    route that fills the card as above."""
    for B in range(1, 65):
        _takes_a_built_route(B, H, W, K, N, taps, K2, sms)
        _fills_the_card(B, H, W, K, N, taps, K2, sms)


def _fills_the_card(B, H, W, K, N, taps, K2, sms):
    M, steps = B * H * W, conv_k_steps(K, taps, K2)
    route, splits = conv_route(BF16, M, N, steps, True, sms)
    u128, u64 = conv_units("wgmma", M, N), conv_units("wgmma_small", M, N)
    if route == "wgmma":
        assert 4 * u128 >= 3 * sms
        return
    assert 4 * u128 < 3 * sms
    taken = u64 * splits
    assert taken > u128 and taken <= max(sms, u64)
    if taken < sms:  # one more split would not fit the wave, or is not allowed
        assert (taken + u64 > sms or splits == _common._MAX_CONV_SPLITS
                or steps // (splits + 1) < _common._MIN_SPLIT_STEPS)


#: batch 1 on the H100 SXM: PResNet's late stages split their reduce and
#: 3x3 (stage2, stage3), stage1 and stage3's expand take 64-pixel units,
#: everything else 128-pixel ones (DBNet layer3's 116 and 120 units fill
#: 3/4 of the card)
@pytest.mark.parametrize("label,want", [
    ("dbnet_layer1_0", (("wgmma", 1), ("wgmma", 1), ("wgmma", 1))),
    ("dbnet_layer3", (("wgmma", 1), ("wgmma", 1), ("wgmma", 1))),
    ("presnet_stage1", (("wgmma_small", 1), ("wgmma_small", 1), ("wgmma", 1))),
    ("presnet_stage2", (("wgmma_split", 2), ("wgmma_split", 2), ("wgmma", 1))),
    ("presnet_stage3", (("wgmma_split", 4), ("wgmma_split", 4), ("wgmma_small", 1))),
])
def test_route_by_shape(label, want):
    _, H, W, cin, cm, cout, proj = next(b for b in BLOCKS if b[0] == label)
    plans = block_plans(BF16, 1, H, W, cin, cm, cout, proj, True, 132)[0]
    assert tuple((p[0], p[3]) for p in plans) == want


#: PResNet's late stages at the table recognizer's batches on the H100
#: SXM: 2 tables still split stage3's reduce and 3x3 and run stage2's on
#: 64-pixel units; from 8 tables every convolution takes 128-pixel units
@pytest.mark.parametrize("label,B,want", [
    ("presnet_stage2", 2, (("wgmma_small", 1), ("wgmma_small", 1), ("wgmma", 1))),
    ("presnet_stage3", 2, (("wgmma_split", 2), ("wgmma_split", 2), ("wgmma", 1))),
    ("presnet_stage3", 8, (("wgmma", 1), ("wgmma", 1), ("wgmma", 1))),
    ("presnet_stage3", 64, (("wgmma", 1), ("wgmma", 1), ("wgmma", 1))),
])
def test_route_by_shape_at_table_batches(label, B, want):
    _, H, W, cin, cm, cout, proj = next(b for b in BLOCKS if b[0] == label)
    plans = block_plans(BF16, B, H, W, cin, cm, cout, proj, True, 132)[0]
    assert tuple((p[0], p[3]) for p in plans) == want


@pytest.mark.parametrize("taps,H,W,route,want,padding", [
    (9, 400, 296, "wgmma", (8, 16), 0.0),       # DBNet layer1: no unit padded
    (9, 160, 160, "wgmma", (32, 4), 0.0),       # PResNet stage0
    (9, 100, 74, "wgmma", (25, 5), 1 - 7400 / (20 * 3 * 128)),
    (9, 20, 20, "wgmma_split", (20, 3), 1 - 400 / (7 * 64)),
    (1, 100, 74, "wgmma", (128, 1), 1 - 7400 / (58 * 128)),
])
def test_patch_and_padding(taps, H, W, route, want, padding):
    assert conv_patch(route, taps, H, W) == want
    assert conv_padding(route, taps, 1, H, W) == pytest.approx(padding)


@pytest.mark.parametrize("route", WGMMA)
@pytest.mark.parametrize("H,W", [(1, 1), (2, 3), (7, 300), (300, 7), (100, 74), (41, 41)])
def test_patch_covers_the_page_with_the_fewest_units(route, H, W):
    rows = CONV_TILE_ROWS[route]
    bw, bh = conv_patch(route, 9, H, W)
    units = -(-H // bh) * -(-W // bw)
    assert bw * bh <= rows and bw <= W and bh <= H
    for w in range(1, min(W, rows) + 1):
        h = min(rows // w, H)
        assert units <= -(-H // h) * -(-W // w)


@pytest.mark.parametrize("M,N", [(51200, 256), (400, 2048), (7, 8)])
def test_f32_takes_fma(M, N):
    assert conv_route(F32, M, N, 9, True, 132) == ("fma", 1)
    assert conv_route(F32, M, N, 9, False, 132) == ("fma", 1)
    assert _common.conv_plan(F32, 1, 20, 20, 64, 64, 9, 0, False, 132) == ("fma", 0, 0, 1)


@pytest.mark.parametrize("dtype,legal", [(BF16, False), (torch.float16, True),
                                         (torch.float16, False)])
def test_no_route_raises(dtype, legal):
    with pytest.raises(ValueError, match="no route"):
        conv_route(dtype, 7400, 256, 36, legal, 132)


def test_tma_illegal_channels_or_alignment():
    x = torch.zeros(1, 4, 4, 72, dtype=BF16)
    assert conv_legal([x, None], (64, 72, 256))
    assert not conv_legal([x], (64, 68, 256))  # a pixel row of 136 bytes
    off = torch.zeros(2000, dtype=BF16)[4:4 + 16 * 64].view(1, 4, 4, 64)  # 8 bytes off
    assert not conv_legal([off], (64,))
    with pytest.raises(ValueError, match="no route"):
        block_plans(BF16, 1, 4, 4, 64, 68, 256, True, conv_legal([x], (64, 68, 256)), 132)


def test_no_shape_maps_to_an_unbuilt_route():
    for M in (1, 63, 64, 400, 1600, 6400, 7400, 29600, 118400, 473600):
        for N in (8, 64, 72, 128, 256, 512, 1024, 2048):
            for steps in (1, 2, 8, 9, 36, 72, 144):
                for sms in SMS:
                    route, splits = conv_route(BF16, M, N, steps, True, sms)
                    assert route in WGMMA
                    assert 1 <= splits <= _common._MAX_CONV_SPLITS
                    assert (splits > 1) == (route == "wgmma_split")
                    assert splits == 1 or steps // splits >= _common._MIN_SPLIT_STEPS


def test_block_plans_c_array_and_workspace():
    """The C interface's plan is {route code, bw, bh, splits} per
    convolution, and the workspace holds the largest split's partials."""
    plans, arg, ws = block_plans(BF16, 1, 20, 20, 2048, 512, 2048, False, True, 132)
    assert list(arg) == [v for p in plans for v in (CONV_ROUTES[p[0]], p[1], p[2], p[3])]
    assert ws == max(p[3] * 400 * n for p, n in zip(plans, (512, 512, 2048)) if p[3] > 1)
    assert block_plans(BF16, 1, 400, 296, 64, 64, 256, True, True, 132)[2] == 0


def test_split_counts():
    assert conv_splits(400, 512, 72, 132) == 4      # 28 units of 64 pixels: 4 fit a wave
    assert conv_splits(400, 512, 4, 132) == 1       # too few K steps
    assert conv_splits(6400, 128, 18, 132) == 1     # 100 units: a second split overflows
    assert conv_splits(64, 64, 1000, 132) == _common._MAX_CONV_SPLITS


def test_reset_launches_clears_conv_routes():
    _common.conv_route_launches["wgmma_split"] += 3
    _common.reset_launches()
    assert not any(_common.conv_route_launches.values())


def _block(rng, B, H, W, Cin, Cm, Cout, proj):
    def t(*shape, std=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * std).astype(np.float32))

    args = [t(B, H, W, Cin), t(Cin, Cm, std=Cin ** -0.5), t(Cm, std=0.1),
            t(9, Cm, Cm, std=(9 * Cm) ** -0.5), t(Cm, std=0.1), t(Cm, Cout, std=Cm ** -0.5),
            t(Cout, std=0.1)]
    return args + ([t(Cin, Cout, std=Cin ** -0.5), t(Cout, std=0.1)] if proj else [None, None])


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_cpu_tensors_take_the_plain_version(dtype):
    """On CPU tensors the wrappers return the plain version's values and
    count nothing: no launch, no convolution route."""
    rng = np.random.default_rng(5)
    args = [None if a is None else a.to(dtype) for a in _block(rng, 2, 5, 7, 16, 8, 32, True)]
    ops.reset_launches()
    got = ops.fused_bottleneck(*args, dilation=2)
    assert torch.equal(got, ops.bottleneck_reference(*args, dilation=2))
    blocks = [[None if a is None else a.to(dtype) for a in _block(rng, 2, 5, 7, 32, 8, 32, False)]
              for _ in range(3)]
    stacks = [torch.stack([b[i] for b in blocks]) for i in range(1, 7)]
    got = ops.fused_identity_stage(blocks[0][0], *stacks, dilation=1)
    assert torch.equal(got, ops.fused_identity_stage_reference(blocks[0][0], *stacks))
    assert not any(ops.launches.values())
    assert not any(_common.conv_route_launches.values())


def test_conv_reference_composes_the_block():
    """bottleneck_reference is conv_reference three times: reduce, the 3x3
    over zero-padded h1, expand with the projection's second K segment."""
    rng = np.random.default_rng(6)
    x, w1, b1, w2, b2, w3, b3, wd, bd = _block(rng, 1, 6, 5, 16, 8, 24, True)
    h1 = torch.relu(x @ w1 + b1)
    h2 = ops.conv_reference(h1, w2, b2, dilation=2)
    pad = torch.nn.functional.pad(h1.permute(0, 3, 1, 2), (2, 2, 2, 2))
    w_oihw = w2.reshape(3, 3, 8, 8).permute(3, 2, 0, 1)
    want = torch.relu(torch.nn.functional.conv2d(pad, w_oihw, b2, dilation=2)).permute(0, 2, 3, 1)
    torch.testing.assert_close(h2, want, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(
        ops.bottleneck_reference(x, w1, b1, w2, b2, w3, b3, wd, bd, dilation=2),
        torch.relu(h2 @ w3 + b3 + x @ wd + bd), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("module", [bottleneck, stage, deformable_attention])
def test_wrappers_launch_through_launch(module):
    """The bottleneck, stage and deformable wrappers call their C entry
    through ``_launch`` (no device guard or stream object per call)."""
    source = inspect.getsource(module)
    assert "torch.cuda.device(" not in source
    assert "current_stream" not in source
    assert "_launch(" in source
