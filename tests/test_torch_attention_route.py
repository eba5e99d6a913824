"""The attention kernel's route choice (``ops._common.attention_route``),
pinned on the CPU: the route is plain Python, so which kernel each
main-path shape reaches is checked here; the kernels themselves run only
on the card (tests/test_torch_cuda.py, chip_smoke.py)."""

import math

import pytest
import torch

from yomitoku_tpu_torch.ops import _common
from yomitoku_tpu_torch.ops._common import (
    ATTENTION_ROUTES,
    WGMMA_HEAD_DIMS,
    attention_route,
)

BF16, F32 = torch.bfloat16, torch.float32
H100_SMS = 132  # H100 SXM; the PCIe card has 114


@pytest.mark.parametrize("what,args,want", [
    # the ViT's 12 fused_attention_block_ln calls per batch of 128 lines
    ("vit", (BF16, BF16, 128, 8, 400, 96), ("wgmma", 1)),
    # the int8 sublayer's attention, f32 output
    ("vit_int8", (BF16, F32, 128, 8, 400, 96), ("wgmma", 1)),
    # fused_attention at the ViT's shape: (B*H, L, Dh) views, one head
    ("fused_attention", (BF16, BF16, 1024, 1, 400, 96), ("wgmma", 1)),
    # the PARSeq refine over the 400-token memory, and its bucket-8 batch
    ("refine", (BF16, BF16, 128, 8, 101, 96), ("wgmma", 1)),
    ("refine_b8", (BF16, BF16, 8, 8, 101, 96), ("wgmma_small", 2)),
    # RT-DETR AIFI and decoder self-attention, page and 4-table batch
    ("aifi", (BF16, BF16, 1, 8, 400, 32), ("wgmma_small", 3)),
    ("decoder", (BF16, BF16, 1, 8, 300, 32), ("wgmma_small", 4)),
    ("aifi_b4", (BF16, BF16, 4, 8, 400, 32), ("wgmma_small", 1)),
    ("decoder_b4", (BF16, BF16, 4, 8, 300, 32), ("wgmma_small", 1)),
])
def test_main_path_shapes_take_wgmma(what, args, want):
    assert attention_route(*args, True, H100_SMS) == want, what


#: the recognizer's 400-wide width bucket: the ViT at 200 tokens per line
#: (bf16 out, and f32 out for the int8 sublayer) and the refine's 101
#: queries over 200 memory keys (the route reads Lq; the kernel cuts the 200
#: keys into three 80-key tiles, one split at most each)
PAGE_ROUTE = [
    (f"{what}_b{b}", (BF16, out, b, 8, lq, 96))
    for b in (1, 8, 32, 128)
    for what, out, lq in (("vit200", BF16, 200), ("vit200_int8", F32, 200),
                          ("refine_lk200", BF16, 101))
]


def _takes_wgmma(args, sms):
    """A wgmma route: "wgmma" unsplit where its 128-row blocks fill the
    card, else "wgmma_small" with 1-4 key splits, whose 64-row blocks times
    splits fill it."""
    route, splits = attention_route(*args, True, sms)
    _, _, B, H, Lq, _ = args
    if route == "wgmma":
        assert splits == 1 and math.ceil(Lq / 128) * H * B >= sms
    else:
        assert route == "wgmma_small" and 1 <= splits <= _common._MAX_SPLITS
        assert math.ceil(Lq / 128) * H * B < sms
        assert math.ceil(Lq / 64) * H * B * splits >= min(sms, 4 * math.ceil(Lq / 64) * H * B)


@pytest.mark.parametrize("sms", [114, H100_SMS])
@pytest.mark.parametrize("what,args", PAGE_ROUTE, ids=[c[0] for c in PAGE_ROUTE])
def test_page_route_shapes_take_wgmma(what, args, sms):
    _takes_wgmma(args, sms)


@pytest.mark.parametrize("sms", [114, H100_SMS])
@pytest.mark.parametrize("what,lq", [("aifi", 400), ("decoder", 300)])
def test_table_batches_take_wgmma(what, lq, sms):
    """RT-DETR's AIFI and decoder self-attention at every batch of 1 to 64
    tables, as the table recognizer's page route runs them."""
    for b in range(1, 65):
        _takes_wgmma((BF16, BF16, b, 8, lq, 32), sms)


@pytest.mark.parametrize("what,args,want", [
    ("aifi_b2", (BF16, BF16, 2, 8, 400, 32), ("wgmma_small", 2)),
    ("aifi_b8", (BF16, BF16, 8, 8, 400, 32), ("wgmma", 1)),
    ("decoder_b64", (BF16, BF16, 64, 8, 300, 32), ("wgmma", 1)),
    ("vit200_b1", (BF16, BF16, 1, 8, 200, 96), ("wgmma_small", 4)),
    ("vit200_b128", (BF16, BF16, 128, 8, 200, 96), ("wgmma", 1)),
    ("refine_lk200_b8", (BF16, BF16, 8, 8, 101, 96), ("wgmma_small", 2)),
])
def test_page_route_shape_routes(what, args, want):
    assert attention_route(*args, True, H100_SMS) == want, what


@pytest.mark.parametrize("args", [
    (F32, F32, 128, 8, 400, 96),     # f32: the parity checks' full products
    (F32, F32, 1, 8, 300, 32),
    (BF16, BF16, 2, 4, 37, 24),      # Dh % 16 != 0
    (BF16, F32, 3, 4, 37, 24),
    (BF16, BF16, 2, 4, 37, 48),      # a multiple of 16 not instantiated
    (BF16, BF16, 1, 1, 10, 256),
    (BF16, torch.float16, 128, 8, 400, 96),
])
def test_other_inputs_take_fma(args):
    assert attention_route(*args, True, H100_SMS) == ("fma", 1)


def test_misaligned_strides_take_fma():
    assert attention_route(BF16, BF16, 128, 8, 400, 96, False, H100_SMS) == ("fma", 1)


def _legal(batch, *tensors):
    return _common._tma_legal(batch, [t.data_ptr() for t in tensors],
                              [t.stride() for t in tensors])


def _view(shape, offset=0, pad=0, dtype=BF16):
    """A (B, L, D) view into a larger buffer: ``offset`` elements into each
    row of width D + pad."""
    B, L, D = shape
    return torch.zeros(B, L, D + pad + offset, dtype=dtype)[..., offset:offset + D]


@pytest.mark.parametrize("offset,pad,batch,ok", [
    (0, 0, 2, True),     # contiguous
    (0, 8, 2, True),     # rows of 2 D + 8: a packed-slice-like stride
    (4, 0, 2, False),    # base 8 bytes past a 16-byte boundary
    (8, 0, 2, True),     # base 16 bytes in
    (0, 4, 2, False),    # row stride of D + 4 elements (8 bytes off)
])
def test_tma_legality_of_strides(offset, pad, batch, ok):
    t = _view((batch, 5, 64), offset, pad)
    assert _legal(batch, t, t, t, t) == ok


def test_packed_qkv_slices_are_tma_legal():
    """The ViT's Q, K and V: column slices of one (B, L, 3D) buffer."""
    qkv = torch.zeros(2, 7, 3 * 768, dtype=BF16)
    q, k, v = qkv[..., :768], qkv[..., 768:1536], qkv[..., 1536:]
    out = torch.zeros(2, 7, 768, dtype=F32)
    assert _legal(2, q, k, v, out)
    legal = _legal(2, q, k, v, out)
    assert attention_route(BF16, F32, 128, 8, 400, 96, legal, H100_SMS) == ("wgmma", 1)


def test_batch_stride_counts_only_above_batch_one():
    buf = torch.zeros(4096, dtype=BF16)
    one = torch.as_strided(buf, (1, 5, 64), (3, 64, 1))  # batch stride 3: unused
    two = torch.as_strided(buf, (2, 5, 64), (3, 64, 1))
    bcast = torch.as_strided(buf, (2, 5, 64), (0, 64, 1))  # an expanded batch
    assert _legal(1, one)
    assert not _legal(2, two) and not _legal(2, bcast)


def test_wgmma_head_dims():
    """The head dims the kernel is instantiated for (a dim outside them
    makes the C entry refuse the route, on the card)."""
    assert WGMMA_HEAD_DIMS == (16, 32, 64, 96, 128)
    assert set(ATTENTION_ROUTES) == {"fma", "wgmma", "wgmma_small"}


@pytest.mark.parametrize("sms", [114, H100_SMS])
@pytest.mark.parametrize("dtype,out", [(BF16, BF16), (BF16, F32), (F32, F32)])
def test_no_shape_maps_to_an_unbuilt_route(dtype, out, sms):
    """Over a grid of shapes: a wgmma route only for bf16 inputs and an
    instantiated head dim; "wgmma" unsplit; "wgmma_small" with 1-4 splits
    and only where the 128-row grid is under one wave."""
    for dh in range(1, 129):
        for B in (1, 2, 4, 8, 33, 128):
            for H in (1, 8):
                for Lq in (1, 17, 64, 101, 300, 400, 1000):
                    route, splits = attention_route(dtype, out, B, H, Lq, dh, True, sms)
                    if route == "fma":
                        assert splits == 1
                        continue
                    assert dtype == BF16 and dh in WGMMA_HEAD_DIMS
                    if route == "wgmma":
                        assert splits == 1
                        continue
                    assert math.ceil(Lq / 128) * H * B < sms
                    assert 1 <= splits <= _common._MAX_SPLITS


@pytest.mark.parametrize("sms", [114, H100_SMS])
@pytest.mark.parametrize("B,H,Lq", [(1, 8, 400), (1, 8, 300), (4, 8, 400), (4, 8, 300),
                                    (8, 8, 101)])
def test_small_grids_fill_the_card(B, H, Lq, sms):
    """RT-DETR's batch-1 and 4-table shapes and the refine's bucket-8 batch
    give at least one block per SM: of 128 rows ("wgmma"), else of 64 rows
    times the splits (all kept at L >= 300 with 80-key tiles)."""
    route, splits = attention_route(BF16, BF16, B, H, Lq, 32, True, sms)
    rows = 128 if route == "wgmma" else 64
    assert route != "fma" and math.ceil(Lq / rows) * H * B * splits >= sms


@pytest.mark.parametrize("sms,want", [(H100_SMS, ("wgmma_small", 1)), (96, ("wgmma", 1))])
def test_attention_routes_by_the_sm_count_of_its_card(monkeypatch, sms, want):
    """``attention`` sizes the route for the SMs of q's card: the 4-table
    AIFI shape fills 96 SMs with 128-row blocks, not 132."""
    calls = []
    monkeypatch.setattr(_common, "_sm_count", lambda index: sms)
    monkeypatch.setattr(_common, "launch_attention", lambda *a: calls.append(a[:2]))
    monkeypatch.setattr(_common, "attention_route_launches", dict.fromkeys(ATTENTION_ROUTES, 0))
    q = torch.zeros(4, 400, 256, dtype=BF16)
    _common.attention(q, q, q, torch.empty_like(q), 8, 32 ** -0.5)
    assert calls == [want]
    assert _common.attention_route_launches[want[0]] == 1


def test_cpu_wrappers_count_no_route():
    """A CPU call runs the plain version: no launch and no route counted."""
    from yomitoku_tpu_torch import ops

    before = dict(_common.attention_route_launches)
    x = torch.zeros(1, 5, 64)
    ops.fused_attention_heads(x, x, x, 2)
    ops.fused_attention(x[None], x[None], x[None])
    assert _common.attention_route_launches == before


def test_reset_launches_clears_route_counts():
    _common.attention_route_launches["wgmma"] += 3
    _common.reset_launches()
    assert set(_common.attention_route_launches.values()) == {0}
