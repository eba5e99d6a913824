"""The GEMM kernel's route choice (``ops._common.gemm_route``), pinned on
the CPU: the route is plain Python, so which schedule each main-path shape
reaches is checked here; the kernel itself runs only on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""

import pytest
import torch

from yomitoku_tpu_torch.ops import _common
from yomitoku_tpu_torch.ops._common import (
    GEMM_ROUTES,
    GEMM_TILES,
    gemm_route,
    gemm_units,
)

BF16, F32 = torch.bfloat16, torch.float32
SMS = (132, 114)  # H100 SXM and PCIe
WGMMA = {r for r in GEMM_ROUTES if r.startswith("wgmma")}
D, HIDDEN = 768, 3072

#: (what, M, K, N) of every bf16 GEMM on the recognizer's path: the ViT's
#: four per encoder block at 400 tokens per line (fc1 / fc2 only from 1,024
#: rows, where the sublayer is fused) and the refine MLP at 101 rows per
#: line, at batch buckets 1, 8, 32 and 128; fused_attention_block at
#: RT-DETR's (1, 400, 256)
MAIN_PATH = [
    (f"{what}_b{b}", rows * b, k, n)
    for b in (1, 8, 32, 128)
    for what, rows, k, n in (("qkv", 400, D, 3 * D), ("out", 400, D, D),
                             ("fc1", 400, D, HIDDEN), ("fc2", 400, HIDDEN, D),
                             ("refine_fc1", 101, D, HIDDEN), ("refine_fc2", 101, HIDDEN, D))
    if not (what.endswith(("fc1", "fc2")) and rows * b < 1024)
] + [("block_qkv", 400, 256, 768), ("block_out", 400, 256, 256)]
#: the recognizer's 400-wide width bucket: the ViT's GEMMs at 200 tokens
#: per line, M = B x 200, at the batch buckets (fc1 / fc2 from 1,024 rows)
NARROW = [
    (f"{what}_w400_b{b}", 200 * b, k, n)
    for b in (1, 8, 32, 128)
    for what, k, n in (("qkv", D, 3 * D), ("out", D, D), ("fc1", D, HIDDEN), ("fc2", HIDDEN, D))
    if not (what.startswith("fc") and 200 * b < 1024)
]


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("what,M,K,N", MAIN_PATH + NARROW, ids=[c[0] for c in MAIN_PATH + NARROW])
def test_main_path_shapes_take_wgmma(what, M, K, N, sms):
    """Both weight layouts pass the same legality test, so the route does
    not depend on the layout: every main-path shape takes a wgmma route."""
    assert gemm_route(BF16, M, N, True, sms) in WGMMA


@pytest.mark.parametrize("what,M,N,want", [
    ("vit_qkv", 51200, 3 * D, "wgmma"),
    ("vit_out", 51200, D, "wgmma"),
    ("vit_fc1", 51200, HIDDEN, "wgmma"),
    ("vit_fc2", 51200, D, "wgmma"),
    ("refine_fc1", 12928, HIDDEN, "wgmma"),
    ("refine_fc2", 12928, D, "wgmma"),
    ("vit_out_b8", 3200, D, "wgmma"),         # 150 units of 128 x 128
    ("vit_qkv_b1", 400, 3 * D, "wgmma_small"),  # 72 of them
    ("block_out", 400, 256, "wgmma_small"),
    ("vit_qkv_w400", 25600, 3 * D, "wgmma"),
    ("vit_out_w400_b8", 1600, D, "wgmma_small"),  # 78 units of 128 x 128
    ("vit_qkv_w400_b1", 200, 3 * D, "wgmma_small"),
])
def test_route_by_shape(what, M, N, want):
    assert gemm_route(BF16, M, N, True, 132) == want, what


@pytest.mark.parametrize("M,N", [(51200, D), (400, 256), (3, 8)])
def test_f32_takes_fma(M, N):
    assert gemm_route(F32, M, N, True, 132) == "fma"
    assert gemm_route(F32, M, N, False, 132) == "fma"


@pytest.mark.parametrize("dtype,legal", [(BF16, False), (torch.float16, True),
                                         (torch.float16, False)])
def test_no_route_raises(dtype, legal):
    with pytest.raises(ValueError, match="no route"):
        gemm_route(dtype, 51200, D, legal, 132)


@pytest.mark.parametrize("dtype", [BF16, F32])
def test_no_shape_maps_to_an_unbuilt_route(dtype):
    for M in (1, 7, 64, 101, 400, 808, 1000, 3232, 12928, 51200):
        for N in (8, 96, 256, 768, 2304, 3072):
            for sms in SMS:
                route = gemm_route(dtype, M, N, True, sms)
                assert route in GEMM_ROUTES
                assert route == "fma" or route in GEMM_TILES


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("what,M,K,N", MAIN_PATH, ids=[c[0] for c in MAIN_PATH])
def test_small_grids_fill_the_card(what, M, K, N, sms):
    """Where 128 x 128 units would leave SMs idle, the route takes the one
    with more units: "wgmma_small" fills the card wherever its 64 x 128
    units can (everything but batch 1 and fused_attention_block, whose
    outputs hold fewer units than SMs)."""
    route = gemm_route(BF16, M, N, True, sms)
    units = gemm_units(route, M, N)
    if gemm_units("wgmma", M, N) < sms:
        assert route == "wgmma_small"
        assert units > gemm_units("wgmma", M, N)
    assert units >= sms or (M <= 400 and units == gemm_units("wgmma_small", M, N))


def _view(rows, cols, offset=0, pad=0, dtype=BF16):
    """A (rows, cols) view into a buffer of rows of cols + pad + offset,
    ``offset`` elements into each row."""
    return torch.zeros(rows, cols + pad + offset, dtype=dtype)[:, offset:offset + cols]


def _linear_weight_t(K, N, pad=0):
    """A torch Linear weight (N, K) row-major, row pitch K + pad, as .t()."""
    return torch.zeros(N, K + pad, dtype=BF16)[:, :K].t()


@pytest.mark.parametrize("what,args,ok", [
    ("contiguous", dict(), True),
    ("a_row_pitch_16b", dict(a_pad=8), True),
    ("a_base_8b_off", dict(a_off=4), False),
    ("a_row_pitch_8b_off", dict(a_pad=4), False),
    ("out_packed_slice", dict(out_pad=16), True),
    ("out_base_8b_off", dict(out_off=4), False),
    ("k_not_mult_8", dict(K=196), False),
    ("n_not_mult_8", dict(N=100), False),
    ("w_kn_pitch_8b_off", dict(w_pad=4), False),
    ("w_nk_pitch_16b", dict(w_nk=True, w_pad=8), True),
    ("w_nk_pitch_8b_off", dict(w_nk=True, w_pad=4), False),
])
def test_tma_legality(what, args, ok):
    K, N, M = args.get("K", 200), args.get("N", 96), 40
    a = _view(M, K, args.get("a_off", 0), args.get("a_pad", 0))
    out = _view(M, N, args.get("out_off", 0), args.get("out_pad", 0))
    if args.get("w_nk"):
        w = _linear_weight_t(K, N, args.get("w_pad", 0))
    else:
        w = _view(K, N, 0, args.get("w_pad", 0))
    ldw = _common._weight_layout(w, K, N)[1]
    assert _common._gemm_legal(a, w, ldw, out, bias=torch.zeros(N, dtype=BF16)) == ok, what


def test_residual_and_layernorm_vectors_count():
    a, w, out = _view(40, 64), _view(64, 64), _view(40, 64)
    assert _common._gemm_legal(a, w, 64, out, res=_view(40, 64))
    assert not _common._gemm_legal(a, w, 64, out, res=_view(40, 64, 4))
    vec = torch.zeros(72, dtype=BF16)
    assert _common._gemm_legal(a, w, 64, out, ln=(vec[:64], vec[:64], 1e-6))
    assert not _common._gemm_legal(a, w, 64, out, ln=(vec[4:68], vec[:64], 1e-6))


def test_weight_layouts():
    K, N = 64, 96
    assert _common._weight_layout(torch.zeros(K, N), K, N) == (0, N)
    assert _common._weight_layout(torch.zeros(N, K).t(), K, N) == (1, K)
    with pytest.raises(ValueError, match="strides"):
        _common._weight_layout(torch.zeros(K, 2 * N)[:, ::2], K, N)
    with pytest.raises(ValueError, match="expected"):
        _common._weight_layout(torch.zeros(K, N), K + 1, N)


def test_reset_launches_clears_gemm_routes():
    _common.gemm_route_launches["wgmma"] += 3
    _common.reset_launches()
    assert not any(_common.gemm_route_launches.values())
