"""The int8 GEMM kernel's route choice (``ops._common.gemm_int8_route``)
and operand legality, pinned on the CPU: both are plain Python, so which
schedule each int8 GEMM of the W8A8 sublayers reaches is checked here; the
kernel itself runs only on the card (tests/test_torch_cuda.py,
chip_smoke.py)."""

import pytest
import torch

from yomitoku_tpu_torch.ops import _common
from yomitoku_tpu_torch.ops._common import (
    GEMM_INT8_ROUTES,
    GEMM_INT8_TILES,
    gemm_int8_route,
    gemm_units,
)
from yomitoku_tpu_torch.ops.mlp import hidden_chunk

SMS = (132, 114)  # H100 SXM and PCIe
D, HIDDEN = 768, 3072
NC2 = HIDDEN // hidden_chunk(HIDDEN)  # fc2's K-chunks: 3 of 1024

#: (what, M, K-chunks, N, GELU) of every int8 GEMM of the W8A8 sublayers
#: at 400 tokens per line and batch buckets 1, 8, 32 and 128: the QKV and
#: out-projection of fused_attention_block_ln_int8, fc1 and fc2 of
#: fused_mlp_ln_int8
INT8_PATH = [
    (f"{what}_b{b}", 400 * b, nc, n, gelu)
    for b in (1, 8, 32, 128)
    for what, nc, n, gelu in (("qkv", 1, 3 * D, False), ("out", 1, D, False),
                              ("fc1", 1, HIDDEN, True), ("fc2", NC2, D, False))
] + [  # the 400-wide width bucket: 200 tokens per line
    (f"{what}_w400_b{b}", 200 * b, nc, n, gelu)
    for b in (1, 8, 32, 128)
    for what, nc, n, gelu in (("qkv", 1, 3 * D, False), ("out", 1, D, False),
                              ("fc1", 1, HIDDEN, True), ("fc2", NC2, D, False))
]


@pytest.mark.parametrize("what,M,N,nc,gelu,want", [
    ("qkv", 51200, 3 * D, 1, False, "wgmma"),
    ("out", 51200, D, 1, False, "wgmma"),
    ("fc1", 51200, HIDDEN, 1, True, "wgmma_coop"),   # the GELU epilogue
    ("fc2", 51200, D, NC2, False, "wgmma_coop"),     # K in three chunks: the f32 fold
    ("out_b8", 3200, D, 1, False, "wgmma"),          # 150 units of 128 x 128
    ("qkv_b1", 400, 3 * D, 1, False, "wgmma_m64"),   # 72 of them
    ("out_b1", 400, D, 1, False, "wgmma_m64"),       # 24
    ("fc1_b1", 400, HIDDEN, 1, True, "wgmma_m64"),
    ("fc2_b1", 400, D, NC2, False, "wgmma_m64"),
    ("fc1_w400", 25600, HIDDEN, 1, True, "wgmma_coop"),
    ("fc2_w400", 25600, D, NC2, False, "wgmma_coop"),
    ("out_w400_b8", 1600, D, 1, False, "wgmma_m64"),  # 78 units of 128 x 128
])
def test_route_by_shape(what, M, N, nc, gelu, want):
    assert gemm_int8_route(M, N, nc, gelu, True, 132) == want, what


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("what,M,nc,N,gelu", INT8_PATH, ids=[c[0] for c in INT8_PATH])
def test_path_shapes_fill_the_card_where_they_can(what, M, nc, N, gelu, sms):
    """Every int8 GEMM of the path takes a route: 128-row units where they
    fill the card (taken in turns, or shared for a chunked K or a GELU
    epilogue), else 64-row ones, which hold more units."""
    route = gemm_int8_route(M, N, nc, gelu, True, sms)
    assert route in GEMM_INT8_ROUTES
    wide = gemm_units("wgmma", M, N, GEMM_INT8_TILES)
    if wide >= sms:
        assert route == ("wgmma_coop" if nc > 1 or gelu else "wgmma")
        assert gemm_units(route, M, N, GEMM_INT8_TILES) == wide
    else:
        assert route == "wgmma_m64"
        assert gemm_units(route, M, N, GEMM_INT8_TILES) > wide


def test_no_shape_maps_to_an_unbuilt_route():
    for M in (1, 7, 64, 201, 333, 400, 808, 3200, 12800, 51200):
        for N in (8, 136, 768, 2304, 3072):
            for nc in (1, 2, 3):
                for gelu in (False, True):
                    for sms in SMS:
                        route = gemm_int8_route(M, N, nc, gelu, True, sms)
                        assert route in GEMM_INT8_ROUTES and route in GEMM_INT8_TILES
                        assert nc == 1 or route != "wgmma"  # "wgmma" holds no f32 fold


@pytest.mark.parametrize("M,N,nc", [(51200, D, 1), (400, 256, 3), (3, 8, 1)])
def test_illegal_operands_raise(M, N, nc):
    with pytest.raises(ValueError, match="no route"):
        gemm_int8_route(M, N, nc, False, False, 132)


def _rows(rows, cols, dtype, offset=0, pad=0):
    """A (rows, cols) view into a buffer of rows of cols + pad + offset,
    ``offset`` elements into each row."""
    return torch.zeros(rows, cols + pad + offset, dtype=dtype)[:, offset:offset + cols]


def _operands(K=512, N=136, M=40, out_dtype=torch.bfloat16, a_off=0, a_pad=0, w_pad=0,
              out_pad=0, out_off=0, res=False, res_pad=0, sw_off=0, bias_off=0, kchunk=None):
    a = _rows(M, K, torch.int8, a_off, a_pad)
    w = torch.zeros(N, K + w_pad, dtype=torch.int8)[:, :K].t()  # (N, K) rows, as .t()
    out = _rows(M, N, out_dtype, out_off, out_pad)
    r = _rows(M, N, out_dtype, 0, res_pad) if res else None
    sw = torch.zeros(N + 4)[sw_off:sw_off + N]
    bias = torch.zeros(N + 4)[bias_off:bias_off + N]
    return a, w, out, sw, bias, r, kchunk or K


@pytest.mark.parametrize("what,args,ok", [
    ("contiguous", dict(), True),
    ("contiguous_f32_out", dict(out_dtype=torch.float32), True),
    ("a_row_pitch_16b", dict(a_pad=16), True),
    ("a_row_pitch_8b_off", dict(a_pad=8), False),
    ("a_base_8b_off", dict(a_off=8), False),
    ("w_row_pitch_16b", dict(w_pad=16), True),
    ("w_row_pitch_8b_off", dict(w_pad=8), False),
    ("out_bf16_pitch_16b", dict(out_pad=8), True),
    ("out_bf16_pitch_8b_off", dict(out_pad=4), False),
    ("out_f32_pitch_16b", dict(out_dtype=torch.float32, out_pad=4), True),
    ("out_f32_pitch_8b_off", dict(out_dtype=torch.float32, out_pad=2), False),
    ("out_base_8b_off", dict(out_off=4), False),
    ("res", dict(res=True), True),
    ("res_pitch_8b_off", dict(res=True, res_pad=4), False),
    ("sw_base_4b_off", dict(sw_off=1), False),
    ("bias_base_8b_off", dict(bias_off=2), False),
    ("k_not_mult_16", dict(K=200), False),
    ("k_192_one_chunk", dict(K=192), True),
    ("n_not_mult_8", dict(N=100), False),
    ("chunks_of_256", dict(K=768, kchunk=256), True),
    ("chunks_of_192", dict(K=384, kchunk=192), False),
    ("chunks_not_dividing", dict(K=768, kchunk=512), False),
])
def test_tma_legality(what, args, ok):
    a, w, out, sw, bias, res, kchunk = _operands(**args)
    assert _common._gemm_int8_legal(a, w, out, sw, bias, res, kchunk) == ok, what


def test_bias_may_be_absent():
    a, w, out, sw, _, _, kchunk = _operands()
    assert _common._gemm_int8_legal(a, w, out, sw, None, None, kchunk)


def test_wrapper_needs_cuda_tensors():
    """The wrapper launches the kernel or raises: CPU tensors raise (the
    sublayers' plain versions are taken above it, in ops/mlp.py and
    ops/attention.py)."""
    a, w, out, sw, bias, _, _ = _operands()
    sa = torch.ones((a.shape[0], 1))
    with pytest.raises(ValueError, match="CUDA"):
        _common.gemm_int8(a, sa, w, sw, bias, out)


def test_reset_launches_clears_int8_routes():
    _common.gemm_int8_route_launches["wgmma_m64"] += 3
    _common.reset_launches()
    assert not any(_common.gemm_int8_route_launches.values())
