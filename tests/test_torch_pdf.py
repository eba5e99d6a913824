"""The port's PDF engine against the JAX package's, bit for bit: ``load_pdf``
on the demo PDFs at 72 and 200 dpi (length, iteration, slices, negative
indices, error types), the host C++ entry points (``fill_edges``,
``ccitt_decode``, ``jbig2_decode``) on the inputs the JAX tests build, and
the synthetic PDFs of those tests (CCITT, image masks, JBIG2, JPX,
shadings, tiling patterns, Type1 / Type3 / substituted fonts, corrupt
files) rendered through both packages."""

import io
import sys
from pathlib import Path

import numpy as np
import pytest

from jbig2_ref import (
    generic_region_segment,
    halftone_region_segment,
    huff_symbol_dict_segment,
    huff_text_region_segment,
    page_info_segment,
    pattern_dict_segment,
    segment_header,
    symbol_dict_segment,
    text_region_segment,
)
from test_jbig2 import _blob_bitmap, _glyphs, _halftone_patterns
from test_pdf_fonts_fallback import (
    _build_pdf_generic,
    _build_type1_program,
    _page_objs,
    _stream,
)
from test_pdf_render import (
    _build_pdf,
    _build_shading_pdf,
    _contour_edges,
    _fax_test_image,
    _tiff_ccitt_strips,
)
from yomitoku_tpu import native as jax_native
from yomitoku_tpu.data import load_pdf as jax_load_pdf
from yomitoku_tpu_torch import native as port_native
from yomitoku_tpu_torch.data import load_pdf as port_load_pdf
from yomitoku_tpu_torch.data import PdfPageIterator

ROOT = Path(__file__).resolve().parents[1]
DEMO = {"sample": ROOT / "demo" / "sample.pdf",
        "scan": ROOT / "demo" / "sample_scan.pdf"}


@pytest.fixture(autouse=True)
def builtin_pdf_backend(monkeypatch):
    """Both packages on the built-in renderer: a ``pypdfium2`` module
    without ``PdfDocument`` (a stub that a test of another file left in
    ``sys.modules`` on this worker) is taken away, and each package
    probes its backend again."""
    import yomitoku_tpu.data.pdf as jax_pdf
    import yomitoku_tpu_torch.data.pdf as port_pdf

    stub = sys.modules.get("pypdfium2")
    if stub is not None and not hasattr(stub, "PdfDocument"):
        monkeypatch.delitem(sys.modules, "pypdfium2")
    monkeypatch.setattr(jax_pdf, "_BACKEND", None)
    monkeypatch.setattr(port_pdf, "_BACKEND", None)


def _same_pages(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.uint8 and g.shape == w.shape
        assert np.array_equal(g, w)


# ------------------------------------------------------------ demo PDFs

@pytest.mark.parametrize("dpi", [72, 200])
@pytest.mark.parametrize("name", ["sample", "scan"])
def test_load_pdf_matches_jax(name, dpi):
    want = list(jax_load_pdf(DEMO[name], dpi=dpi))
    port = port_load_pdf(DEMO[name], dpi=dpi)
    assert isinstance(port, PdfPageIterator)
    assert len(port) == len(want) == {"sample": 2, "scan": 1}[name]
    pages = list(port)
    _same_pages(pages, want)
    assert pages[0].shape == {72: (1280, 960, 3), 200: (3556, 2667, 3)}[dpi]
    _same_pages(port[0:len(want)], want)
    _same_pages(port[-1:], want[-1:])
    assert np.array_equal(port[-1], want[-1])
    assert np.array_equal(port[len(want) - 1], want[-1])
    # the demo pages carry ink
    assert (pages[0].mean(axis=2) < 128).sum() > 1000


@pytest.mark.parametrize("case", ["missing", "png", "index", "type", "corrupt"])
def test_load_pdf_errors_match_jax(tmp_path, case):
    bad = tmp_path / "bad.pdf"
    bad.write_bytes(b"not a pdf at all" * 10)
    calls = {
        "missing": lambda load: load(tmp_path / "none.pdf"),
        "png": lambda load: load(ROOT / "demo" / "sample_table.png"),
        "index": lambda load: load(DEMO["scan"], dpi=72)[1],
        "type": lambda load: load(DEMO["scan"], dpi=72)["0"],
        "corrupt": lambda load: load(bad),
    }[case]
    errors = []
    for load in (jax_load_pdf, port_load_pdf):
        with pytest.raises(Exception) as info:
            calls(load)
        errors.append(info.value)
    assert type(errors[0]) is type(errors[1])
    assert str(errors[0]) == str(errors[1])
    assert isinstance(errors[1], {"missing": FileNotFoundError, "png": ValueError,
                                  "index": IndexError, "type": TypeError,
                                  "corrupt": ValueError}[case])


# ------------------------------------------------------------ fill_edges

def _star(n=7, r0=3.0, r1=9.0, cx=10.3, cy=9.7):
    a = np.arange(2 * n) * np.pi / n
    r = np.where(np.arange(2 * n) % 2, r0, r1)
    return np.stack([cx + r * np.cos(a), cy + r * np.sin(a)], 1)


_EDGES = {
    "rect": (_contour_edges([[2, 2], [8, 2], [8, 6], [2, 6]]), 10, 10),
    "half_pixel": (_contour_edges([[2.5, 2.5], [7.5, 2.5], [7.5, 5.5], [2.5, 5.5]]),
                   10, 10),
    "overlap": (np.concatenate([_contour_edges([[1, 1], [6, 1], [6, 6], [1, 6]]),
                                _contour_edges([[4, 4], [9, 4], [9, 9], [4, 9]])]),
                10, 10),
    "ring": (np.concatenate([_contour_edges([[1, 1], [9, 1], [9, 9], [1, 9]]),
                             _contour_edges([[3, 3], [3, 7], [7, 7], [7, 3]])]), 10, 10),
    "star": (_contour_edges(_star()), 21, 20),
    "off_canvas": (_contour_edges([[-5, -3], [30, 2], [12, 40]]), 16, 12),
    "empty": (np.zeros((0, 4), np.float32), 8, 8),
}


@pytest.mark.parametrize("rule", ["nonzero", "evenodd"])
@pytest.mark.parametrize("case", sorted(_EDGES))
def test_fill_edges_matches_jax(case, rule):
    edges, w, h = _EDGES[case]
    got = port_native.fill_edges(edges, w, h, rule)
    want = jax_native.fill_edges(edges, w, h, rule)
    assert got.dtype == np.uint8 and got.shape == (h, w)
    assert np.array_equal(got, want)
    if case == "rect":
        assert got[3, 4] == 255 and got[0, 0] == 0


# ------------------------------------------------------------ CCITT

def _ccitt_case(case):
    black = _fax_test_image()
    h, w = black.shape
    if case == "group4":
        return _tiff_ccitt_strips(black, "group4"), w, h, -1
    if case == "group3":
        return _tiff_ccitt_strips(black, "group3"), w, h, 0
    if case == "truncated":
        data = _tiff_ccitt_strips(black, "group4")
        return data[: len(data) // 4], w, h, -1
    if case == "makeup":  # every run length 0..599: terminating + makeup codes
        ramp = np.zeros((600, 600), bool)
        for i in range(600):
            ramp[i, :i] = True
        return _tiff_ccitt_strips(ramp, "group4"), 600, 600, -1
    if case == "garbage":
        return bytes(np.random.RandomState(3).randint(0, 256, 200, np.uint8)), w, h, -1
    raise ValueError(case)


@pytest.mark.parametrize("case", ["group4", "group3", "truncated", "makeup", "garbage"])
def test_ccitt_decode_matches_jax(case):
    data, w, h, k = _ccitt_case(case)
    got = port_native.ccitt_decode(data, w, h, k=k)
    want = jax_native.ccitt_decode(data, w, h, k=k)
    assert got.shape == (h, w)
    assert np.array_equal(got, want)
    if case == "group4":
        assert np.array_equal(got == 1, _fax_test_image())


# ------------------------------------------------------------ JBIG2

def _mmr(bm):
    return _tiff_ccitt_strips(bm, "group4")


def _jbig2_case(case):
    """-> (stream, width, height, globals)"""
    syms = _glyphs()
    inst = [(0, 2, 1), (1, 8, 1), (2, 15, 1), (1, 2, 8), (0, 10, 9)]
    if case in ("generic_t0", "generic_t1", "generic_t2", "generic_t3"):
        tmpl = int(case[-1])
        bm = _blob_bitmap(40, 61, seed=tmpl)
        return page_info_segment(1, 61, 40) + generic_region_segment(2, bm, tmpl=tmpl), \
            61, 40, b""
    if case == "generic_tpgdon":
        bm = np.repeat(_blob_bitmap(12, 50, seed=9), 3, axis=0)
        return page_info_segment(1, 50, 36) + generic_region_segment(
            2, bm, tmpl=0, tpgdon=True), 50, 36, b""
    if case == "generic_at":
        bm = _blob_bitmap(30, 44, seed=3)
        return page_info_segment(1, 44, 30) + generic_region_segment(
            2, bm, tmpl=0, at=(2, -1, -2, -1, 1, -2, -1, -2)), 44, 30, b""
    if case == "generic_offset":
        bm = _blob_bitmap(10, 20, seed=5)
        return page_info_segment(1, 40, 30) + generic_region_segment(
            2, bm, x=15, y=18), 40, 30, b""
    if case == "generic_mmr":
        bm = _blob_bitmap(48, 64, seed=7)
        return page_info_segment(1, 64, 48) + generic_region_segment(
            2, bm, mmr_data=_mmr(bm)), 64, 48, b""
    if case == "text":
        return (page_info_segment(1, 26, 16) + symbol_dict_segment(2, syms)
                + text_region_segment(3, 2, 26, 16, inst, syms)), 26, 16, b""
    if case == "text_globals":
        inst2 = [(2, 1, 2), (0, 9, 2)]
        return page_info_segment(1, 18, 10) + text_region_segment(
            3, 2, 18, 10, inst2, syms), 18, 10, symbol_dict_segment(2, syms)
    if case == "huffman":
        return (page_info_segment(1, 26, 16) + huff_symbol_dict_segment(2, syms)
                + huff_text_region_segment(3, 2, 26, 16, inst, syms)), 26, 16, b""
    if case == "huffman_mmr":
        inst2 = [(2, 1, 2), (0, 9, 2), (1, 15, 2)]
        return (page_info_segment(1, 22, 9)
                + huff_symbol_dict_segment(2, syms, mmr_encode=_mmr)
                + huff_text_region_segment(3, 2, 22, 9, inst2, syms)), 22, 9, b""
    if case == "halftone":
        pats = _halftone_patterns()
        gray = np.random.RandomState(4).randint(0, len(pats), size=(5, 8))
        return (page_info_segment(1, 32, 20) + pattern_dict_segment(2, pats)
                + halftone_region_segment(3, 2, 32, 20, gray, pats)), 32, 20, b""
    if case == "halftone_mmr":
        pats = _halftone_patterns()
        gray = np.random.RandomState(11).randint(0, len(pats), size=(4, 7))
        return (page_info_segment(1, 28, 16)
                + pattern_dict_segment(2, pats, mmr_encode=_mmr)
                + halftone_region_segment(3, 2, 28, 16, gray, pats,
                                          mmr_encode=_mmr)), 28, 16, b""
    if case == "refagg_unsupported":
        body = (3).to_bytes(2, "big")
        return page_info_segment(1, 8, 8) + segment_header(2, 0, length=len(body)) \
            + body, 8, 8, b""
    if case == "corrupt":
        return b"\x00\x01\x02", 8, 8, b""
    if case == "empty_size":
        return b"", 0, 5, b""
    raise ValueError(case)


_JBIG2_CASES = ["generic_t0", "generic_t1", "generic_t2", "generic_t3",
                "generic_tpgdon", "generic_at", "generic_offset", "generic_mmr",
                "text", "text_globals", "huffman", "huffman_mmr", "halftone",
                "halftone_mmr", "refagg_unsupported", "corrupt", "empty_size"]


def _decode_both(stream, w, h, g):
    out = []
    for native in (jax_native, port_native):
        try:
            out.append(native.jbig2_decode(stream, w, h, globals_data=g))
        except ValueError as e:
            out.append(str(e))
    return out


@pytest.mark.parametrize("case", _JBIG2_CASES)
def test_jbig2_decode_matches_jax(case):
    stream, w, h, g = _jbig2_case(case)
    want, got = _decode_both(stream, w, h, g)
    if isinstance(want, str):
        assert got == want and want.startswith("JBIG2 decode failed")
        assert case in ("refagg_unsupported", "corrupt")
        assert port_native.jbig2_last_error() in want
    else:
        assert got.shape == (h, w) and np.array_equal(got, want)
        if case == "generic_t0":
            assert np.array_equal(got, _blob_bitmap(40, 61, seed=0))


@pytest.mark.parametrize("seed", [0, 1])
def test_jbig2_mutations_match_jax(seed):
    """Byte-level mutations of a valid stream decode to the same bitmap or
    fail with the same message in both packages."""
    stream, w, h, _ = _jbig2_case("text")
    rng = np.random.RandomState(seed)
    for _ in range(60):
        mutated = bytearray(stream)
        for _ in range(rng.randint(1, 4)):
            mutated[rng.randint(len(mutated))] = rng.randint(256)
        want, got = _decode_both(bytes(mutated), w, h, b"")
        if isinstance(want, str):
            assert got == want
        else:
            assert np.array_equal(got, want)


# ------------------------------------------------------------ synthetic PDFs

def _fax_image_dict(w, h, n, black_is_1=None, mask=False):
    parms = f"<< /K -1 /Columns {w} /Rows {h}" + (
        "" if black_is_1 is None else f" /BlackIs1 {'true' if black_is_1 else 'false'}"
    ) + " >>"
    kind = "/ImageMask true" if mask else "/ColorSpace /DeviceGray"
    return (f"<< /Type /XObject /Subtype /Image /Width {w} /Height {h} {kind} "
            f"/BitsPerComponent 1 /Filter /CCITTFaxDecode /DecodeParms {parms} "
            f"/Length {n} >>")


def _jbig2_pdf(path, stream, w, h, globals_data=None):
    parms = "/DecodeParms << /JBIG2Globals 6 0 R >> " if globals_data else ""
    return _build_pdf(
        path,
        f"<< /Type /XObject /Subtype /Image /Width {w} /Height {h} "
        f"/ColorSpace /DeviceGray /BitsPerComponent 1 /Filter /JBIG2Decode "
        f"{parms}/Length {len(stream)} >>",
        stream, w, h,
        extra_stream_objects=[globals_data] if globals_data else (),
    )


def _jpx_pdf(path):
    from PIL import Image

    rgb = np.zeros((32, 48, 3), np.uint8)
    rgb[:16, :, 0] = 220
    rgb[16:, :, 2] = 220
    buf = io.BytesIO()
    Image.fromarray(rgb).save(buf, format="JPEG2000")
    data = buf.getvalue()
    return _build_pdf(path, "<< /Type /XObject /Subtype /Image /Width 48 /Height 32 "
                      "/ColorSpace /DeviceRGB /BitsPerComponent 8 "
                      f"/Filter /JPXDecode /Length {len(data)} >>", data, 48, 32)


_AXIAL = ("<< /ShadingType 2 /ColorSpace /DeviceRGB /Coords [0 0 100 0] "
          "/Function << /FunctionType 2 /Domain [0 1] /C0 [1 0 0] /C1 [0 0 1] /N 1 >> >>")
_STITCH = ("<< /ShadingType 2 /ColorSpace /DeviceRGB /Coords [0 0 0 60] "
           "/Function << /FunctionType 3 /Domain [0 1] /Bounds [0.5] "
           "/Encode [0 1 0 1] /Functions ["
           "<< /FunctionType 2 /Domain [0 1] /C0 [0 1 0] /C1 [0 0.5 0] /N 1 >> "
           "<< /FunctionType 2 /Domain [0 1] /C0 [0 0.5 0] /C1 [0 1 0] /N 1 >>"
           "] >> >>")
_GRAY = ("<< /ShadingType 2 /ColorSpace /DeviceGray /Coords [0 0 100 0] "
         "/Function << /FunctionType 2 /Domain [0 1] /C0 [0] /C1 [0.4] /N 1 >> >>")


def _tiling(cell, paint):
    return ("<< /PatternType 1 /PaintType %d /TilingType 1 /BBox [0 0 10 10] "
            "/XStep 10 /YStep 10 /Resources << >> /Length %d >>\nstream\n%s\nendstream"
            % (paint, len(cell), cell))


def _font_pdf(path, case):
    if case == "type1":
        prog = _build_type1_program()
        objs = _page_objs(5, "BT /F1 48 Tf 20 25 Td (AAA) Tj ET")
        objs += [
            b"<< /Type /Font /Subtype /Type1 /BaseFont /TestT1 /FirstChar 65 "
            b"/LastChar 65 /Widths [600] /FontDescriptor 6 0 R >>",
            b"<< /Type /FontDescriptor /FontName /TestT1 /Flags 4 /FontFile 7 0 R >>",
            _stream(f"/Length1 {len(prog)} /Length2 0 /Length3 0", prog),
        ]
    elif case == "type3":
        objs = _page_objs(5, "BT /F1 48 Tf 20 25 Td (AA) Tj ET")
        objs += [
            b"<< /Type /Font /Subtype /Type3 /FontBBox [0 0 600 600] "
            b"/FontMatrix [0.001 0 0 0.001 0 0] /CharProcs << /square 6 0 R >> "
            b"/Encoding << /Type /Encoding /Differences [65 /square] >> "
            b"/FirstChar 65 /LastChar 65 /Widths [600] >>",
            _stream("", b"600 0 0 0 600 600 d1 0 0 600 600 re f"),
        ]
    elif case == "substitute":
        objs = _page_objs(5, "BT /F1 48 Tf 20 25 Td (AB) Tj ET")
        objs.append(b"<< /Type /Font /Subtype /TrueType /BaseFont /Arial-Missing "
                    b"/FirstChar 65 /LastChar 66 /Widths [600 600] >>")
    elif case == "substitute_cid":
        tounicode = (b"/CIDInit /ProcSet findresource begin\nbegincmap\n"
                     b"1 beginbfchar\n<0001> <3042>\nendbfchar\nendcmap\nend\n")
        objs = _page_objs(5, "BT /F1 48 Tf 20 25 Td <00010001> Tj ET")
        objs += [
            b"<< /Type /Font /Subtype /Type0 /BaseFont /Ryumin-Light "
            b"/Encoding /Identity-H /DescendantFonts [6 0 R] /ToUnicode 7 0 R >>",
            b"<< /Type /Font /Subtype /CIDFontType0 /BaseFont /Ryumin-Light "
            b"/CIDSystemInfo << /Registry (Adobe) /Ordering (Japan1) /Supplement 6 >> "
            b"/FontDescriptor 8 0 R /DW 1000 >>",
            _stream("", tounicode),
            b"<< /Type /FontDescriptor /FontName /Ryumin-Light /Flags 6 >>",
        ]
    else:
        raise ValueError(case)
    return _build_pdf_generic(path, objs)


def _synthetic_pdf(tmp_path, case):
    path = tmp_path / f"{case}.pdf"
    black = _fax_test_image()
    h, w = black.shape
    g4 = _tiff_ccitt_strips(black, "group4")
    if case in ("ccitt_black0", "ccitt_black1"):
        return _build_pdf(path, _fax_image_dict(w, h, len(g4), case == "ccitt_black1"),
                          g4, w, h)
    if case == "ccitt_imagemask":
        return _build_pdf(path, _fax_image_dict(w, h, len(g4), mask=True), g4, w, h,
                          f"q 1 0 0 rg {w} 0 0 {h} 0 0 cm /Im0 Do Q")
    if case == "jbig2_generic":
        bm = _blob_bitmap(60, 80, seed=11)
        return _jbig2_pdf(path, page_info_segment(1, 80, 60)
                          + generic_region_segment(2, bm), 80, 60)
    if case == "jbig2_text_globals":
        syms = _glyphs()
        inst = [(0, 10, 10), (1, 30, 10), (2, 50, 10)]
        return _jbig2_pdf(path, page_info_segment(1, 80, 40)
                          + text_region_segment(3, 2, 80, 40, inst, syms), 80, 40,
                          globals_data=symbol_dict_segment(2, syms))
    if case == "jbig2_corrupt":
        return _jbig2_pdf(path, b"\x00" * 8, 40, 30)
    if case == "jpx":
        return _jpx_pdf(path)
    if case == "shading_axial":
        return _build_shading_pdf(path, _AXIAL, "q 0 0 50 60 re W n /Sh0 sh Q")
    if case == "shading_stitch":
        return _build_shading_pdf(path, _STITCH, "q 0 0 100 60 re W n /Sh0 sh Q")
    if case == "shading_pattern":
        return _build_shading_pdf(
            path, _GRAY, "/Pattern cs /P0 scn 10 10 80 40 re f",
            extra_res="/Pattern << /P0 << /PatternType 2 /Shading 4 0 R >> >>")
    if case == "tiling_colored":
        return _build_shading_pdf(path, _tiling("1 0 0 rg 0 0 10 5 re f", 1),
                                  "/Pattern cs /P0 scn 10 10 80 40 re f",
                                  extra_res="/Pattern << /P0 4 0 R >>")
    if case == "tiling_uncolored":
        return _build_shading_pdf(path, _tiling("0 0 10 5 re f", 2),
                                  "/Pattern cs 0 0 1 /P0 scn 10 10 80 40 re f",
                                  extra_res="/Pattern << /P0 4 0 R >>")
    if case.startswith("font_"):
        return _font_pdf(path, case[len("font_"):])
    good = DEMO["scan"].read_bytes()
    data = {
        "corrupt_empty": b"",
        "corrupt_header_only": b"%PDF-1.4\n",
        "corrupt_truncated": good[: len(good) // 2],
        "corrupt_no_trailer": good.replace(b"trailer", b"trXiler"),
        "corrupt_no_xref": good.replace(b"xref", b"xreX"),
    }[case]
    path.write_bytes(data)
    return path


_PDF_CASES = ["ccitt_black0", "ccitt_black1", "ccitt_imagemask", "jbig2_generic",
              "jbig2_text_globals", "jbig2_corrupt", "jpx", "shading_axial",
              "shading_stitch", "shading_pattern", "tiling_colored",
              "tiling_uncolored", "font_type1", "font_type3", "font_substitute",
              "font_substitute_cid", "corrupt_empty", "corrupt_header_only",
              "corrupt_truncated", "corrupt_no_trailer", "corrupt_no_xref"]


@pytest.mark.parametrize("case", _PDF_CASES)
def test_synthetic_pdf_renders_as_jax(tmp_path, case):
    path = _synthetic_pdf(tmp_path, case)
    results = []
    for load in (jax_load_pdf, port_load_pdf):
        try:
            results.append(list(load(path, dpi=72)))
        except ValueError as e:
            results.append(str(e))
    want, got = results
    if isinstance(want, str):
        assert got == want and case.startswith("corrupt")
        return
    _same_pages(got, want)
    if not case.startswith("corrupt") and case != "jbig2_corrupt":
        assert (got[0] < 240).any(), "the page carries ink"
