"""The port's searchable-PDF writer against the JAX package's, byte for
byte (the writer is deterministic): horizontal and vertical Japanese and
Latin words in paragraphs, table cells and figures, every image quality,
PIL and BGR pages, two pages, a font given by path; the port's file
re-opened with its own PdfDocument and renderer, and its text layer read
back through the ToUnicode CMap (``chip_smoke.text_layer``, the reader
phase 10 gates with); and ``utils.jp_text`` against the JAX module."""

import numpy as np
import pytest
from PIL import Image

import chip_smoke
from test_torch_pdf import builtin_pdf_backend  # noqa: F401  (autouse)
from yomitoku_tpu import schemas as jax_schemas
from yomitoku_tpu.utils import jp_text as jax_jp
from yomitoku_tpu.utils.searchable_pdf import create_searchable_pdf as jax_create
from yomitoku_tpu_torch import schemas as port_schemas
from yomitoku_tpu_torch.data.pdf import load_pdf
from yomitoku_tpu_torch.data.pdf.document import PdfDocument
from yomitoku_tpu_torch.utils import jp_text as port_jp
from yomitoku_tpu_torch.utils import searchable_pdf
from yomitoku_tpu_torch.utils.searchable_pdf import create_searchable_pdf as port_create


def _word(points, content, direction="horizontal"):
    return dict(points=points, content=content, direction=direction,
                det_score=0.91, rec_score=0.87)


def _para(box, contents, direction="horizontal", order=0, role=None):
    return dict(box=box, contents=contents, direction=direction, order=order, role=role)


def _page_dict(variant):
    """A page schema as a dict: Japanese and Latin words, horizontal and
    vertical, in paragraphs, a table's cells and a figure."""
    words = [
        _word([[20, 20], [220, 20], [220, 60], [20, 60]], "テスト text"),
        _word([[240, 20], [300, 20], [300, 50], [240, 50]], "ﾃｽﾄ１２3"),
        _word([[320, 30], [350, 30], [350, 190], [320, 190]], "縦書きABC", "vertical"),
        _word([[30, 120], [110, 120], [110, 150], [30, 150]], "表の中"),
        _word([[130, 120], [200, 120], [200, 150], [130, 150]], "¥100"),
        _word([[40, 230], [160, 230], [160, 260], [40, 260]], "図のキャプション"),
        _word([[200, 300], [200, 300], [200, 300], [200, 300]], "empty box"),
    ][: 7 if variant == 0 else 5]
    table = dict(
        box=[20, 110, 220, 160], n_row=1, n_col=2, rows=[], cols=[], spans=[], order=1,
        cells=[dict(col=1, row=1, col_span=1, row_span=1, box=[20, 110, 120, 160],
                    contents="表の中"),
               dict(col=2, row=1, col_span=1, row_span=1, box=[120, 110, 220, 160],
                    contents="¥100")])
    figure = dict(box=[30, 220, 180, 280], order=2, direction="horizontal",
                  paragraphs=[_para([40, 230, 160, 260], "図のキャプション")])
    return dict(
        words=words,
        paragraphs=[_para([20, 20, 300, 60], "テスト text ﾃｽﾄ１２3", order=0),
                    _para([320, 30, 350, 190], "縦書きABC", "vertical", order=3),
                    _para([195, 295, 205, 305], "empty box", order=4)],
        tables=[table] if variant == 0 else [],
        figures=[figure] if variant == 0 else [],
    )


def _docs(n):
    dicts = [_page_dict(i % 2) for i in range(n)]
    return ([jax_schemas.DocumentAnalyzerSchema.model_validate(d) for d in dicts],
            [port_schemas.DocumentAnalyzerSchema.model_validate(d) for d in dicts])


def _image(seed, h=320, w=400):
    img = np.random.RandomState(seed).randint(150, 256, (h, w, 3)).astype(np.uint8)
    img[40:60, 30:200] = 20  # some ink
    return img


def _write_both(tmp_path, images, n, **kwargs):
    jax_docs, port_docs = _docs(n)
    jax_out, port_out = tmp_path / "jax.pdf", tmp_path / "port.pdf"
    jax_create(images, jax_docs, output_path=str(jax_out), **kwargs)
    port_create(images, port_docs, output_path=str(port_out), **kwargs)
    return jax_out.read_bytes(), port_out, port_docs


@pytest.mark.parametrize("quality", ["high", "middle", "low"])
def test_searchable_pdf_matches_jax_per_quality(tmp_path, quality):
    # a long side past the middle and low presets' limits, so both resize
    want, port_out, _ = _write_both(tmp_path, [_image(0, 1700, 2100)], 1,
                                    image_quality=quality)
    got = port_out.read_bytes()
    assert got.startswith(b"%PDF") and got == want


@pytest.mark.parametrize("pages", ["two_bgr", "pil", "font_path"])
def test_searchable_pdf_matches_jax(tmp_path, pages):
    if pages == "two_bgr":
        images, kwargs = [_image(1), _image(2, 300, 420)], {}
    elif pages == "pil":
        images, kwargs = [Image.fromarray(_image(3)[:, :, ::-1])], {}
    else:
        images, kwargs = [_image(4)], dict(font_path=searchable_pdf.FONT_PATH)
    want, port_out, _ = _write_both(tmp_path, images, len(images), **kwargs)
    assert port_out.read_bytes() == want


def test_searchable_pdf_round_trip(tmp_path):
    """Two pages re-opened with the port's PdfDocument: the invisible text
    layer, the ToUnicode CMap, each page's words in its text layer, and
    the pages rendered back by the port's renderer."""
    images = [_image(5), _image(6)]
    _, out, docs = _write_both(tmp_path, images, 2)
    raw = out.read_bytes()
    doc = PdfDocument(str(out))
    assert doc.n_pages == 2
    for i in range(2):
        content = doc.get_page_content(doc.get_page(i))
        assert b"3 Tr" in content and b"Tj" in content
    assert b"ToUnicode" in raw
    layer = chip_smoke.text_layer(out)
    assert len(layer) == 2
    # every word the writer places: on page 1 all but the one with an empty
    # box, on page 2 (no table) not the two that only a cell held
    for shown, page_doc, placed in zip(layer, docs, (6, 3)):
        assert chip_smoke.words_missing_from_layer(shown, page_doc) == ([], placed)
    # horizontal words whole, a vertical one a character at a time, full width
    assert "テスト text" in layer[0] and "¥100" in layer[0]
    assert "".join(layer[0]).count("縦書きＡＢＣ") == 1
    # a word the layer lacks is reported
    other = port_schemas.DocumentAnalyzerSchema.model_validate(
        dict(_page_dict(1), words=[_word([[22, 22], [99, 22], [99, 40], [22, 40]], "不在")]))
    assert chip_smoke.words_missing_from_layer(layer[0], other) == (["不在"], 1)
    rendered = list(load_pdf(out, dpi=72))
    assert len(rendered) == 2 and rendered[0].shape == (320, 400, 3)
    assert rendered[0][50, 100].mean() < 128  # the ink survives JPEG and render


_MIXED = [
    "", "abcXYZ 012", "ﾃｽﾄ ｶﾞｷﾞｸﾞ ﾊﾟﾋﾟ ｳﾞ", "ﾞ ﾟ ｶﾟ", "ＡＢＣ　１２３", "ひらがな カタカナ",
    "ゔぁ ヴァヶ", "¥100·円 ", "mixed ﾃｷｽﾄ と 全角ｶﾅ!?", "～〜ー－-", "\t\n~",
]


@pytest.mark.parametrize("name", ["h2z", "z2h", "kata2hira", "hira2kata", "to_full_width"])
def test_jp_text_matches_jax(name):
    port, jax = getattr(port_jp, name), getattr(jax_jp, name)
    for text in _MIXED:
        assert port(text) == jax(text), text
        if name in ("h2z", "z2h"):
            for flags in ({"ascii": False}, {"digit": False}, {"kana": False},
                          {"ascii": False, "digit": False}):
                assert port(text, **flags) == jax(text, **flags), (text, flags)
