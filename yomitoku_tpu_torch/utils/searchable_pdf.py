"""Searchable PDF creation: page JPEGs + invisible text layer (the port's
copy of yomitoku_tpu/utils/searchable_pdf.py; it embeds the port's own
``resource/MPLUS1p-Medium.ttf``).

Reference parity: yomitoku/utils/searchable_pdf.py — per page, draw the
image (quality presets high/middle/low), overlay invisible text per word,
containers sorted by reading order, font size chosen to match the word box
width, vertical text drawn per-char rotated -90 deg with full-width
conversion.

Reportlab is replaced by our own PDF writer (data/pdf/writer.py): the TTF
is embedded as a CIDFontType2 with Identity-H encoding where CID == GID,
plus a ToUnicode CMap built from the font's cmap so extracted text
round-trips.
"""

import numpy as np

from ..constants import ROOT_DIR
from ..data.pdf.fonts import TrueTypeFont
from ..data.pdf.writer import PdfWriter
from .jp_text import to_full_width
from .misc import is_contained

FONT_PATH = ROOT_DIR + "/resource/MPLUS1p-Medium.ttf"

IMAGE_QUALITY_PRESETS = {
    "high": {"max_long_side": None, "jpeg_quality": 85},
    "middle": {"max_long_side": 2000, "jpeg_quality": 80},
    "low": {"max_long_side": 1500, "jpeg_quality": 60},
}


def _poly2rect(points):
    points = np.array(points, dtype=int)
    return [
        points[:, 0].min(), points[:, 1].min(),
        points[:, 0].max(), points[:, 1].max(),
    ]


class _EmbeddedFont:
    def __init__(self, font_path):
        with open(font_path, "rb") as f:
            self.raw = f.read()
        self.tt = TrueTypeFont(self.raw)
        self.cmap = self.tt.cmap()
        self.upem = float(self.tt.units_per_em)
        self.used = {}  # gid -> unicode

    def encode(self, text):
        """text -> (gids, total advance in 1000/em units)."""
        gids = []
        adv = 0.0
        for ch in text:
            gid = self.cmap.get(ord(ch), 0)
            gids.append(gid)
            self.used.setdefault(gid, ch)
            adv += self.tt.advance_width(gid) / self.upem * 1000.0
        return gids, adv

    def string_width(self, text, font_size):
        _, adv = self.encode(text)
        return adv / 1000.0 * font_size


def _calc_font_size(font, content, bbox_height, bbox_width):
    """Reference _calc_font_size (utils/searchable_pdf.py:43): scan rates
    0.5..0.99 of the box height, keep the size whose string width best
    matches the box width."""
    min_diff = np.inf
    best = None
    for rate in np.arange(0.5, 1.0, 0.01):
        font_size = bbox_height * rate
        diff = abs(font.string_width(content, font_size) - bbox_width)
        if diff < min_diff:
            min_diff = diff
            best = font_size
    return best


def _collect_sorted_words(doc):
    containers = []
    for p in doc.paragraphs:
        containers.append(
            {"box": p.box, "order": p.order, "sub_order": 0,
             "direction": p.direction}
        )
    for t in doc.tables:
        for cell in t.cells:
            containers.append(
                {"box": cell.box, "order": t.order,
                 "sub_order": (cell.row, cell.col), "direction": "horizontal"}
            )
    for f in doc.figures:
        for idx, p in enumerate(f.paragraphs):
            containers.append(
                {"box": p.box, "order": f.order, "sub_order": idx,
                 "direction": p.direction}
            )
    containers.sort(key=lambda c: (c["order"], c["sub_order"]))

    all_words = []
    for container in containers:
        inside = [
            w for w in doc.words
            if is_contained(container["box"], _poly2rect(w.points), 0.7)
        ]
        if container["direction"] == "vertical":
            inside.sort(key=lambda w: (-_poly2rect(w.points)[0],
                                       _poly2rect(w.points)[1]))
        else:
            inside.sort(key=lambda w: (_poly2rect(w.points)[1],
                                       _poly2rect(w.points)[0]))
        all_words.extend(inside)
    return all_words


def _hex(gids):
    return "<" + "".join(f"{g:04x}" for g in gids) + ">"


def _page_text_ops(doc, font, page_h):
    ops = ["BT", "3 Tr"]
    for word in _collect_sorted_words(doc):
        text = word.content
        if not text:
            continue
        x1, y1, x2, y2 = _poly2rect(word.points)
        bbox_h = y2 - y1
        bbox_w = x2 - x1
        if word.direction == "vertical":
            text = to_full_width(text)
            font_size = _calc_font_size(font, text, bbox_w, bbox_h)
        else:
            font_size = _calc_font_size(font, text, bbox_h, bbox_w)
        if not font_size:
            continue
        fs = f"{font_size:.2f}"
        if word.direction == "vertical":
            char_h = bbox_h / len(text) if text else 0
            for j, ch in enumerate(text):
                gids, _ = font.encode(ch)
                cx = x1 + (bbox_w - font_size) / 2
                cy = (page_h - y1) - j * char_h - char_h / 2 + font_size / 2
                # rotate -90: Tm = [cos -sin sin cos x y] with θ=-90
                ops.append(
                    f"/F1 {fs} Tf 0 -1 1 0 {cx:.2f} {cy:.2f} Tm {_hex(gids)} Tj"
                )
        else:
            base_y = page_h - y2 + (bbox_h - font_size) * 0.5
            gids, _ = font.encode(text)
            ops.append(
                f"/F1 {fs} Tf 1 0 0 1 {x1:.2f} {base_y:.2f} Tm {_hex(gids)} Tj"
            )
    ops.append("ET")
    return "\n".join(ops)


def _to_unicode_cmap(used):
    lines = [
        "/CIDInit /ProcSet findresource begin",
        "12 dict begin", "begincmap",
        "/CIDSystemInfo << /Registry (Adobe) /Ordering (UCS) /Supplement 0 >> def",
        "/CMapName /Adobe-Identity-UCS def", "/CMapType 2 def",
        "1 begincodespacerange", "<0000> <FFFF>", "endcodespacerange",
    ]
    entries = sorted(used.items())
    for i in range(0, len(entries), 100):
        chunk = entries[i : i + 100]
        lines.append(f"{len(chunk)} beginbfchar")
        for gid, ch in chunk:
            u = "".join(f"{b:04x}" for b in [ord(c) for c in ch][:1])
            lines.append(f"<{gid:04x}> <{u}>")
        lines.append("endbfchar")
    lines += ["endcmap", "CMapName currentdict /CMap defineresource pop",
              "end", "end"]
    return "\n".join(lines).encode("latin-1", "replace")


def create_searchable_pdf(
    images,
    docs,
    output_path,
    font_path=None,
    image_quality="high",
):
    """images: list of PIL Images or BGR ndarrays; docs: list of
    DocumentAnalyzerSchema (reference utils/searchable_pdf.py:74)."""
    import cv2

    font = _EmbeddedFont(font_path or FONT_PATH)
    preset = IMAGE_QUALITY_PRESETS.get(image_quality, IMAGE_QUALITY_PRESETS["high"])

    w = PdfWriter()
    catalog_num = w.add(None)
    pages_num = w.add(None)
    font_num = w.add(None)
    page_nums = []

    for image, doc in zip(images, docs):
        is_pil = hasattr(image, "convert")
        if is_pil:
            img = np.asarray(image.convert("RGB"))[:, :, ::-1]
        else:
            img = image
        if preset["max_long_side"] is not None:
            hh, ww = img.shape[:2]
            long_side = max(hh, ww)
            if long_side > preset["max_long_side"]:
                scale = preset["max_long_side"] / long_side
                img = cv2.resize(
                    img, (int(ww * scale), int(hh * scale)),
                    interpolation=cv2.INTER_AREA,
                )
        ph, pw = img.shape[:2]
        ok, jpeg = cv2.imencode(
            ".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, preset["jpeg_quality"]]
        )
        img_num = w.stream(
            {
                "Type": "/XObject", "Subtype": "/Image",
                "Width": pw, "Height": ph,
                "ColorSpace": "/DeviceRGB", "BitsPerComponent": 8,
                "Filter": "/DCTDecode",
            },
            jpeg.tobytes(),
            compress=False,
        )
        # NOTE: text coords are in ORIGINAL image space; scale page to it
        if is_pil:
            ow, oh = image.size
        else:
            oh, ow = image.shape[:2]
        content = (
            f"q {ow} 0 0 {oh} 0 0 cm /Im0 Do Q\n"
            + _page_text_ops(doc, font, oh)
        )
        content_num = w.stream({}, content.encode("latin-1", "replace"))
        page_num = w.add(
            {
                "Type": "/Page",
                "Parent": w.ref(pages_num),
                "MediaBox": [0, 0, ow, oh],
                "Resources": {
                    "XObject": {"Im0": w.ref(img_num)},
                    "Font": {"F1": w.ref(font_num)},
                },
                "Contents": w.ref(content_num),
            }
        )
        page_nums.append(page_num)

    # font objects (after all pages: `used` now complete)
    ff_num = w.stream({"Length1": len(font.raw)}, font.raw)
    max_gid = max(font.used) if font.used else 0
    widths = []
    for gid in sorted(font.used):
        widths += [gid, [round(font.tt.advance_width(gid) / font.upem * 1000)]]
    desc_num = w.add(
        {
            "Type": "/FontDescriptor", "FontName": "/MPLUS1pMedium",
            "Flags": 4, "FontBBox": [-1000, -300, 2000, 1200],
            "ItalicAngle": 0, "Ascent": 880, "Descent": -120,
            "CapHeight": 700, "StemV": 80, "FontFile2": w.ref(ff_num),
        }
    )
    cid_num = w.add(
        {
            "Type": "/Font", "Subtype": "/CIDFontType2",
            "BaseFont": "/MPLUS1pMedium",
            "CIDSystemInfo": {
                "Registry": "(Adobe)",
                "Ordering": "(Identity)",
                "Supplement": 0,
            },
            "FontDescriptor": w.ref(desc_num),
            "DW": 1000,
            "W": widths,
            "CIDToGIDMap": "/Identity",
        }
    )
    tou_num = w.stream({}, _to_unicode_cmap(font.used))
    w.set(
        font_num,
        {
            "Type": "/Font", "Subtype": "/Type0",
            "BaseFont": "/MPLUS1pMedium", "Encoding": "/Identity-H",
            "DescendantFonts": [w.ref(cid_num)],
            "ToUnicode": w.ref(tou_num),
        },
    )
    w.set(
        pages_num,
        {
            "Type": "/Pages",
            "Kids": [w.ref(p) for p in page_nums],
            "Count": len(page_nums),
        },
    )
    w.set(catalog_num, {"Type": "/Catalog", "Pages": w.ref(pages_num)})

    data = w.tobytes(catalog_num)
    with open(output_path, "wb") as f:
        f.write(data)
