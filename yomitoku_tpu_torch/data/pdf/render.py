"""PDF page rasterizer: content-stream interpreter + native AA fill.

Replaces the reference's pdfium rendering (data/functions.py:96-155):
interprets the page content stream (paths, text, images, forms), converts
everything to device-space edge lists, and fills them with the C++
rasterizer (csrc/rasterizer.cpp through the port's native/).  Embedded CFF /
TrueType glyph programs come from data/pdf/fonts.py; glyph rasters are
cached per (font, gid, quantized transform).

Supported: q/Q/cm/gs(alpha), path construction + fill (nonzero/evenodd) +
stroke + clip, text (Type0 CID fonts w/ Identity-H|V, simple
Type1C/TrueType), image XObjects (DCT/JPX/Flate/CCITT G3+G4 fax/JBIG2
incl. JBIG2Globals, gray/rgb/cmyk/indexed, image masks, SMask alpha),
form XObjects.  Shadings, shading patterns, and tiling patterns paint
their average colour (flat approximation — keeps gradient/hatched
backgrounds from rendering as holes); JBIG2 covers arithmetic and
Huffman symbol coding — only halftone regions are skipped with a
warning.
"""

import struct
import zlib

import cv2
import numpy as np

from ...utils.logger import set_logger
from .cos import Keyword, Name, Parser, Stream
from .filters import IMAGE_FILTERS, decode_stream
from .fonts import CFFFont, TrueTypeFont, Type1Font

logger = set_logger(__name__)

# Image filters whose data stays encoded through decode_stream.  Every member
# must be consumed by a dedicated branch in _decode_image before the raw-pixel
# path; anything left over is skipped loudly rather than misread as pixels.
_ENCODED_IMAGE_FILTERS = IMAGE_FILTERS


# ------------------------------------------------------------------ helpers

def _mat_mul(a, b):
    """3x3 affine as 6-tuple (a, b, c, d, e, f): result = a then b."""
    a0, a1, a2, a3, a4, a5 = a
    b0, b1, b2, b3, b4, b5 = b
    return (
        a0 * b0 + a1 * b2,
        a0 * b1 + a1 * b3,
        a2 * b0 + a3 * b2,
        a2 * b1 + a3 * b3,
        a4 * b0 + a5 * b2 + b4,
        a4 * b1 + a5 * b3 + b5,
    )


def _apply(m, x, y):
    return (m[0] * x + m[2] * y + m[4], m[1] * x + m[3] * y + m[5])


def _flatten_cubic(p0, p1, p2, p3, out, tol=0.2, depth=0):
    # flatness: control point distance from chord
    dx = p3[0] - p0[0]
    dy = p3[1] - p0[1]
    d1 = abs((p1[0] - p3[0]) * dy - (p1[1] - p3[1]) * dx)
    d2 = abs((p2[0] - p3[0]) * dy - (p2[1] - p3[1]) * dx)
    if depth > 16 or (d1 + d2) ** 2 <= tol * (dx * dx + dy * dy):
        out.append(p3)
        return
    p01 = ((p0[0] + p1[0]) / 2, (p0[1] + p1[1]) / 2)
    p12 = ((p1[0] + p2[0]) / 2, (p1[1] + p2[1]) / 2)
    p23 = ((p2[0] + p3[0]) / 2, (p2[1] + p3[1]) / 2)
    p012 = ((p01[0] + p12[0]) / 2, (p01[1] + p12[1]) / 2)
    p123 = ((p12[0] + p23[0]) / 2, (p12[1] + p23[1]) / 2)
    mid = ((p012[0] + p123[0]) / 2, (p012[1] + p123[1]) / 2)
    _flatten_cubic(p0, p01, p012, mid, out, tol, depth + 1)
    _flatten_cubic(mid, p123, p23, p3, out, tol, depth + 1)


def _contours_to_edges(contours):
    """List of device-space point lists -> (N, 4) float32 edge array."""
    segs = []
    for pts in contours:
        if len(pts) < 2:
            continue
        arr = np.asarray(pts, np.float32)
        closed = np.concatenate([arr, arr[:1]], axis=0)
        e = np.concatenate([closed[:-1], closed[1:]], axis=1)
        segs.append(e)
    if not segs:
        return np.zeros((0, 4), np.float32)
    return np.concatenate(segs, axis=0)


def _path_to_device_contours(path, m, tol=0.2):
    """Glyph/path segments (fonts.py format) -> flattened device contours."""
    contours = []
    for contour in path:
        if not contour:
            continue
        cur = _apply(m, *contour[0][1])
        pts = [cur]
        for seg in contour[1:]:
            if seg[0] == "L":
                cur = _apply(m, *seg[1])
                pts.append(cur)
            elif seg[0] == "C":
                c1 = _apply(m, *seg[1])
                c2 = _apply(m, *seg[2])
                p3 = _apply(m, *seg[3])
                _flatten_cubic(pts[-1], c1, c2, p3, pts, tol)
                cur = p3
            elif seg[0] == "Q":
                qc = _apply(m, *seg[1])
                p2 = _apply(m, *seg[2])
                p0 = pts[-1]
                c1 = (p0[0] + 2.0 / 3.0 * (qc[0] - p0[0]),
                      p0[1] + 2.0 / 3.0 * (qc[1] - p0[1]))
                c2 = (p2[0] + 2.0 / 3.0 * (qc[0] - p2[0]),
                      p2[1] + 2.0 / 3.0 * (qc[1] - p2[1]))
                _flatten_cubic(p0, c1, c2, p2, pts, tol)
                cur = p2
        contours.append(pts)
    return contours


# ------------------------------------------------------------------- fonts

_STD_ENC = None


def _standard_encoding():
    global _STD_ENC
    if _STD_ENC is None:
        # AdobeStandardEncoding, printable core (code -> glyph name)
        names = {}
        for c in range(0x21, 0x7F):
            names[c] = None  # filled below for specials; identity for ASCII
        specials = {
            0x20: "space", 0x21: "exclam", 0x22: "quotedbl", 0x23: "numbersign",
            0x24: "dollar", 0x25: "percent", 0x26: "ampersand",
            0x27: "quoteright", 0x28: "parenleft", 0x29: "parenright",
            0x2A: "asterisk", 0x2B: "plus", 0x2C: "comma", 0x2D: "hyphen",
            0x2E: "period", 0x2F: "slash", 0x3A: "colon", 0x3B: "semicolon",
            0x3C: "less", 0x3D: "equal", 0x3E: "greater", 0x3F: "question",
            0x40: "at", 0x5B: "bracketleft", 0x5C: "backslash",
            0x5D: "bracketright", 0x5E: "asciicircum", 0x5F: "underscore",
            0x60: "quoteleft", 0x7B: "braceleft", 0x7C: "bar",
            0x7D: "braceright", 0x7E: "asciitilde",
        }
        for c in range(0x30, 0x3A):
            specials[c] = ["zero", "one", "two", "three", "four", "five",
                           "six", "seven", "eight", "nine"][c - 0x30]
        enc = {}
        for c in range(0x20, 0x7F):
            if c in specials:
                enc[c] = specials[c]
            elif 0x41 <= c <= 0x5A or 0x61 <= c <= 0x7A:
                enc[c] = chr(c)
        _STD_ENC = enc
    return _STD_ENC


_CFF_STANDARD_STRINGS_CORE = [
    ".notdef", "space", "exclam", "quotedbl", "numbersign", "dollar",
    "percent", "ampersand", "quoteright", "parenleft", "parenright",
    "asterisk", "plus", "comma", "hyphen", "period", "slash", "zero", "one",
    "two", "three", "four", "five", "six", "seven", "eight", "nine", "colon",
    "semicolon", "less", "equal", "greater", "question", "at",
] + [chr(c) for c in range(65, 91)] + [
    "bracketleft", "backslash", "bracketright", "asciicircum", "underscore",
    "quoteleft",
] + [chr(c) for c in range(97, 123)] + [
    "braceleft", "bar", "braceright", "asciitilde",
]


class LoadedFont:
    """Renderer-facing font: codes(bytes) -> [(gid, width_1000, cid)],
    glyph_path(gid), scale to text space."""

    def __init__(self, doc, font_dict):
        self.doc = doc
        f = doc.resolve(font_dict)
        self.subtype = str(f.get(Name("Subtype"), ""))
        self.two_byte = False
        self.wmode = 0
        self.glyph_source = None
        self.upem = 1000.0
        self.cid_to_gid = None  # None => identity
        self.default_width = 1000.0
        self.width_to_text = 0.001  # Widths -> text space (Type3: fm[0])
        self.widths = {}
        self.code_to_gid = None
        self.is_type3 = False
        self.substitute = None  # (TrueTypeFont, code->unicode) fallback

        if "Type0" in self.subtype:
            self._load_type0(f)
        elif "Type3" in self.subtype:
            self._load_type3(f)
        else:
            self._load_simple(f)

        if (
            self.glyph_source is None
            and not self.is_type3
            and _substitute_font() is not None
        ):
            # No usable embedded program (non-embedded font, or an
            # undecodable one): substitute the bundled MPLUS1p face so
            # text still rasterizes for OCR — pdfium does the equivalent
            # behind reference data/functions.py:96-155.  Never silent.
            self.substitute = (_substitute_font(), self._code_to_unicode(f))
            base = self.doc.resolve(f.get(Name("BaseFont"), ""))
            logger.warning(
                "font %s (%s) has no usable embedded program; substituting "
                "bundled MPLUS1p for rasterization",
                base, self.subtype or "?",
            )

    # -- loading ---------------------------------------------------------

    def _font_program(self, descriptor):
        fd = self.doc.resolve(descriptor)
        if not fd:
            return None, None
        for key, kind in (("FontFile2", "tt"), ("FontFile3", "cff"),
                          ("FontFile", "t1")):
            ff = self.doc.resolve(fd.get(Name(key)))
            if isinstance(ff, Stream):
                return self.doc.get_stream_data(ff), kind
        return None, None

    def _load_type0(self, f):
        self.two_byte = True
        enc = f.get(Name("Encoding"))
        enc_name = str(self.doc.resolve(enc) or "Identity-H")
        if enc_name.endswith("-V"):
            self.wmode = 1
        desc = self.doc.resolve(f.get(Name("DescendantFonts")))[0]
        desc = self.doc.resolve(desc)
        data, kind = self._font_program(desc.get(Name("FontDescriptor")))
        if data is not None:
            if kind == "cff":
                cff = CFFFont(data)
                self.glyph_source = cff
                fm = cff.font_matrix
                self.upem = 1.0 / fm[0] if fm[0] else 1000.0
                if cff.is_cid:
                    self.cid_to_gid = cff.cid_to_gid
            elif kind == "tt":
                tt = TrueTypeFont(data)
                self.glyph_source = tt
                self.upem = float(tt.units_per_em)
        c2g = self.doc.resolve(desc.get(Name("CIDToGIDMap")))
        if isinstance(c2g, Stream):
            raw = self.doc.get_stream_data(c2g)
            self.cid_to_gid = {
                i: struct.unpack(">H", raw[2 * i : 2 * i + 2])[0]
                for i in range(len(raw) // 2)
            }
        self.default_width = float(self.doc.resolve(desc.get(Name("DW"), 1000)))
        w = self.doc.resolve(desc.get(Name("W")))
        if w:
            w = [self.doc.resolve(x) for x in w]
            i = 0
            while i < len(w):
                c = int(w[i])
                nxt = self.doc.resolve(w[i + 1])
                if isinstance(nxt, list):
                    for k, wid in enumerate(nxt):
                        self.widths[c + k] = float(self.doc.resolve(wid))
                    i += 2
                else:
                    c2 = int(nxt)
                    wid = float(self.doc.resolve(w[i + 2]))
                    for cc in range(c, c2 + 1):
                        self.widths[cc] = wid
                    i += 3

    def _load_simple(self, f):
        data, kind = self._font_program(f.get(Name("FontDescriptor")))
        t1 = None
        if data is not None and kind == "t1":
            try:
                t1 = Type1Font(data)
            except Exception as e:
                logger.warning("Type1 program failed to parse: %s", e)
                data = None

        code_to_name = dict(
            (t1.builtin_encoding if t1 is not None and t1.builtin_encoding
             else _standard_encoding())
        )
        enc = self.doc.resolve(f.get(Name("Encoding")))
        if isinstance(enc, dict):
            diffs = self.doc.resolve(enc.get(Name("Differences")))
            if diffs:
                code = 0
                for item in diffs:
                    item = self.doc.resolve(item)
                    if isinstance(item, (int, float)):
                        code = int(item)
                    else:
                        code_to_name[code] = str(item)
                        code += 1

        if t1 is not None:
            self.glyph_source = t1
            fm = t1.font_matrix
            self.upem = 1.0 / fm[0] if fm[0] else 1000.0
            self.code_to_gid = {
                code: t1.name_to_gid[nm]
                for code, nm in code_to_name.items()
                if nm in t1.name_to_gid
            }
        elif data is not None and kind == "cff":
            cff = CFFFont(data)
            self.glyph_source = cff
            fm = cff.font_matrix
            self.upem = 1.0 / fm[0] if fm[0] else 1000.0
            # name -> gid via charset SIDs
            sid_to_name = {}
            for sid, nm in enumerate(_CFF_STANDARD_STRINGS_CORE):
                sid_to_name[sid] = nm
            # custom strings: SID 391+
            hdr = cff.data[2]
            pos = hdr
            _n, pos = _read_index_names(cff.data, pos)
            _t, pos = _read_index_names(cff.data, pos)
            strings, _ = _read_index_names(cff.data, pos)
            for k, s in enumerate(strings):
                sid_to_name[391 + k] = s.decode("latin-1", "replace")
            name_to_gid = {}
            for gid, sid in enumerate(cff.charset):
                nm = sid_to_name.get(sid)
                if nm is not None and nm not in name_to_gid:
                    name_to_gid[nm] = gid
            self.code_to_gid = {
                code: name_to_gid.get(nm, 0)
                for code, nm in code_to_name.items()
                if nm
            }
        elif data is not None and kind == "tt":
            tt = TrueTypeFont(data)
            self.glyph_source = tt
            self.upem = float(tt.units_per_em)
            try:
                cmap = tt.cmap()
            except Exception:
                cmap = {}
            if cmap:
                # (3,1)-style unicode cmap: latin-1 code == codepoint;
                # symbolic fonts map through the 0xF000 private-use page
                self.code_to_gid = {
                    c: cmap.get(c) or cmap.get(0xF000 + c) or 0
                    for c in range(256)
                }
            else:
                self.code_to_gid = None  # no cmap: gid == code

        first = int(self.doc.resolve(f.get(Name("FirstChar"), 0)) or 0)
        widths = self.doc.resolve(f.get(Name("Widths")))
        if widths:
            for k, wv in enumerate(widths):
                self.widths[first + k] = float(self.doc.resolve(wv))
        fd = self.doc.resolve(f.get(Name("FontDescriptor")) or {})
        self.default_width = float(
            self.doc.resolve((fd or {}).get(Name("MissingWidth"), 500)) or 500
        )

    def _load_type3(self, f):
        """Type3 glyphs are content streams (CharProcs) drawn in glyph
        space through /FontMatrix — the renderer executes them with its
        normal operator loop (reference behavior via pdfium,
        data/functions.py:96-155)."""
        doc = self.doc
        self.is_type3 = True
        fm = doc.resolve(f.get(Name("FontMatrix")))
        self.font_matrix = (
            tuple(float(doc.resolve(v)) for v in fm)
            if fm
            else (0.001, 0.0, 0.0, 0.001, 0.0, 0.0)
        )
        self.width_to_text = self.font_matrix[0]
        self.t3_resources = doc.resolve(f.get(Name("Resources")))
        procs = doc.resolve(f.get(Name("CharProcs"))) or {}
        self.code_to_name = {}
        enc = doc.resolve(f.get(Name("Encoding")))
        if isinstance(enc, dict):
            diffs = doc.resolve(enc.get(Name("Differences"))) or []
            code = 0
            for item in diffs:
                item = doc.resolve(item)
                if isinstance(item, (int, float)):
                    code = int(item)
                else:
                    self.code_to_name[code] = str(item)
                    code += 1
        self.char_procs = {}
        for code, nm in self.code_to_name.items():
            proc = doc.resolve(procs.get(Name(nm)))
            if isinstance(proc, Stream):
                self.char_procs[code] = proc

        first = int(doc.resolve(f.get(Name("FirstChar"), 0)) or 0)
        widths = doc.resolve(f.get(Name("Widths")))
        if widths:
            for k, wv in enumerate(widths):
                self.widths[first + k] = float(doc.resolve(wv))
        self.default_width = 0.0

    def _code_to_unicode(self, f):
        """code -> unicode codepoint for the substitute face: the font's
        /ToUnicode CMap when present (the common case for generated
        PDFs), else the glyph-name/latin-1 heuristics."""
        doc = self.doc
        tu = doc.resolve(f.get(Name("ToUnicode")))
        if isinstance(tu, Stream):
            try:
                mapping = _parse_tounicode(doc.get_stream_data(tu))
                if mapping:
                    return mapping
            except Exception as e:
                logger.warning("ToUnicode CMap failed to parse: %s", e)
        if self.two_byte:
            # No ToUnicode on a CID font: assume the codes are already
            # unicode-ish (true for UCS2 CMaps; wrong-but-visible glyphs
            # beat blank text for Identity-H without ToUnicode)
            return {}
        # simple font: map through glyph names where they look like
        # uniXXXX, else latin-1 identity
        out = {}
        enc = doc.resolve(f.get(Name("Encoding")))
        if isinstance(enc, dict):
            diffs = doc.resolve(enc.get(Name("Differences"))) or []
            code = 0
            for item in diffs:
                item = doc.resolve(item)
                if isinstance(item, (int, float)):
                    code = int(item)
                else:
                    nm = str(item)
                    if nm.startswith("uni") and len(nm) >= 7:
                        try:
                            out[code] = int(nm[3:7], 16)
                        except ValueError:
                            pass
                    elif len(nm) == 1:
                        out[code] = ord(nm)
                    code += 1
        return out

    # -- use -------------------------------------------------------------

    def iter_codes(self, raw: bytes):
        if self.two_byte:
            for i in range(0, len(raw) - 1, 2):
                yield (raw[i] << 8) | raw[i + 1]
        else:
            yield from raw

    def width_1000(self, code):
        w = self.widths.get(code)
        if w is not None:
            return w
        if self.substitute is not None:
            # no /Widths entry: use the substitute face's advance so
            # lines keep plausible spacing
            sub, c2u = self.substitute
            gid = sub.cmap().get(c2u.get(code, code), 0)
            if gid:
                try:
                    return (
                        sub.advance_width(gid) * 1000.0 / sub.units_per_em
                    )
                except Exception:
                    pass
        return self.default_width

    def gid_for(self, code):
        if self.substitute is not None:
            sub, c2u = self.substitute
            return sub.cmap().get(c2u.get(code, code), 0)
        if self.two_byte:
            if self.cid_to_gid is not None:
                g = self.cid_to_gid.get(code)
                return g if g is not None else 0
            return code
        if self.code_to_gid is not None:
            return self.code_to_gid.get(code, 0)
        return code

    def glyph_upem(self):
        if self.substitute is not None:
            return float(self.substitute[0].units_per_em)
        return self.upem or 1000.0

    def glyph_path(self, gid):
        source = (
            self.substitute[0] if self.substitute is not None
            else self.glyph_source
        )
        if source is None:
            return []
        try:
            return source.glyph_path(gid)
        except Exception:
            return []


def _read_index_names(data, pos):
    from .fonts import _read_index

    return _read_index(data, pos)


_SUBSTITUTE_FONT = [None]


def _substitute_font():
    """Lazily-loaded bundled fallback face (MPLUS1p: full JIS kanji/kana
    coverage) used when a PDF font has no usable embedded program."""
    if _SUBSTITUTE_FONT[0] is None:
        import os

        path = os.path.join(
            os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__)
            ))),
            "resource", "MPLUS1p-Medium.ttf",
        )
        try:
            with open(path, "rb") as fh:
                _SUBSTITUTE_FONT[0] = TrueTypeFont(fh.read())
        except Exception as e:
            logger.warning("substitute font unavailable: %s", e)
            _SUBSTITUTE_FONT[0] = False
    return _SUBSTITUTE_FONT[0] or None


def _parse_tounicode(data: bytes):
    """/ToUnicode CMap -> {code: unicode codepoint} (beginbfchar and
    beginbfrange sections; multi-char targets keep the first scalar)."""
    mapping = {}
    p = Parser(data, 0)
    mode = None
    pending = []

    def _uni(b):
        if len(b) >= 2:
            cp = int.from_bytes(b[:2], "big")
            # surrogate pair -> scalar
            if 0xD800 <= cp <= 0xDBFF and len(b) >= 4:
                lo = int.from_bytes(b[2:4], "big")
                return 0x10000 + ((cp - 0xD800) << 10) + (lo - 0xDC00)
            return cp
        return b[0] if b else 0

    while True:
        p.skip_ws()
        if p.pos >= len(p.data):
            break
        try:
            obj = p.parse_object()
        except Exception:
            break
        if isinstance(obj, Keyword):
            kw = str(obj)
            if kw in ("beginbfchar", "beginbfrange"):
                mode = kw
                pending = []
            elif kw in ("endbfchar", "endbfrange"):
                if mode == "beginbfchar":
                    for k in range(0, len(pending) - 1, 2):
                        src, dst = pending[k], pending[k + 1]
                        if isinstance(src, bytes) and isinstance(dst, bytes):
                            mapping[int.from_bytes(src, "big")] = _uni(dst)
                else:
                    for k in range(0, len(pending) - 2, 3):
                        lo, hi, dst = pending[k : k + 3]
                        if not (
                            isinstance(lo, bytes) and isinstance(hi, bytes)
                        ):
                            continue
                        lo_i = int.from_bytes(lo, "big")
                        hi_i = int.from_bytes(hi, "big")
                        if hi_i - lo_i > 0x10000:
                            continue
                        if isinstance(dst, bytes):
                            base = _uni(dst)
                            for c in range(lo_i, hi_i + 1):
                                mapping[c] = base + (c - lo_i)
                        elif isinstance(dst, list):
                            for c, d in zip(range(lo_i, hi_i + 1), dst):
                                if isinstance(d, bytes):
                                    mapping[c] = _uni(d)
                mode = None
                pending = []
            continue
        if mode is not None:
            pending.append(obj)
    return mapping


# --------------------------------------------------------------- rendering

class _GState:
    def __init__(self, ctm, clip):
        self.ctm = ctm
        self.fill = (0.0, 0.0, 0.0)
        self.stroke = (0.0, 0.0, 0.0)
        self.line_width = 1.0
        self.alpha = 1.0
        self.stroke_alpha = 1.0
        self.clip = clip  # None or uint8 (h, w) mask
        self.fill_is_pattern = False

    def copy(self):
        g = _GState(self.ctm, self.clip)
        g.fill = self.fill
        g.stroke = self.stroke
        g.line_width = self.line_width
        g.alpha = self.alpha
        g.stroke_alpha = self.stroke_alpha
        g.fill_is_pattern = self.fill_is_pattern
        return g


class PageRenderer:
    def __init__(self, doc, dpi=200):
        self.doc = doc
        self.dpi = dpi
        self.font_cache = {}
        self.glyph_cache = {}

    def render(self, page):
        doc = self.doc
        media = [float(doc.resolve(v)) for v in doc.resolve(page[Name("MediaBox")])]
        x0, y0, x1, y1 = media
        s = self.dpi / 72.0
        w = max(int(round((x1 - x0) * s)), 1)
        h = max(int(round((y1 - y0) * s)), 1)
        self.w, self.h = w, h
        self.canvas = np.full((h, w, 3), 255.0, np.float32)
        base = (s, 0.0, 0.0, -s, -x0 * s, y1 * s)

        rotate = int(doc.resolve(page.get(Name("Rotate"), 0)) or 0) % 360
        if rotate:
            # pre-rotate page space; output canvas swaps dims for 90/270
            if rotate in (90, 270):
                w, h = h, w
                self.w, self.h = w, h
                self.canvas = np.full((h, w, 3), 255.0, np.float32)
            if rotate == 90:
                base = _mat_mul((0, 1, -1, 0, y1, -x0), (s, 0, 0, -s, 0, (x1 - x0) * s))
                base = ((0), 0, 0, 0, 0, 0)  # replaced below
                # rotate 90 cw: device x = (y - y0)*s ; device y = (x - x0)*s
                base = (0.0, s, s, 0.0, -y0 * s, -x0 * s)
            elif rotate == 180:
                base = (-s, 0.0, 0.0, s, x1 * s, -y0 * s)
            elif rotate == 270:
                base = (0.0, -s, -s, 0.0, y1 * s, x1 * s)

        state = _GState(base, None)
        resources = doc.resolve(page.get(Name("Resources"))) or {}
        content = doc.get_page_content(page)
        try:
            self._run(content, resources, state)
        except Exception:
            pass
        out = np.clip(self.canvas, 0, 255).astype(np.uint8)
        return out[:, :, ::-1]  # RGB float canvas -> BGR

    # -- compositing -----------------------------------------------------

    def _composite(self, mask, color, alpha, clip):
        if alpha <= 0:
            return
        if clip is not None:
            mask = (mask.astype(np.uint16) * clip.astype(np.uint16) // 255).astype(
                np.uint8
            )
        ys, xs = np.nonzero(mask)
        if len(ys) == 0:
            return
        y0, y1 = ys.min(), ys.max() + 1
        x0, x1 = xs.min(), xs.max() + 1
        sub = mask[y0:y1, x0:x1].astype(np.float32)[..., None] * (alpha / 255.0)
        col = np.array([c * 255.0 for c in color], np.float32)
        region = self.canvas[y0:y1, x0:x1]
        region *= 1.0 - sub
        region += sub * col

    def _fill_contours(self, contours, color, alpha, clip, rule="nonzero"):
        edges = _contours_to_edges(contours)
        if len(edges) == 0:
            return
        from ...native import fill_edges

        mask = fill_edges(edges, self.w, self.h, rule)
        self._composite(mask, color, alpha, clip)

    # -- interpreter -----------------------------------------------------

    def _run(self, content, resources, state):
        doc = self.doc
        stack = []
        gstack = []
        path = []  # list of device contours (point lists)
        start = None
        cur = None
        pending_clip = None

        # text state (persists across BT/ET per spec for Tf etc.)
        ts = {
            "font": None, "size": 0.0, "char_spacing": 0.0,
            "word_spacing": 0.0, "scale": 100.0, "leading": 0.0,
            "rise": 0.0, "render": 0,
        }
        tm = None
        tlm = None

        p = Parser(content, 0)
        while True:
            p.skip_ws()
            if p.pos >= len(p.data):
                break
            obj = p.parse_object()
            if not isinstance(obj, Keyword):
                stack.append(obj)
                continue
            op = str(obj)

            try:
                if op == "q":
                    gstack.append(state.copy())
                elif op == "Q":
                    if gstack:
                        state = gstack.pop()
                elif op == "cm":
                    m = [float(doc.resolve(v)) for v in stack[-6:]]
                    state.ctm = _mat_mul(tuple(m), state.ctm)
                elif op == "gs":
                    gs_name = stack[-1]
                    egs = doc.resolve(
                        (doc.resolve(resources.get(Name("ExtGState"))) or {}).get(
                            gs_name
                        )
                    )
                    if egs:
                        if Name("ca") in egs:
                            state.alpha = float(doc.resolve(egs[Name("ca")]))
                        if Name("CA") in egs:
                            state.stroke_alpha = float(doc.resolve(egs[Name("CA")]))
                elif op == "w":
                    state.line_width = float(doc.resolve(stack[-1]))

                # ---- color
                elif op == "g":
                    v = float(doc.resolve(stack[-1]))
                    state.fill = (v, v, v)
                    state.fill_is_pattern = False
                elif op == "G":
                    v = float(doc.resolve(stack[-1]))
                    state.stroke = (v, v, v)
                elif op == "rg":
                    state.fill = tuple(float(doc.resolve(v)) for v in stack[-3:])
                    state.fill_is_pattern = False
                elif op == "RG":
                    state.stroke = tuple(float(doc.resolve(v)) for v in stack[-3:])
                elif op == "k":
                    c, m_, y_, k_ = (float(doc.resolve(v)) for v in stack[-4:])
                    state.fill = (
                        (1 - c) * (1 - k_), (1 - m_) * (1 - k_), (1 - y_) * (1 - k_)
                    )
                    state.fill_is_pattern = False
                elif op == "K":
                    c, m_, y_, k_ = (float(doc.resolve(v)) for v in stack[-4:])
                    state.stroke = (
                        (1 - c) * (1 - k_), (1 - m_) * (1 - k_), (1 - y_) * (1 - k_)
                    )
                elif op in ("cs", "CS"):
                    pass
                elif op in ("sc", "scn", "SC", "SCN"):
                    nums = [
                        float(doc.resolve(v))
                        for v in stack
                        if isinstance(doc.resolve(v), (int, float))
                    ]
                    col = (0.5, 0.5, 0.5)
                    if len(nums) >= 4:
                        c, m_, y_, k_ = nums[-4:]
                        col = ((1 - c) * (1 - k_), (1 - m_) * (1 - k_),
                               (1 - y_) * (1 - k_))
                    elif len(nums) == 3:
                        col = tuple(nums)
                    elif len(nums) == 1:
                        col = (nums[0],) * 3
                    # Shading patterns approximate to their average colour.
                    pat_col = None
                    if op in ("scn", "SCN") and stack and isinstance(
                        stack[-1], Name
                    ):
                        pats = doc.resolve(resources.get(Name("Pattern"))) or {}
                        pat = doc.resolve(pats.get(stack[-1]))
                        pd = (
                            pat.dict if isinstance(pat, Stream)
                            else pat if isinstance(pat, dict) else None
                        )
                        ptype = int(
                            doc.resolve((pd or {}).get(Name("PatternType"), 1))
                            or 1
                        )
                        if pd is not None and ptype == 2:
                            pat_col = self._shading_avg_color(
                                doc.resolve(pd.get(Name("Shading")))
                            )
                        elif pd is not None and ptype == 1:
                            pat_col = self._tiling_avg_color(
                                pat,
                                under_color=col if nums else None,
                            )
                    if op in ("sc", "scn"):
                        if pat_col is not None:
                            state.fill = pat_col
                            state.fill_is_pattern = False
                        else:
                            state.fill = col
                            state.fill_is_pattern = len(nums) == 0
                    else:
                        state.stroke = pat_col or col

                # ---- path construction
                elif op == "m":
                    x, y = (float(doc.resolve(v)) for v in stack[-2:])
                    if cur:
                        path.append(cur)
                    start = _apply(state.ctm, x, y)
                    cur = [start]
                elif op == "l":
                    x, y = (float(doc.resolve(v)) for v in stack[-2:])
                    if cur is not None:
                        cur.append(_apply(state.ctm, x, y))
                elif op in ("c", "v", "y"):
                    vals = [float(doc.resolve(v)) for v in stack]
                    if cur is not None:
                        p0 = cur[-1]
                        if op == "c":
                            c1 = _apply(state.ctm, vals[-6], vals[-5])
                            c2 = _apply(state.ctm, vals[-4], vals[-3])
                            p3 = _apply(state.ctm, vals[-2], vals[-1])
                        elif op == "v":
                            c1 = p0
                            c2 = _apply(state.ctm, vals[-4], vals[-3])
                            p3 = _apply(state.ctm, vals[-2], vals[-1])
                        else:
                            c1 = _apply(state.ctm, vals[-4], vals[-3])
                            p3 = _apply(state.ctm, vals[-2], vals[-1])
                            c2 = p3
                        _flatten_cubic(p0, c1, c2, p3, cur)
                elif op == "re":
                    x, y, rw, rh = (float(doc.resolve(v)) for v in stack[-4:])
                    if cur:
                        path.append(cur)
                        cur = None
                    pts = [
                        _apply(state.ctm, x, y),
                        _apply(state.ctm, x + rw, y),
                        _apply(state.ctm, x + rw, y + rh),
                        _apply(state.ctm, x, y + rh),
                    ]
                    path.append(pts)
                elif op == "h":
                    if cur is not None and start is not None:
                        cur.append(start)

                # ---- path painting
                elif op in ("f", "F", "f*", "b", "b*", "B", "B*", "S", "s", "n"):
                    if cur:
                        path.append(cur)
                        cur = None
                    rule = "evenodd" if op.endswith("*") else "nonzero"
                    do_fill = op[0] in ("f", "F", "b", "B")
                    do_stroke = op[0] in ("S", "s", "b", "B")
                    if do_fill and path and not state.fill_is_pattern:
                        self._fill_contours(
                            path, state.fill, state.alpha, state.clip, rule
                        )
                    if do_stroke and path:
                        self._stroke(path, state)
                    if pending_clip is not None and path:
                        self._apply_clip(state, path, pending_clip)
                    pending_clip = None
                    path = []
                    start = None
                elif op in ("W", "W*"):
                    pending_clip = "evenodd" if op == "W*" else "nonzero"

                # ---- text
                elif op == "BT":
                    tm = (1.0, 0.0, 0.0, 1.0, 0.0, 0.0)
                    tlm = tm
                elif op == "ET":
                    tm = tlm = None
                elif op == "Tf":
                    fname = stack[-2]
                    ts["size"] = float(doc.resolve(stack[-1]))
                    fonts = doc.resolve(resources.get(Name("Font"))) or {}
                    fobj = fonts.get(fname)
                    key = id(fobj) if not hasattr(fobj, "num") else (
                        fobj.num, fobj.gen
                    )
                    if key not in self.font_cache:
                        try:
                            self.font_cache[key] = LoadedFont(doc, fobj)
                        except Exception as e:
                            logger.warning(
                                "font %s failed to load (%s); its text "
                                "will not rasterize", fname, e,
                            )
                            self.font_cache[key] = None
                    ts["font"] = self.font_cache[key]
                elif op == "Tc":
                    ts["char_spacing"] = float(doc.resolve(stack[-1]))
                elif op == "Tw":
                    ts["word_spacing"] = float(doc.resolve(stack[-1]))
                elif op == "Tz":
                    ts["scale"] = float(doc.resolve(stack[-1]))
                elif op == "TL":
                    ts["leading"] = float(doc.resolve(stack[-1]))
                elif op == "Ts":
                    ts["rise"] = float(doc.resolve(stack[-1]))
                elif op == "Tr":
                    ts["render"] = int(doc.resolve(stack[-1]))
                elif op in ("Td", "TD"):
                    tx, ty = (float(doc.resolve(v)) for v in stack[-2:])
                    if op == "TD":
                        ts["leading"] = -ty
                    if tlm is not None:
                        tlm = _mat_mul((1, 0, 0, 1, tx, ty), tlm)
                        tm = tlm
                elif op == "Tm":
                    vals = [float(doc.resolve(v)) for v in stack[-6:]]
                    tlm = tuple(vals)
                    tm = tlm
                elif op == "T*":
                    if tlm is not None:
                        tlm = _mat_mul((1, 0, 0, 1, 0, -ts["leading"]), tlm)
                        tm = tlm
                elif op in ("Tj", "'", '"'):
                    if op == '"':
                        ts["word_spacing"] = float(doc.resolve(stack[-3]))
                        ts["char_spacing"] = float(doc.resolve(stack[-2]))
                    if op in ("'", '"') and tlm is not None:
                        tlm = _mat_mul((1, 0, 0, 1, 0, -ts["leading"]), tlm)
                        tm = tlm
                    raw = stack[-1]
                    if isinstance(raw, bytes) and tm is not None:
                        tm = self._show_text(raw, ts, tm, state)
                elif op == "TJ":
                    arr = doc.resolve(stack[-1])
                    if tm is not None and isinstance(arr, list):
                        for item in arr:
                            item = doc.resolve(item)
                            if isinstance(item, bytes):
                                tm = self._show_text(item, ts, tm, state)
                            elif isinstance(item, (int, float)):
                                adj = (
                                    -item / 1000.0 * ts["size"]
                                    * ts["scale"] / 100.0
                                )
                                if ts["font"] and ts["font"].wmode:
                                    tm = _mat_mul((1, 0, 0, 1, 0, -item / 1000.0 * ts["size"]), tm)
                                else:
                                    tm = _mat_mul((1, 0, 0, 1, adj, 0), tm)

                # ---- XObjects & inline images
                elif op == "Do":
                    xname = stack[-1]
                    xo = doc.resolve(
                        (doc.resolve(resources.get(Name("XObject"))) or {}).get(xname)
                    )
                    if isinstance(xo, Stream):
                        sub = str(doc.resolve(xo.dict.get(Name("Subtype"))))
                        if "Image" in sub:
                            self._draw_image(xo, state)
                        elif "Form" in sub:
                            sub_res = doc.resolve(
                                xo.dict.get(Name("Resources"))
                            ) or resources
                            sub_state = state.copy()
                            mtx = doc.resolve(xo.dict.get(Name("Matrix")))
                            if mtx:
                                mtx = tuple(float(doc.resolve(v)) for v in mtx)
                                sub_state.ctm = _mat_mul(mtx, sub_state.ctm)
                            self._run(
                                doc.get_stream_data(xo), sub_res, sub_state
                            )
                elif op == "BI":
                    p = self._skip_inline_image(p)
                elif op in ("sh",):
                    # Paint the clip region with the shading's average colour
                    # (a flat approximation: gradient backgrounds otherwise
                    # render as holes that perturb detection).
                    shs = doc.resolve(resources.get(Name("Shading"))) or {}
                    shd = doc.resolve(shs.get(stack[-1])) if stack else None
                    if shd is not None:
                        col = self._shading_avg_color(shd)
                        if col is not None:
                            self._paint_region(col, state)
            except Exception:
                pass

            if op not in ():
                stack = []

        if cur:
            path.append(cur)

    def _apply_clip(self, state, path, rule):
        from ...native import fill_edges

        edges = _contours_to_edges(path)
        mask = fill_edges(edges, self.w, self.h, rule)
        if state.clip is None:
            state.clip = mask
        else:
            state.clip = (
                state.clip.astype(np.uint16) * mask.astype(np.uint16) // 255
            ).astype(np.uint8)

    def _stroke(self, path, state):
        # device-space line width
        m = state.ctm
        sx = (m[0] ** 2 + m[1] ** 2) ** 0.5
        sy = (m[2] ** 2 + m[3] ** 2) ** 0.5
        lw = max(state.line_width * (sx + sy) / 2.0, 0.75)
        half = lw / 2.0
        quads = []
        for pts in path:
            for a, b in zip(pts[:-1], pts[1:]):
                dx = b[0] - a[0]
                dy = b[1] - a[1]
                ln = (dx * dx + dy * dy) ** 0.5
                if ln < 1e-9:
                    continue
                nx = -dy / ln * half
                ny = dx / ln * half
                quads.append(
                    [
                        (a[0] + nx, a[1] + ny),
                        (b[0] + nx, b[1] + ny),
                        (b[0] - nx, b[1] - ny),
                        (a[0] - nx, a[1] - ny),
                    ]
                )
        if quads:
            self._fill_contours(
                quads, state.stroke, state.stroke_alpha, state.clip, "nonzero"
            )

    # -- text ------------------------------------------------------------

    def _show_text(self, raw, ts, tm, state):
        font = ts["font"]
        if font is None:
            return tm
        size = ts["size"]
        th = ts["scale"] / 100.0
        visible = ts["render"] not in (3, 7)
        upem = font.glyph_upem()

        for code in font.iter_codes(raw):
            w0 = font.width_1000(code) * font.width_to_text
            if visible and font.is_type3:
                self._draw_type3_glyph(font, code, ts, tm, state)
            elif visible:
                gid = font.gid_for(code)
                # glyph units -> text space -> user -> device
                g2t = (
                    size * th / upem, 0.0, 0.0, size / upem,
                    0.0, ts["rise"],
                )
                trm = _mat_mul(g2t, _mat_mul(tm, state.ctm))
                self._draw_glyph(font, gid, trm, state)
            if font.wmode:
                adv = -w0 * size  # vertical: move down
                tm = _mat_mul((1, 0, 0, 1, 0, adv - ts["char_spacing"]), tm)
            else:
                adv = (w0 * size + ts["char_spacing"]) * th
                if code == 32 and not font.two_byte:
                    adv += ts["word_spacing"] * th
                tm = _mat_mul((1, 0, 0, 1, adv, 0), tm)
        return tm

    def _draw_type3_glyph(self, font, code, ts, tm, state):
        """Execute the glyph's CharProc content stream in glyph space:
        FontMatrix x (size scale) x Tm x CTM, with the font's own
        resources.  d0/d1 inside the proc are no-ops here (glyph metrics
        come from /Widths)."""
        proc = font.char_procs.get(code)
        if proc is None:
            return
        size = ts["size"]
        th = ts["scale"] / 100.0
        g2t = (size * th, 0.0, 0.0, size, 0.0, ts["rise"])
        sub_state = state.copy()
        sub_state.ctm = _mat_mul(
            font.font_matrix, _mat_mul(g2t, _mat_mul(tm, state.ctm))
        )
        resources = font.t3_resources
        if resources is None:
            resources = {}
        try:
            self._run(self.doc.get_stream_data(proc), resources, sub_state)
        except Exception as e:
            logger.warning("Type3 glyph proc failed: %s", e)

    def _draw_glyph(self, font, gid, trm, state):
        # cache on quantized matrix
        key = (
            id(font), gid,
            round(trm[0], 3), round(trm[1], 3),
            round(trm[2], 3), round(trm[3], 3),
            round(trm[4] % 1.0, 1), round(trm[5] % 1.0, 1),
        )
        cached = self.glyph_cache.get(key)
        if cached is None:
            pathd = font.glyph_path(gid)
            if not pathd:
                self.glyph_cache[key] = (None, 0, 0)
                return
            # render at origin-relative transform
            m0 = (trm[0], trm[1], trm[2], trm[3], trm[4] % 1.0, trm[5] % 1.0)
            contours = _path_to_device_contours(pathd, m0, tol=0.1)
            allpts = [pt for c in contours for pt in c]
            if not allpts:
                self.glyph_cache[key] = (None, 0, 0)
                return
            xs = [p[0] for p in allpts]
            ys = [p[1] for p in allpts]
            gx0 = int(np.floor(min(xs)))
            gy0 = int(np.floor(min(ys)))
            gw = int(np.ceil(max(xs))) - gx0 + 1
            gh = int(np.ceil(max(ys))) - gy0 + 1
            if gw <= 0 or gh <= 0 or gw > 4000 or gh > 4000:
                self.glyph_cache[key] = (None, 0, 0)
                return
            shifted = [
                [(px - gx0, py - gy0) for (px, py) in c] for c in contours
            ]
            from ...native import fill_edges

            mask = fill_edges(_contours_to_edges(shifted), gw, gh)
            cached = (mask, gx0, gy0)
            if len(self.glyph_cache) < 20000:
                self.glyph_cache[key] = cached
        mask, gx0, gy0 = cached
        if mask is None:
            return
        ox = int(np.floor(trm[4])) + gx0
        oy = int(np.floor(trm[5])) + gy0
        self._blit(mask, ox, oy, state.fill, state.alpha, state.clip)

    def _blit(self, mask, ox, oy, color, alpha, clip):
        h, w = mask.shape
        x0 = max(ox, 0)
        y0 = max(oy, 0)
        x1 = min(ox + w, self.w)
        y1 = min(oy + h, self.h)
        if x0 >= x1 or y0 >= y1:
            return
        sub = mask[y0 - oy : y1 - oy, x0 - ox : x1 - ox].astype(np.float32)
        if clip is not None:
            sub = sub * (clip[y0:y1, x0:x1].astype(np.float32) / 255.0)
        sub = sub[..., None] * (alpha / 255.0)
        col = np.array([c * 255.0 for c in color], np.float32)
        region = self.canvas[y0:y1, x0:x1]
        region *= 1.0 - sub
        region += sub * col

    # -- shadings ---------------------------------------------------------

    def _eval_function(self, fn, t):
        """Evaluate a PDF function at scalar t -> list of outputs, or None.

        Supports types 2 (exponential), 3 (stitching) and 0 (sampled; the
        table average, which is exact for our flat-colour approximation)."""
        doc = self.doc
        d = fn.dict if isinstance(fn, Stream) else fn
        if not isinstance(d, dict):
            return None
        ftype = int(doc.resolve(d.get(Name("FunctionType"), -1)) or -1)
        dom = doc.resolve(d.get(Name("Domain"))) or [0.0, 1.0]
        d0, d1 = float(doc.resolve(dom[0])), float(doc.resolve(dom[1]))
        t = min(max(t, d0), d1)
        if ftype == 2:
            c0 = doc.resolve(d.get(Name("C0"))) or [0.0]
            c1 = doc.resolve(d.get(Name("C1"))) or [1.0]
            n = float(doc.resolve(d.get(Name("N"), 1)) or 1)
            s = (t - d0) / ((d1 - d0) or 1.0)
            return [
                float(doc.resolve(a)) + s**n * (
                    float(doc.resolve(b)) - float(doc.resolve(a))
                )
                for a, b in zip(c0, c1)
            ]
        if ftype == 3:
            fns = doc.resolve(d.get(Name("Functions"))) or []
            bounds = [
                float(doc.resolve(v))
                for v in doc.resolve(d.get(Name("Bounds"))) or []
            ]
            enc = [
                float(doc.resolve(v))
                for v in doc.resolve(d.get(Name("Encode"))) or []
            ]
            lo = d0
            for i, f in enumerate(fns):
                hi = bounds[i] if i < len(bounds) else d1
                if t < hi or i == len(fns) - 1:
                    e0, e1 = (
                        (enc[2 * i], enc[2 * i + 1])
                        if len(enc) >= 2 * i + 2
                        else (0.0, 1.0)
                    )
                    s = (t - lo) / ((hi - lo) or 1.0)
                    return self._eval_function(doc.resolve(f), e0 + s * (e1 - e0))
                lo = hi
            return None
        if ftype == 0 and isinstance(fn, Stream):
            data = doc.get_stream_data(fn)
            bps = int(doc.resolve(d.get(Name("BitsPerSample"), 8)) or 8)
            rng = [
                float(doc.resolve(v))
                for v in doc.resolve(d.get(Name("Range"))) or []
            ]
            nout = max(len(rng) // 2, 1)
            if bps == 8:
                arr = np.frombuffer(data, np.uint8).astype(np.float32) / 255.0
            elif bps == 16:
                arr = np.frombuffer(data, ">u2").astype(np.float32) / 65535.0
            else:
                return None
            if len(arr) < nout:
                return None
            arr = arr[: (len(arr) // nout) * nout].reshape(-1, nout)
            mean = arr.mean(axis=0)
            if rng:
                return [
                    rng[2 * i] + float(m) * (rng[2 * i + 1] - rng[2 * i])
                    for i, m in enumerate(mean)
                ]
            return [float(m) for m in mean]
        return None

    def _shading_avg_color(self, shd):
        """Average RGB colour of a shading (axial/radial/any with /Function).

        The reference renders true gradients via pdfium; for document AI a
        flat average-colour fill preserves detection behaviour (no holes)."""
        doc = self.doc
        d = shd.dict if isinstance(shd, Stream) else shd
        if not isinstance(d, dict):
            return None
        fn = doc.resolve(d.get(Name("Function")))
        comps = None
        if fn is not None:
            fns = fn if isinstance(fn, list) else [fn]
            samples = []
            for t in (0.0, 0.25, 0.5, 0.75, 1.0):
                if len(fns) == 1:
                    out = self._eval_function(doc.resolve(fns[0]), t)
                else:  # one scalar function per colour component
                    outs = [
                        self._eval_function(doc.resolve(f), t) for f in fns
                    ]
                    out = [o[0] for o in outs] if all(outs) else None
                if out:
                    samples.append(out)
            if samples:
                comps = [sum(c) / len(samples) for c in zip(*samples)]
        if comps is None:
            comps = [0.5]
        if len(comps) >= 4:
            c, m_, y_, k_ = comps[:4]
            rgb = ((1 - c) * (1 - k_), (1 - m_) * (1 - k_), (1 - y_) * (1 - k_))
        elif len(comps) == 3:
            rgb = tuple(comps)
        else:
            rgb = (comps[0],) * 3
        return tuple(min(max(float(v), 0.0), 1.0) for v in rgb)

    def _tiling_avg_color(self, pat, under_color=None):
        """Average RGB colour of a tiling pattern (PatternType 1) cell.

        The cell content stream is rendered once at low resolution on a
        white background and averaged — the same flat approximation used
        for shadings (the reference renders true tiles via pdfium; for
        document AI a flat fill preserves detection behaviour).  For
        uncoloured patterns (PaintType 2) the cell paints in black and
        ``under_color`` is applied at the cell's ink coverage."""
        doc = self.doc
        if not isinstance(pat, Stream):
            return None
        d = pat.dict
        cache = getattr(self, "_tile_avg_cache", None)
        if cache is None:
            cache = self._tile_avg_cache = {}
        key = (id(pat), under_color)
        if key in cache:
            return cache[key][1]
        col = None
        try:
            bbox = [
                float(doc.resolve(v))
                for v in doc.resolve(d.get(Name("BBox")))
            ]
            bx0, by0 = min(bbox[0], bbox[2]), min(bbox[1], bbox[3])
            bw = max(abs(bbox[2] - bbox[0]), 1e-6)
            bh = max(abs(bbox[3] - bbox[1]), 1e-6)
            tw = int(min(max(round(bw), 2), 48))
            th = int(min(max(round(bh), 2), 48))
            sub = PageRenderer(doc, dpi=72)
            sub.w, sub.h = tw, th
            sub.canvas = np.full((th, tw, 3), 255.0, np.float32)
            sx, sy = tw / bw, th / bh
            base = (sx, 0.0, 0.0, -sy, -bx0 * sx, (by0 + bh) * sy)
            res = doc.resolve(d.get(Name("Resources"))) or {}
            sub._run(doc.get_stream_data(pat), res, _GState(base, None))
            mean = sub.canvas.reshape(-1, 3).mean(axis=0) / 255.0
            paint_type = int(doc.resolve(d.get(Name("PaintType"), 1)) or 1)
            if paint_type == 2 and under_color is not None:
                # stencil: cell ink coverage colours with the current fill
                cov = min(max(1.0 - float(mean.mean()), 0.0), 1.0)
                col = tuple(
                    1.0 - cov + cov * min(max(float(c), 0.0), 1.0)
                    for c in under_color
                )
            else:
                col = tuple(min(max(float(v), 0.0), 1.0) for v in mean)
        except Exception:
            col = None
        # retain pat in the value: id()-keyed caches must keep the object
        # alive or a GC'd pattern's id can be reused and return a stale color
        cache[key] = (pat, col)
        return col

    def _paint_region(self, color, state):
        """Flat-fill the current clip region (whole page when unclipped)."""
        if state.clip is None:
            a = np.float32(state.alpha)
        else:
            a = state.clip.astype(np.float32)[..., None] / 255.0 * state.alpha
        col = np.array([c * 255.0 for c in color], np.float32)
        self.canvas *= 1.0 - a
        self.canvas += a * col

    # -- images ----------------------------------------------------------

    def _filter_parms(self, d, fname):
        """DecodeParms dict for the given filter name (str keys, resolved)."""
        doc = self.doc
        filters = doc.resolve(d.get(Name("Filter")))
        parms = doc.resolve(d.get(Name("DecodeParms")))
        if parms is None:
            parms = doc.resolve(d.get(Name("DP")))
        if isinstance(filters, list) and isinstance(parms, list):
            for f, p in zip(filters, parms):
                if str(doc.resolve(f)) == fname:
                    parms = doc.resolve(p)
                    break
            else:
                parms = None
        if not isinstance(parms, dict):
            return {}
        return {str(k): doc.resolve(v) for k, v in parms.items()}

    def _decode_ccitt(self, data, d, fname, w, h):
        """CCITTFax image data -> (h, w) uint8 sample bits (PDF 1-bpc
        semantics: 0 = black unless BlackIs1), via the native G3/G4 decoder
        (csrc/ccitt.cpp).  The reference handles these scans through
        pdfium."""
        from ...native import ccitt_decode

        parms = self._filter_parms(d, fname)
        k = int(parms.get("K", 0) or 0)
        columns = int(parms.get("Columns", 1728) or 1728)
        rows = int(parms.get("Rows", 0) or 0) or h
        byte_align = bool(parms.get("EncodedByteAlign", False))
        black_is_1 = bool(parms.get("BlackIs1", False))
        try:
            black = ccitt_decode(data, columns, rows, k=k, byte_align=byte_align)
        except Exception:
            logger.warning("CCITT fax decode failed; region left blank")
            return None
        bits = black if black_is_1 else 1 - black
        # Conform to the declared Width/Height: crop, pad with white.
        white = 1 - int(black_is_1)
        out = np.full((h, w), white, np.uint8)
        ch, cw = min(h, bits.shape[0]), min(w, bits.shape[1])
        out[:ch, :cw] = bits[:ch, :cw]
        return out

    def _decode_image(self, xo):
        doc = self.doc
        d = xo.dict
        w = int(doc.resolve(d.get(Name("Width"))))
        h = int(doc.resolve(d.get(Name("Height"))))
        filters = doc.resolve(d.get(Name("Filter")))
        if isinstance(filters, Name):
            filters = [filters]
        filters = [str(doc.resolve(f)) for f in (filters or [])]
        bpc = int(doc.resolve(d.get(Name("BitsPerComponent"), 8)) or 8)
        cs = doc.resolve(d.get(Name("ColorSpace")))
        mask_flag = bool(doc.resolve(d.get(Name("ImageMask"), False)))

        if "DCTDecode" in filters or "DCT" in filters or "JPXDecode" in filters:
            arr = np.frombuffer(xo.raw, np.uint8)
            img = cv2.imdecode(arr, cv2.IMREAD_UNCHANGED)
            if img is None:
                # Some cv2 builds lack JPEG2000; fall back to PIL/openjpeg.
                try:
                    import io

                    from PIL import Image

                    pimg = Image.open(io.BytesIO(xo.raw))
                    img = np.asarray(pimg.convert("RGB"))[:, :, ::-1]  # to BGR
                except Exception:
                    logger.warning(
                        "undecodable DCT/JPX image stream (%s); region left blank",
                        "+".join(filters),
                    )
                    return None, None
            if img.ndim == 2:
                img = np.stack([img] * 3, -1)
            elif img.shape[2] == 4:  # assume CMYK-ish from Adobe jpeg
                c, m_, y_, k_ = [img[..., i].astype(np.float32) / 255.0 for i in range(4)]
                r = (1 - c) * (1 - k_)
                g = (1 - m_) * (1 - k_)
                b = (1 - y_) * (1 - k_)
                img = (np.stack([b, g, r], -1) * 255).astype(np.uint8)
            else:
                pass  # BGR from imdecode
            return img[:, :, ::-1], None  # to RGB

        if "JBIG2Decode" in filters:
            # From-scratch decoder in csrc/jbig2.cpp (the reference decodes
            # these via pdfium).  The lone unsupported sub-feature (halftone
            # regions) fails loudly and leaves the region blank.
            from ...native import jbig2_decode

            parms = self._filter_parms(d, "JBIG2Decode")
            gobj = doc.resolve(parms.get("JBIG2Globals"))
            gdata = b""
            if isinstance(gobj, Stream):
                gdata = doc.get_stream_data(gobj)
            elif isinstance(gobj, bytes):
                gdata = gobj
            try:
                black = jbig2_decode(xo.raw, w, h, globals_data=gdata)
            except Exception as e:
                logger.warning(
                    "JBIG2 image decode failed (%s); region left blank", e
                )
                return None, None
            # The JBIG2Decode filter delivers 1 = black; PDF 1-bpc gray
            # samples are 0 = black, so invert into sample space.
            bits = (1 - black).astype(np.uint8)
            if mask_flag:
                decode = doc.resolve(d.get(Name("Decode")))
                if decode and float(doc.resolve(decode[0])) == 1:
                    bits = 1 - bits
                return None, (1 - bits).astype(np.uint8) * 255
            img = np.repeat((bits * 255)[..., None], 3, axis=2)
            return img, None

        data = decode_stream(xo.raw, d, doc.resolve)

        ccitt = next((f for f in filters if f in ("CCITTFaxDecode", "CCF")), None)
        if ccitt is not None:
            bits = self._decode_ccitt(data, d, ccitt, w, h)
            if bits is None:
                return None, None
            if mask_flag:
                decode = doc.resolve(d.get(Name("Decode")))
                if decode and float(doc.resolve(decode[0])) == 1:
                    bits = 1 - bits
                return None, (1 - bits).astype(np.uint8) * 255
            img = np.repeat((bits * 255).astype(np.uint8)[..., None], 3, axis=2)
            return img, None

        unhandled = [f for f in filters if f in _ENCODED_IMAGE_FILTERS]
        if unhandled:
            # Guard: data is still filter-encoded here; reshaping it as raw
            # pixels would feed garbage imagery to OCR.
            logger.warning(
                "unsupported image filter(s) %s; region left blank", unhandled
            )
            return None, None

        if mask_flag:
            # stencil: 1 bpc, 1 = background (unless Decode [1 0])
            row_bytes = (w + 7) // 8
            bits = np.unpackbits(
                np.frombuffer(data[: row_bytes * h], np.uint8).reshape(h, row_bytes),
                axis=1,
            )[:, :w]
            decode = doc.resolve(d.get(Name("Decode")))
            if decode and float(doc.resolve(decode[0])) == 1:
                bits = 1 - bits
            return None, (1 - bits).astype(np.uint8) * 255  # coverage where 0

        # resolve colorspace to n components
        ncomp = 1
        indexed = None
        csname = ""
        if isinstance(cs, list):
            csname = str(doc.resolve(cs[0]))
            if "ICCBased" in csname:
                icc = doc.resolve(cs[1])
                ncomp = int(doc.resolve(icc.dict.get(Name("N"), 3)))
            elif "Indexed" in csname:
                base = doc.resolve(cs[1])
                lookup = doc.resolve(cs[3])
                if isinstance(lookup, Stream):
                    lookup = doc.get_stream_data(lookup)
                elif isinstance(lookup, bytes):
                    pass
                base_n = 3
                if isinstance(base, list) and "ICCBased" in str(doc.resolve(base[0])):
                    base_n = int(doc.resolve(doc.resolve(base[1]).dict.get(Name("N"), 3)))
                elif "Gray" in str(base):
                    base_n = 1
                elif "CMYK" in str(base):
                    base_n = 4
                indexed = (np.frombuffer(lookup, np.uint8), base_n)
                ncomp = 1
            elif "Separation" in csname or "DeviceN" in csname:
                ncomp = 1
        else:
            csname = str(cs)
            if "RGB" in csname:
                ncomp = 3
            elif "CMYK" in csname:
                ncomp = 4
            else:
                ncomp = 1

        if bpc == 8:
            arr = np.frombuffer(data[: w * h * ncomp], np.uint8)
            if len(arr) < w * h * ncomp:
                arr = np.pad(arr, (0, w * h * ncomp - len(arr)))
            img = arr.reshape(h, w, ncomp)
        elif bpc == 1:
            row_bytes = (w * ncomp + 7) // 8
            bits = np.unpackbits(
                np.frombuffer(data[: row_bytes * h], np.uint8).reshape(h, row_bytes),
                axis=1,
            )[:, : w * ncomp]
            img = (bits.reshape(h, w, ncomp) * 255).astype(np.uint8)
        elif bpc == 4:
            row_bytes = (w * ncomp + 1) // 2
            raw = np.frombuffer(data[: row_bytes * h], np.uint8).reshape(h, row_bytes)
            hi = raw >> 4
            lo = raw & 0xF
            inter = np.empty((h, row_bytes * 2), np.uint8)
            inter[:, 0::2] = hi
            inter[:, 1::2] = lo
            img = (inter[:, : w * ncomp].reshape(h, w, ncomp) * 17).astype(np.uint8)
        else:
            return None, None

        if indexed is not None:
            lut, base_n = indexed
            idx = img[..., 0].astype(np.int32) * base_n
            idx = np.clip(idx, 0, max(len(lut) - base_n, 0))
            chans = [lut[np.clip(idx + k, 0, len(lut) - 1)] for k in range(base_n)]
            img = np.stack(chans, -1)
            ncomp = base_n

        if ncomp == 1:
            img = np.repeat(img, 3, axis=2) if img.shape[2] == 1 else img
        elif ncomp == 4:
            c, m_, y_, k_ = [img[..., i].astype(np.float32) / 255.0 for i in range(4)]
            img = (
                np.stack([(1 - c) * (1 - k_), (1 - m_) * (1 - k_), (1 - y_) * (1 - k_)], -1)
                * 255
            ).astype(np.uint8)
        return img[:, :, :3], None

    def _draw_image(self, xo, state):
        doc = self.doc
        try:
            img, stencil = self._decode_image(xo)
        except Exception:
            return
        m = state.ctm

        if stencil is not None:
            src_h, src_w = stencil.shape
        elif img is not None:
            src_h, src_w = img.shape[:2]
        else:
            return

        # unit square -> device affine
        p00 = _apply(m, 0, 1)  # image top-left maps to (0, 1) in unit space
        p10 = _apply(m, 1, 1)
        p01 = _apply(m, 0, 0)
        src = np.float32([[0, 0], [src_w, 0], [0, src_h]])
        dst = np.float32([p00, p10, p01])
        xs = [p00[0], p10[0], p01[0], _apply(m, 1, 0)[0]]
        ys = [p00[1], p10[1], p01[1], _apply(m, 1, 0)[1]]
        x0 = max(int(np.floor(min(xs))), 0)
        y0 = max(int(np.floor(min(ys))), 0)
        x1 = min(int(np.ceil(max(xs))), self.w)
        y1 = min(int(np.ceil(max(ys))), self.h)
        if x0 >= x1 or y0 >= y1:
            return
        M = cv2.getAffineTransform(src, dst)

        # alpha channel: SMask or full
        alpha = np.full((src_h, src_w), 255, np.uint8)
        smask = doc.resolve(xo.dict.get(Name("SMask")))
        if isinstance(smask, Stream):
            try:
                simg, _ = self._decode_image(smask)
                if simg is not None:
                    alpha = simg[..., 0]
                    if alpha.shape != (src_h, src_w):
                        alpha = cv2.resize(alpha, (src_w, src_h))
            except Exception:
                pass

        if stencil is not None:
            warped_a = cv2.warpAffine(
                stencil, M, (self.w, self.h), flags=cv2.INTER_LINEAR
            )
            self._composite(warped_a, state.fill, state.alpha, state.clip)
            return

        warped = cv2.warpAffine(
            img, M, (self.w, self.h), flags=cv2.INTER_AREA
            if (x1 - x0) < src_w
            else cv2.INTER_LINEAR,
        )
        warped_a = cv2.warpAffine(alpha, M, (self.w, self.h))
        region_mask = np.zeros((self.h, self.w), np.uint8)
        region_mask[y0:y1, x0:x1] = 255
        warped_a = (
            warped_a.astype(np.uint16) * region_mask.astype(np.uint16) // 255
        ).astype(np.uint8)
        if state.clip is not None:
            warped_a = (
                warped_a.astype(np.uint16) * state.clip.astype(np.uint16) // 255
            ).astype(np.uint8)
        a = warped_a.astype(np.float32)[..., None] / 255.0 * state.alpha
        self.canvas *= 1.0 - a
        self.canvas += a * warped.astype(np.float32)

    def _skip_inline_image(self, p):
        # BI <dict> ID <data> EI — find EI delimiter
        data = p.data
        idx = data.find(b"EI", p.pos)
        while idx != -1:
            nxt = data[idx + 2 : idx + 3]
            if not nxt or not nxt.isalnum():
                break
            idx = data.find(b"EI", idx + 2)
        p.pos = (idx + 2) if idx != -1 else len(data)
        return p


def render_page(doc, index, dpi=200):
    page = doc.get_page(index)
    return PageRenderer(doc, dpi=dpi).render(page)
