"""Japanese text width conversion (jaconv replacement; the port's copy of
yomitoku_tpu/utils/jp_text.py).

The reference uses ``jaconv.h2z(kana=True, ascii=True, digit=True)`` for
vertical text in searchable PDFs (utils/searchable_pdf.py:59-70); this is a
self-contained half-width -> full-width converter with the same scope.
"""

# half-width katakana (U+FF61..FF9F) -> full-width
_HW_KATA = (
    "。「」、・ヲァィゥェォャュョッーアイウエオカキクケコサシスセソタチツテト"
    "ナニヌネノハヒフヘホマミムメモヤユヨラリルレロワン゛゜"
)
_VOICED = {
    "カ": "ガ", "キ": "ギ", "ク": "グ", "ケ": "ゲ", "コ": "ゴ",
    "サ": "ザ", "シ": "ジ", "ス": "ズ", "セ": "ゼ", "ソ": "ゾ",
    "タ": "ダ", "チ": "ヂ", "ツ": "ヅ", "テ": "デ", "ト": "ド",
    "ハ": "バ", "ヒ": "ビ", "フ": "ブ", "ヘ": "ベ", "ホ": "ボ",
    "ウ": "ヴ",
}
_SEMI_VOICED = {"ハ": "パ", "ヒ": "ピ", "フ": "プ", "ヘ": "ペ", "ホ": "ポ"}


def h2z(text: str, kana=True, ascii=True, digit=True) -> str:
    out = []
    for ch in text:
        o = ord(ch)
        if ascii and ch == " ":
            out.append("　")
        elif (ascii or digit) and 0x21 <= o <= 0x7E:
            if digit and not ascii and not ch.isdigit():
                out.append(ch)
            else:
                out.append(chr(o - 0x21 + 0xFF01))
        elif kana and 0xFF61 <= o <= 0xFF9F:
            full = _HW_KATA[o - 0xFF61]
            if full == "゛" and out and out[-1] in _VOICED:
                out[-1] = _VOICED[out[-1]]
            elif full == "゜" and out and out[-1] in _SEMI_VOICED:
                out[-1] = _SEMI_VOICED[out[-1]]
            else:
                out.append(full)
        else:
            out.append(ch)
    return "".join(out)


def z2h(text: str, digit=True, ascii=True, kana=False) -> str:
    """Full-width -> half-width (digits/ascii; kana optional, unused by
    the extractor rules)."""
    out = []
    for ch in text:
        o = ord(ch)
        if 0xFF01 <= o <= 0xFF5E:
            half = chr(o - 0xFF01 + 0x21)
            if (digit and half.isdigit()) or (
                ascii and not half.isdigit()
            ):
                out.append(half)
                continue
        if ascii and ch == "　":
            out.append(" ")
            continue
        out.append(ch)
    return "".join(out)


def kata2hira(text: str) -> str:
    return "".join(
        chr(ord(c) - 0x60) if 0x30A1 <= ord(c) <= 0x30F6 else c for c in text
    )


def hira2kata(text: str) -> str:
    return "".join(
        chr(ord(c) + 0x60) if 0x3041 <= ord(c) <= 0x3096 else c for c in text
    )


_FW_MAP = str.maketrans({"¥": "￥", "·": "・", " ": "　"})


def to_full_width(text: str) -> str:
    """Reference utils/searchable_pdf.py:59."""
    return h2z(text, kana=True, ascii=True, digit=True).translate(_FW_MAP)
