"""Text normalizer registry for extracted field values.

Reference parity: yomitoku/extractor/normalizer.py — decorator registry of
rules: strip_spaces, numeric, phone_jp, postal_code_jp, date_jp /
date_yyyymmdd (kanji/abbreviated era -> ISO), time_jp / time_hms,
alphanumeric, hiragana, katakana.  jaconv is replaced by utils.jp_text.

The port's copy of ``yomitoku_tpu/extractor/normalizer.py``, line for line.
"""

import re
from typing import Callable, Dict, Optional

from ..utils.jp_text import hira2kata, kata2hira, z2h

_REGISTRY: Dict[str, Callable[[str], str]] = {}


def register(name: str):
    def decorator(fn: Callable[[str], str]):
        _REGISTRY[name] = fn
        return fn

    return decorator


def get_normalizer(name: str) -> Optional[Callable[[str], str]]:
    return _REGISTRY.get(name)


def apply_normalize(text, rule: Optional[str]) -> str:
    if rule is None:
        return text if isinstance(text, str) else str(text)
    if not isinstance(text, str):
        text = str(text)
    fn = get_normalizer(rule)
    return fn(text) if fn else text


@register("strip_spaces")
def strip_spaces(text: str) -> str:
    return re.sub(r"[\s　]+", "", text)


@register("numeric")
def numeric(text: str) -> str:
    text = z2h(text, digit=True, ascii=True, kana=False)
    text = text.replace(",", "").replace("、", "")
    return re.sub(r"[^\d.\-+]", "", text)


@register("phone_jp")
def phone_jp(text: str) -> str:
    digits = re.sub(r"[^\d]", "", z2h(text, digit=True, ascii=True))
    if len(digits) == 11:
        return f"{digits[:3]}-{digits[3:7]}-{digits[7:]}"
    if len(digits) == 10:
        return f"{digits[:3]}-{digits[3:6]}-{digits[6:]}"
    return digits


@register("postal_code_jp")
def postal_code_jp(text: str) -> str:
    digits = re.sub(r"[^\d]", "", z2h(text, digit=True, ascii=True))
    if len(digits) == 7:
        return f"{digits[:3]}-{digits[3:]}"
    return digits


_ERA_KANJI_MAP = {"令和": 2018, "平成": 1988, "昭和": 1925, "大正": 1911, "明治": 1867}
_ERA_ABBREV_MAP = {"R": 2018, "H": 1988, "S": 1925, "T": 1911, "M": 1867}


def _parse_date(text: str):
    text = z2h(text, digit=True, ascii=True, kana=False)
    for era, offset in _ERA_KANJI_MAP.items():
        m = re.search(rf"{era}\s*(\d+)\s*年\s*(\d+)\s*月\s*(\d+)\s*日", text)
        if m:
            return offset + int(m.group(1)), int(m.group(2)), int(m.group(3))
    m = re.search(
        r"([RHSTM])\s*(\d{1,2})\s*[/\-\.]\s*(\d{1,2})\s*[/\-\.]\s*(\d{1,2})", text
    )
    if m:
        offset = _ERA_ABBREV_MAP.get(m.group(1))
        if offset:
            return offset + int(m.group(2)), int(m.group(3)), int(m.group(4))
    m = re.search(
        r"([RHSTM])\s*(\d{1,2})\s*年\s*(\d{1,2})\s*月\s*(\d{1,2})\s*日", text
    )
    if m:
        offset = _ERA_ABBREV_MAP.get(m.group(1))
        if offset:
            return offset + int(m.group(2)), int(m.group(3)), int(m.group(4))
    m = re.search(r"(\d{4})\s*年\s*(\d{1,2})\s*月\s*(\d{1,2})\s*日", text)
    if m:
        return int(m.group(1)), int(m.group(2)), int(m.group(3))
    m = re.search(r"(\d{4})[/\-](\d{1,2})[/\-](\d{1,2})", text)
    if m:
        return int(m.group(1)), int(m.group(2)), int(m.group(3))
    return None


@register("date_jp")
def date_jp(text: str) -> str:
    result = _parse_date(text)
    if result:
        return "{:04d}-{:02d}-{:02d}".format(*result)
    return text


@register("date_yyyymmdd")
def date_yyyymmdd(text: str) -> str:
    result = _parse_date(text)
    if result:
        return "{:04d}{:02d}{:02d}".format(*result)
    return text


@register("time_jp")
def time_jp(text: str) -> str:
    text = z2h(text, digit=True, ascii=True, kana=False)
    m = re.search(r"(\d{1,2})\s*時\s*(\d{1,2})\s*分\s*(\d{1,2})\s*秒", text)
    if m:
        return f"{int(m.group(1))}時{int(m.group(2)):02d}分{int(m.group(3)):02d}秒"
    m = re.search(r"(\d{1,2})\s*時\s*(\d{1,2})\s*分", text)
    if m:
        return f"{int(m.group(1))}時{int(m.group(2)):02d}分"
    m = re.search(r"(\d{1,2})\s*:\s*(\d{1,2})\s*:\s*(\d{1,2})", text)
    if m:
        return f"{int(m.group(1))}時{int(m.group(2)):02d}分{int(m.group(3)):02d}秒"
    m = re.search(r"(\d{1,2})\s*:\s*(\d{1,2})", text)
    if m:
        return f"{int(m.group(1))}時{int(m.group(2)):02d}分"
    return text


@register("time_hms")
def time_hms(text: str) -> str:
    text = z2h(text, digit=True, ascii=True, kana=False)
    m = re.search(r"(\d{1,2})\s*時\s*(\d{1,2})\s*分\s*(\d{1,2})\s*秒", text)
    if m:
        return f"{int(m.group(1)):02d}:{int(m.group(2)):02d}:{int(m.group(3)):02d}"
    m = re.search(r"(\d{1,2})\s*時\s*(\d{1,2})\s*分", text)
    if m:
        return f"{int(m.group(1)):02d}:{int(m.group(2)):02d}:00"
    m = re.search(r"(\d{1,2})\s*:\s*(\d{1,2})\s*:\s*(\d{1,2})", text)
    if m:
        return f"{int(m.group(1)):02d}:{int(m.group(2)):02d}:{int(m.group(3)):02d}"
    m = re.search(r"(\d{1,2})\s*:\s*(\d{1,2})", text)
    if m:
        return f"{int(m.group(1)):02d}:{int(m.group(2)):02d}:00"
    return text


@register("alphanumeric")
def alphanumeric(text: str) -> str:
    text = z2h(text, digit=True, ascii=True, kana=False)
    return re.sub(r"[^a-zA-Z0-9]", "", text)


@register("hiragana")
def hiragana(text: str) -> str:
    return re.sub(r"[^぀-ゟ]", "", kata2hira(text))


@register("katakana")
def katakana(text: str) -> str:
    return re.sub(r"[^゠-ヿ]", "", hira2kata(text))
