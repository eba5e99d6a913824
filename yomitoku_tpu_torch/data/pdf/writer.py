"""Minimal PDF writer (objects + streams + xref) for searchable-PDF export.

Replaces the reference's reportlab canvas (utils/searchable_pdf.py:74):
just enough of the spec to emit JPEG page images and an embedded
CIDFontType2 (TrueType, Identity-H) text layer with a ToUnicode CMap.
"""

import zlib


class PdfWriter:
    def __init__(self):
        self.objects = [None]  # 1-indexed

    def add(self, obj) -> int:
        self.objects.append(obj)
        return len(self.objects) - 1

    def set(self, num, obj):
        self.objects[num] = obj

    @staticmethod
    def ref(num):
        return f"{num} 0 R"

    @staticmethod
    def serialize(obj):
        if isinstance(obj, dict):
            items = " ".join(
                f"/{k} {PdfWriter.serialize(v)}" for k, v in obj.items()
            )
            return f"<< {items} >>"
        if isinstance(obj, list):
            return "[" + " ".join(PdfWriter.serialize(v) for v in obj) + "]"
        if isinstance(obj, bool):
            return "true" if obj else "false"
        if isinstance(obj, bytes):
            return "<" + obj.hex() + ">"
        if isinstance(obj, float):
            return f"{obj:.4f}".rstrip("0").rstrip(".")
        return str(obj)

    def stream(self, d: dict, data: bytes, compress=True) -> int:
        if compress:
            data = zlib.compress(data)
            d = dict(d)
            d["Filter"] = "/FlateDecode"
        d["Length"] = len(data)
        return self.add(("stream", d, data))

    def tobytes(self, root_num: int) -> bytes:
        out = bytearray(b"%PDF-1.7\n%\xe2\xe3\xcf\xd3\n")
        offsets = [0] * len(self.objects)
        for num in range(1, len(self.objects)):
            offsets[num] = len(out)
            obj = self.objects[num]
            out += f"{num} 0 obj\n".encode()
            if isinstance(obj, tuple) and obj[0] == "stream":
                _, d, data = obj
                out += self.serialize(d).encode("latin-1")
                out += b"\nstream\n" + data + b"\nendstream"
            else:
                out += self.serialize(obj).encode("latin-1")
            out += b"\nendobj\n"
        xref_off = len(out)
        n = len(self.objects)
        out += f"xref\n0 {n}\n".encode()
        out += b"0000000000 65535 f \n"
        for num in range(1, n):
            out += f"{offsets[num]:010d} 00000 n \n".encode()
        out += (
            f"trailer\n<< /Size {n} /Root {root_num} 0 R >>\n"
            f"startxref\n{xref_off}\n%%EOF\n"
        ).encode()
        return bytes(out)
