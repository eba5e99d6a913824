"""PDF document layer: xref resolution, object loading, page tree.

Handles classic xref tables, cross-reference streams (PDF 1.5+), object
streams, hybrid files, and incremental updates (/Prev chains).  Falls back
to a full-file scan of ``N G obj`` markers for damaged xrefs.
"""

import re
from pathlib import Path

from .cos import Keyword, Name, Parser, Ref, Stream
from .filters import decode_stream


class PdfError(ValueError):
    pass


class PdfDocument:
    def __init__(self, path_or_bytes):
        if isinstance(path_or_bytes, (str, Path)):
            self.data = Path(path_or_bytes).read_bytes()
        else:
            self.data = bytes(path_or_bytes)
        if b"%PDF-" not in self.data[:1024]:
            raise PdfError("Not a PDF file")
        # offset of %PDF header (files may have junk before it)
        self._base = self.data.find(b"%PDF-")
        self.xref = {}  # objnum -> ("f",) | ("n", offset) | ("s", objstm, idx)
        self.trailer = {}
        self._cache = {}
        self._objstm_cache = {}
        try:
            self._load_xref()
        except Exception:
            self.xref = {}
        if not self.xref or Name("Root") not in self.trailer:
            self._scan_all_objects()
        if Name("Root") not in self.trailer:
            raise PdfError("PDF trailer has no /Root")
        self.catalog = self.resolve(self.trailer[Name("Root")])
        if self.catalog.get(Name("Type")) not in (None, Name("Catalog")):
            pass
        self._pages = None

    # ------------------------------------------------------------------ xref

    def _load_xref(self):
        tail = self.data[-2048:]
        m = None
        for m in re.finditer(rb"startxref\s+(\d+)", tail):
            pass
        if m is None:
            raise PdfError("startxref not found")
        offset = int(m.group(1)) + self._base
        seen = set()
        while offset and offset not in seen:
            seen.add(offset)
            offset = self._read_xref_section(offset)

    def _read_xref_section(self, offset):
        p = Parser(self.data, offset)
        p.skip_ws()
        if self.data[p.pos : p.pos + 4] == b"xref":
            return self._read_xref_table(p)
        # Cross-reference stream: "N G obj <<...>> stream".
        obj = self._parse_indirect_at(p)
        if not isinstance(obj, Stream):
            raise PdfError("Invalid xref section")
        return self._read_xref_stream(obj)

    def _read_xref_table(self, p: Parser):
        p.pos += 4
        while True:
            p.skip_ws()
            if self.data[p.pos : p.pos + 7] == b"trailer":
                p.pos += 7
                trailer = p.parse_object()
                if isinstance(trailer, tuple):
                    trailer = trailer[1]
                for k, v in trailer.items():
                    self.trailer.setdefault(k, v)
                # Hybrid files: /XRefStm points at an xref stream with more entries.
                if Name("XRefStm") in trailer:
                    try:
                        self._read_xref_section(
                            int(trailer[Name("XRefStm")]) + self._base
                        )
                    except Exception:
                        pass
                prev = trailer.get(Name("Prev"))
                return int(prev) + self._base if prev is not None else None
            m = re.match(rb"(\d+)\s+(\d+)", self.data[p.pos : p.pos + 40])
            if not m:
                raise PdfError("Malformed xref table")
            start, count = int(m.group(1)), int(m.group(2))
            p.pos += m.end()
            p.skip_ws()
            for i in range(count):
                entry = self.data[p.pos : p.pos + 20]
                em = re.match(rb"(\d{10})\s+(\d{5})\s+([nf])", entry)
                if not em:
                    raise PdfError("Malformed xref entry")
                num = start + i
                if num not in self.xref:
                    if em.group(3) == b"n":
                        self.xref[num] = ("n", int(em.group(1)) + self._base)
                    else:
                        self.xref[num] = ("f",)
                p.pos += em.end()
                p.skip_ws()

    def _read_xref_stream(self, stream: Stream):
        d = stream.dict
        data = decode_stream(stream.raw, d, self.resolve)
        w = [int(self.resolve(x)) for x in self.resolve(d[Name("W")])]
        size = int(self.resolve(d[Name("Size")]))
        index = self.resolve(d.get(Name("Index"))) or [0, size]
        index = [int(self.resolve(x)) for x in index]
        rowlen = sum(w)
        pos = 0

        def field(row, start, width, default):
            if width == 0:
                return default
            return int.from_bytes(row[start : start + width], "big")

        for i in range(0, len(index), 2):
            start, count = index[i], index[i + 1]
            for j in range(count):
                row = data[pos : pos + rowlen]
                pos += rowlen
                if len(row) < rowlen:
                    break
                t = field(row, 0, w[0], 1)
                f2 = field(row, w[0], w[1], 0)
                f3 = field(row, w[0] + w[1], w[2], 0)
                num = start + j
                if num in self.xref:
                    continue
                if t == 0:
                    self.xref[num] = ("f",)
                elif t == 1:
                    self.xref[num] = ("n", f2 + self._base)
                elif t == 2:
                    self.xref[num] = ("s", f2, f3)
        for k, v in d.items():
            self.trailer.setdefault(k, v)
        prev = d.get(Name("Prev"))
        return int(self.resolve(prev)) + self._base if prev is not None else None

    def _scan_all_objects(self):
        """Fallback: find every ``N G obj`` in the file (last wins)."""
        for m in re.finditer(rb"(\d+)\s+(\d+)\s+obj\b", self.data):
            self.xref[int(m.group(1))] = ("n", m.start())
        if Name("Root") not in self.trailer:
            for m in re.finditer(rb"trailer", self.data):
                p = Parser(self.data, m.end())
                try:
                    t = p.parse_object()
                    if isinstance(t, dict):
                        for k, v in t.items():
                            self.trailer[k] = v
                except Exception:
                    continue
            if Name("Root") not in self.trailer:
                # Some linearized files keep Root only in an xref stream; scan
                # objects for a /Type /Catalog.
                for num in list(self.xref):
                    try:
                        obj = self.load_object(num)
                    except Exception:
                        continue
                    if isinstance(obj, dict) and obj.get(Name("Type")) == Name(
                        "Catalog"
                    ):
                        self.trailer[Name("Root")] = Ref(num, 0)
                        break

    # --------------------------------------------------------------- objects

    def _parse_indirect_at(self, p: Parser):
        p.skip_ws()
        m = re.match(rb"(\d+)\s+(\d+)\s+obj\b", self.data[p.pos : p.pos + 40])
        if not m:
            raise PdfError(f"No indirect object at offset {p.pos}")
        p.pos += m.end()
        obj = p.parse_object()
        if isinstance(obj, tuple) and obj[0] == "__stream__":
            _, d, data_start = obj
            length = self.resolve(d.get(Name("Length")))
            if isinstance(length, int) and length >= 0:
                raw = self.data[data_start : data_start + length]
                # Validate endstream follows; otherwise re-derive length.
                tailpos = data_start + length
                tail = self.data[tailpos : tailpos + 20]
                if b"endstream" not in tail:
                    raw = self._find_stream_data(data_start)
            else:
                raw = self._find_stream_data(data_start)
            return Stream(d, raw)
        return obj

    def _find_stream_data(self, start):
        end = self.data.find(b"endstream", start)
        if end < 0:
            raise PdfError("Unterminated stream")
        raw = self.data[start:end]
        if raw.endswith(b"\r\n"):
            raw = raw[:-2]
        elif raw.endswith(b"\n") or raw.endswith(b"\r"):
            raw = raw[:-1]
        return raw

    def load_object(self, num):
        if num in self._cache:
            return self._cache[num]
        entry = self.xref.get(num)
        obj = None
        if entry is None or entry[0] == "f":
            obj = None
        elif entry[0] == "n":
            p = Parser(self.data, entry[1])
            obj = self._parse_indirect_at(p)
        elif entry[0] == "s":
            obj = self._load_from_objstm(entry[1], entry[2], num)
        self._cache[num] = obj
        return obj

    def _load_from_objstm(self, stm_num, idx, want_num):
        if stm_num not in self._objstm_cache:
            stm = self.load_object(stm_num)
            if not isinstance(stm, Stream):
                raise PdfError(f"Object stream {stm_num} missing")
            data = decode_stream(stm.raw, stm.dict, self.resolve)
            n = int(self.resolve(stm.dict[Name("N")]))
            first = int(self.resolve(stm.dict[Name("First")]))
            hp = Parser(data, 0)
            pairs = []
            for _ in range(n):
                hp.skip_ws()
                onum = int(hp.read_regular_run())
                hp.skip_ws()
                ooff = int(hp.read_regular_run())
                pairs.append((onum, ooff))
            self._objstm_cache[stm_num] = (data, first, pairs)
        data, first, pairs = self._objstm_cache[stm_num]
        for i, (onum, ooff) in enumerate(pairs):
            if i == idx or onum == want_num:
                p = Parser(data, first + ooff)
                obj = p.parse_object()
                if isinstance(obj, tuple) and obj[0] == "__stream__":
                    obj = obj[1]
                return obj
        return None

    def resolve(self, obj, depth=0):
        while isinstance(obj, Ref) and depth < 32:
            obj = self.load_object(obj.num)
            depth += 1
        return obj

    def get_stream_data(self, stream: Stream) -> bytes:
        if stream._decoded is None:
            stream._decoded = decode_stream(stream.raw, stream.dict, self.resolve)
        return stream._decoded

    # ----------------------------------------------------------------- pages

    def _collect_pages(self):
        pages = []
        root = self.resolve(self.catalog.get(Name("Pages")))
        inheritable = (Name("Resources"), Name("MediaBox"), Name("CropBox"),
                       Name("Rotate"))

        def walk(node, inherited, seen):
            node = self.resolve(node)
            if node is None or id(node) in seen:
                return
            seen = seen | {id(node)}
            inh = dict(inherited)
            for k in inheritable:
                if k in node:
                    inh[k] = node[k]
            t = node.get(Name("Type"))
            kids = node.get(Name("Kids"))
            if t == Name("Page") or (kids is None and Name("Contents") in node):
                merged = dict(node)
                for k, v in inh.items():
                    merged.setdefault(k, v)
                pages.append(merged)
                return
            for kid in self.resolve(kids) or []:
                walk(kid, inh, seen)

        walk(root, {}, frozenset())
        return pages

    @property
    def pages(self):
        if self._pages is None:
            self._pages = self._collect_pages()
        return self._pages

    @property
    def n_pages(self):
        try:
            count = self.resolve(self.resolve(self.catalog.get(Name("Pages"))).get(Name("Count")))
            n = int(count)
            if n > 0:
                return n
        except Exception:
            pass
        return len(self.pages)

    def get_page(self, index):
        return self.pages[index]

    def get_page_content(self, page) -> bytes:
        contents = self.resolve(page.get(Name("Contents")))
        if contents is None:
            return b""
        if isinstance(contents, Stream):
            return self.get_stream_data(contents)
        out = []
        for c in contents:
            c = self.resolve(c)
            if isinstance(c, Stream):
                out.append(self.get_stream_data(c))
        return b"\n".join(out)
