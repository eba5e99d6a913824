"""PDF COS object model: lexer and parser.

Self-contained replacement for the object layer of pdfium (the reference
renders PDFs through pypdfium2, data/functions.py:96-155).  Parses the
carousel object system: numbers, strings, names, arrays, dicts, streams,
indirect references.
"""

import re

WHITESPACE = b"\x00\t\n\x0c\r "
DELIMITERS = b"()<>[]{}/%"


class Name(str):
    """A PDF name object (distinct from a text string)."""

    __slots__ = ()


class Ref:
    """Indirect object reference ``num gen R``."""

    __slots__ = ("num", "gen")

    def __init__(self, num, gen=0):
        self.num = num
        self.gen = gen

    def __repr__(self):
        return f"Ref({self.num},{self.gen})"

    def __eq__(self, other):
        return (
            isinstance(other, Ref) and self.num == other.num and self.gen == other.gen
        )

    def __hash__(self):
        return hash((self.num, self.gen))


class Stream:
    """A stream object: dict + raw (still encoded) data."""

    __slots__ = ("dict", "raw", "_decoded")

    def __init__(self, d, raw):
        self.dict = d
        self.raw = raw
        self._decoded = None

    def __repr__(self):
        return f"Stream({dict(self.dict)!r}, {len(self.raw)} bytes)"


def is_regular(ch: int) -> bool:
    return ch not in WHITESPACE and ch not in DELIMITERS


class Lexer:
    """Byte-level PDF tokenizer over an in-memory buffer."""

    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos

    def skip_ws(self):
        data, n = self.data, len(self.data)
        pos = self.pos
        while pos < n:
            c = data[pos]
            if c in WHITESPACE:
                pos += 1
            elif c == 0x25:  # '%' comment to EOL
                while pos < n and data[pos] not in b"\r\n":
                    pos += 1
            else:
                break
        self.pos = pos

    def peek_byte(self):
        return self.data[self.pos] if self.pos < len(self.data) else None

    def read_regular_run(self) -> bytes:
        start = self.pos
        data, n = self.data, len(self.data)
        while self.pos < n and is_regular(data[self.pos]):
            self.pos += 1
        return data[start : self.pos]

    def read_name(self) -> Name:
        assert self.data[self.pos] == 0x2F  # '/'
        self.pos += 1
        raw = self.read_regular_run()
        # '#xx' hex escapes inside names.
        if b"#" in raw:
            out = bytearray()
            i = 0
            while i < len(raw):
                if raw[i] == 0x23 and i + 2 < len(raw):
                    try:
                        out.append(int(raw[i + 1 : i + 3], 16))
                        i += 3
                        continue
                    except ValueError:
                        pass
                out.append(raw[i])
                i += 1
            raw = bytes(out)
        return Name(raw.decode("latin-1"))

    def read_literal_string(self) -> bytes:
        assert self.data[self.pos] == 0x28  # '('
        self.pos += 1
        out = bytearray()
        depth = 1
        data, n = self.data, len(self.data)
        while self.pos < n:
            c = data[self.pos]
            self.pos += 1
            if c == 0x5C:  # backslash
                if self.pos >= n:
                    break
                e = data[self.pos]
                self.pos += 1
                if e in b"nrtbf":
                    out.append({0x6E: 10, 0x72: 13, 0x74: 9, 0x62: 8, 0x66: 12}[e])
                elif e in b"()\\":
                    out.append(e)
                elif 0x30 <= e <= 0x37:  # octal, up to 3 digits
                    val = e - 0x30
                    for _ in range(2):
                        if self.pos < n and 0x30 <= data[self.pos] <= 0x37:
                            val = val * 8 + (data[self.pos] - 0x30)
                            self.pos += 1
                        else:
                            break
                    out.append(val & 0xFF)
                elif e == 0x0D:  # line continuation \CR[LF]
                    if self.pos < n and data[self.pos] == 0x0A:
                        self.pos += 1
                elif e == 0x0A:
                    pass
                else:
                    out.append(e)
            elif c == 0x28:
                depth += 1
                out.append(c)
            elif c == 0x29:
                depth -= 1
                if depth == 0:
                    break
                out.append(c)
            else:
                out.append(c)
        return bytes(out)

    def read_hex_string(self) -> bytes:
        # caller consumed '<'
        out = bytearray()
        digits = []
        data, n = self.data, len(self.data)
        while self.pos < n:
            c = data[self.pos]
            self.pos += 1
            if c == 0x3E:  # '>'
                break
            if chr(c) in "0123456789abcdefABCDEF":
                digits.append(chr(c))
        if len(digits) % 2:
            digits.append("0")
        for i in range(0, len(digits), 2):
            out.append(int(digits[i] + digits[i + 1], 16))
        return bytes(out)


_NUM_RE = re.compile(rb"^[+-]?(\d+\.?\d*|\.\d+)$")


class Parser(Lexer):
    """Parses full COS objects; indirect-ref recognition via lookahead."""

    def parse_object(self):
        self.skip_ws()
        c = self.peek_byte()
        if c is None:
            raise EOFError("Unexpected end of PDF data")

        if c == 0x2F:  # '/'
            return self.read_name()
        if c == 0x28:  # '('
            return self.read_literal_string()
        if c == 0x3C:  # '<' : dict or hex string
            if self.data[self.pos : self.pos + 2] == b"<<":
                return self.parse_dict_or_stream()
            self.pos += 1
            return self.read_hex_string()
        if c == 0x5B:  # '['
            self.pos += 1
            arr = []
            while True:
                self.skip_ws()
                if self.peek_byte() == 0x5D:
                    self.pos += 1
                    return arr
                arr.append(self.parse_object())
        if c == 0x5D or c == 0x3E:  # stray closers
            raise ValueError(f"Unexpected delimiter at {self.pos}")

        tok = self.read_regular_run()
        if not tok:
            # Unknown delimiter; skip it to avoid infinite loops.
            self.pos += 1
            return None
        if tok == b"true":
            return True
        if tok == b"false":
            return False
        if tok == b"null":
            return None
        if _NUM_RE.match(tok):
            # Possible indirect reference: "num gen R".
            if b"." not in tok:
                save = self.pos
                self.skip_ws()
                tok2 = self.read_regular_run()
                if tok2 and _NUM_RE.match(tok2) and b"." not in tok2:
                    self.skip_ws()
                    tok3 = self.read_regular_run()
                    if tok3 == b"R":
                        return Ref(int(tok), int(tok2))
                self.pos = save
                return int(tok)
            return float(tok)
        # Operator or keyword (content streams) — return as Name-ish marker.
        return Keyword(tok.decode("latin-1"))

    def parse_dict_or_stream(self):
        assert self.data[self.pos : self.pos + 2] == b"<<"
        self.pos += 2
        d = {}
        while True:
            self.skip_ws()
            if self.data[self.pos : self.pos + 2] == b">>":
                self.pos += 2
                break
            key = self.parse_object()
            if not isinstance(key, Name):
                # Malformed; bail out of the dict.
                continue
            val = self.parse_object()
            d[key] = val
        # A stream keyword may follow.
        save = self.pos
        self.skip_ws()
        if self.data[self.pos : self.pos + 6] == b"stream":
            self.pos += 6
            if self.data[self.pos : self.pos + 2] == b"\r\n":
                self.pos += 2
            elif self.data[self.pos : self.pos + 1] in (b"\n", b"\r"):
                self.pos += 1
            return ("__stream__", d, self.pos)  # resolved by the document layer
        self.pos = save
        return d


class Keyword(str):
    """A bare keyword token (content-stream operator, 'obj', 'endobj'...)."""

    __slots__ = ()
