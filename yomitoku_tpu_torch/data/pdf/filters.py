"""PDF stream filter decoders.

Implements the decode filters needed to replace pdfium for typical document
PDFs: Flate (+PNG/TIFF predictors), LZW, ASCIIHex, ASCII85, RunLength.
DCT/JPX image data is passed through and decoded by PIL at raster time.
"""

import zlib

from .cos import Name


def apply_png_predictor(data: bytes, colors: int, columns: int, bpc: int) -> bytes:
    bpp = max(1, (colors * bpc + 7) // 8)  # bytes per pixel
    rowlen = (columns * colors * bpc + 7) // 8
    out = bytearray()
    prev = bytearray(rowlen)
    i = 0
    n = len(data)
    while i + 1 <= n:
        ft = data[i]
        i += 1
        row = bytearray(data[i : i + rowlen])
        if len(row) < rowlen:
            row.extend(b"\0" * (rowlen - len(row)))
        i += rowlen
        if ft == 0:
            pass
        elif ft == 1:  # Sub
            for j in range(bpp, rowlen):
                row[j] = (row[j] + row[j - bpp]) & 0xFF
        elif ft == 2:  # Up
            for j in range(rowlen):
                row[j] = (row[j] + prev[j]) & 0xFF
        elif ft == 3:  # Average
            for j in range(rowlen):
                left = row[j - bpp] if j >= bpp else 0
                row[j] = (row[j] + ((left + prev[j]) >> 1)) & 0xFF
        elif ft == 4:  # Paeth
            for j in range(rowlen):
                a = row[j - bpp] if j >= bpp else 0
                b = prev[j]
                c = prev[j - bpp] if j >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                row[j] = (row[j] + pred) & 0xFF
        out.extend(row)
        prev = row
        if i >= n:
            break
    return bytes(out)


def apply_tiff_predictor(data: bytes, colors: int, columns: int, bpc: int) -> bytes:
    if bpc != 8:
        return data
    rowlen = columns * colors
    out = bytearray(data)
    for r in range(0, len(out) - rowlen + 1, rowlen):
        for j in range(colors, rowlen):
            out[r + j] = (out[r + j] + out[r + j - colors]) & 0xFF
    return bytes(out)


def _predictor(data: bytes, parms: dict) -> bytes:
    pred = int(parms.get("Predictor", 1) or 1)
    if pred <= 1:
        return data
    colors = int(parms.get("Colors", 1) or 1)
    columns = int(parms.get("Columns", 1) or 1)
    bpc = int(parms.get("BitsPerComponent", 8) or 8)
    if pred == 2:
        return apply_tiff_predictor(data, colors, columns, bpc)
    return apply_png_predictor(data, colors, columns, bpc)


def flate_decode(data: bytes, parms: dict) -> bytes:
    try:
        raw = zlib.decompress(data)
    except zlib.error:
        # Tolerate trailing garbage / missing EOD.
        d = zlib.decompressobj()
        raw = d.decompress(data)
    return _predictor(raw, parms)


def lzw_decode(data: bytes, parms: dict) -> bytes:
    early = int(parms.get("EarlyChange", 1) or 1)
    out = bytearray()
    table = [bytes([i]) for i in range(256)] + [b"", b""]
    code_len = 9
    prev = None
    buf = 0
    nbits = 0
    for byte in data:
        buf = (buf << 8) | byte
        nbits += 8
        while nbits >= code_len:
            nbits -= code_len
            code = (buf >> nbits) & ((1 << code_len) - 1)
            if code == 256:  # clear
                table = table[:258]
                code_len = 9
                prev = None
                continue
            if code == 257:  # EOD
                return _predictor(bytes(out), parms)
            if prev is None:
                entry = table[code]
            elif code < len(table):
                entry = table[code]
                table.append(prev + entry[:1])
            else:
                entry = prev + prev[:1]
                table.append(entry)
            out.extend(entry)
            prev = entry
            if len(table) + early - 1 >= (1 << code_len) and code_len < 12:
                code_len += 1
    return _predictor(bytes(out), parms)


def ascii_hex_decode(data: bytes, parms: dict) -> bytes:
    digits = [c for c in data.decode("latin-1") if c in "0123456789abcdefABCDEF"]
    if len(digits) % 2:
        digits.append("0")
    return bytes(int(digits[i] + digits[i + 1], 16) for i in range(0, len(digits), 2))


def ascii85_decode(data: bytes, parms: dict) -> bytes:
    import base64

    s = data.replace(b"\n", b"").replace(b"\r", b"").replace(b" ", b"")
    if s.startswith(b"<~"):
        s = s[2:]
    if s.endswith(b"~>"):
        s = s[:-2]
    return base64.a85decode(s)


def run_length_decode(data: bytes, parms: dict) -> bytes:
    out = bytearray()
    i = 0
    while i < len(data):
        l = data[i]
        i += 1
        if l == 128:
            break
        if l < 128:
            out.extend(data[i : i + l + 1])
            i += l + 1
        else:
            if i < len(data):
                out.extend(bytes([data[i]]) * (257 - l))
                i += 1
    return bytes(out)


#: Filters whose output stays encoded for the image decoder (PIL).
IMAGE_FILTERS = {"DCTDecode", "DCT", "JPXDecode", "CCITTFaxDecode", "CCF", "JBIG2Decode"}

_DECODERS = {
    "FlateDecode": flate_decode,
    "Fl": flate_decode,
    "LZWDecode": lzw_decode,
    "LZW": lzw_decode,
    "ASCIIHexDecode": ascii_hex_decode,
    "AHx": ascii_hex_decode,
    "ASCII85Decode": ascii85_decode,
    "A85": ascii85_decode,
    "RunLengthDecode": run_length_decode,
    "RL": run_length_decode,
}


def decode_stream(raw: bytes, stream_dict: dict, resolve) -> bytes:
    """Apply the (chain of) non-image filters; image filters pass through."""
    filters = resolve(stream_dict.get(Name("Filter")))
    parms = resolve(stream_dict.get(Name("DecodeParms"))) or resolve(
        stream_dict.get(Name("DP"))
    )
    if filters is None:
        return raw
    if isinstance(filters, (Name, str)):
        filters = [filters]
        parms = [parms]
    elif not isinstance(parms, list):
        parms = [parms] + [None] * (len(filters) - 1)

    data = raw
    for f, p in zip(filters, parms or [None] * len(filters)):
        f = str(resolve(f))
        p = resolve(p) or {}
        if f in IMAGE_FILTERS:
            return data  # leave for the image decoder
        dec = _DECODERS.get(f)
        if dec is None:
            raise NotImplementedError(f"PDF filter not supported: {f}")
        data = dec(data, {str(k): resolve(v) for k, v in dict(p).items()})
    return data
