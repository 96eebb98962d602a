"""Test-side image writers for what Pillow does not write: PNGs of every
colour type, bit depth and filter, Adam7-interlaced; baseline JPEGs with any
sampling factors, scans per component and restart intervals; BMPs of 4 and
16 bits, bitfields, top-down rows and RLE; TIFFs with arbitrary tags.  The
files are read back by Pillow, which is the reference the decoders are held
to, so these writers need only be valid, not faithful to any encoder."""

from __future__ import annotations

import io
import struct
import zlib

import numpy as np
from scipy.fft import dctn

# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------

ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
         (1, 0, 2, 2), (0, 1, 1, 2))


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _pack_rows(samples: np.ndarray, depth: int) -> np.ndarray:
    """(h, w, c) samples -> (h, row bytes) uint8 as PNG stores them."""
    h, w, c = samples.shape
    flat = samples.reshape(h, w * c).astype(np.uint32)
    if depth == 16:
        return np.stack([flat >> 8, flat & 255], axis=2).reshape(h, -1).astype(np.uint8)
    if depth == 8:
        return flat.astype(np.uint8)
    bits = ((flat[:, :, None] >> np.arange(depth - 1, -1, -1)) & 1).astype(np.uint8)
    return np.packbits(bits.reshape(h, -1), axis=1)


def _filtered(rows: np.ndarray, bpp: int, first_filter: int) -> bytes:
    out = bytearray()
    prior = np.zeros(rows.shape[1], np.int64)
    for y, cur8 in enumerate(rows):
        ftype = (first_filter + y) % 5
        cur = cur8.astype(np.int64)
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])[:len(cur)]
        upleft = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])[:len(cur)]
        pred = [0, left, prior, (left + prior) // 2, _paeth(left, prior, upleft)][ftype]
        out.append(ftype)
        out += ((cur - pred) % 256).astype(np.uint8).tobytes()
        prior = cur
    return bytes(out)


def png_bytes(samples: np.ndarray, depth: int, colour: int, interlace: bool = False,
              plte: np.ndarray | None = None, trns: bytes | None = None,
              first_filter: int = 0) -> bytes:
    """A PNG of ``samples`` ((h, w) or (h, w, c) ints below 2**depth) with
    the five row filters in turn."""
    samples = np.asarray(samples)
    if samples.ndim == 2:
        samples = samples[:, :, None]
    h, w, c = samples.shape
    bpp = max(1, depth * c // 8)
    if interlace:
        raw = b""
        for x0, y0, dx, dy in ADAM7:
            sub = samples[y0::dy, x0::dx]
            if sub.size:
                raw += _filtered(_pack_rows(sub, depth), bpp, first_filter)
    else:
        raw = _filtered(_pack_rows(samples, depth), bpp, first_filter)
    ihdr = struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0, int(interlace))
    extra = b""
    if plte is not None:
        extra += _chunk(b"PLTE", np.asarray(plte, np.uint8).tobytes())
    if trns is not None:
        extra += _chunk(b"tRNS", trns)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr) + extra
            + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b""))


# ---------------------------------------------------------------------------
# JPEG (baseline, any sampling factors)
# ---------------------------------------------------------------------------

_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48,
    41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22,
    15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55,
    62, 63])


def _standard_tables() -> list[tuple[int, int, bytes, bytes]]:
    """The four DHT tables (class, id, counts, symbols) of a JPEG that Pillow
    writes without optimisation: the standard ones of Annex K."""
    from PIL import Image

    buf = io.BytesIO()
    Image.new("RGB", (8, 8)).save(buf, "JPEG", quality=90)
    data = buf.getvalue()
    tables, pos = [], 2
    while pos < len(data):
        marker, length = data[pos + 1], struct.unpack(">H", data[pos + 2:pos + 4])[0]
        seg = data[pos + 4:pos + 2 + length]
        if marker == 0xC4:
            at = 0
            while at < len(seg):
                n = sum(seg[at + 1:at + 17])
                tables.append((seg[at] >> 4, seg[at] & 15, seg[at + 1:at + 17],
                               seg[at + 17:at + 17 + n]))
                at += 17 + n
        if marker == 0xDA:
            break
        pos += 2 + length
    return tables


def _codes(counts: bytes, symbols: bytes) -> dict[int, tuple[int, int]]:
    out, code, k = {}, 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            out[symbols[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return out


class _BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.acc, self.n = 0, 0

    def put(self, value: int, nbits: int):
        self.acc = (self.acc << nbits) | (value & ((1 << nbits) - 1))
        self.n += nbits
        while self.n >= 8:
            self.n -= 8
            byte = (self.acc >> self.n) & 255
            self.out.append(byte)
            if byte == 255:
                self.out.append(0)

    def flush(self):
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)


def jpeg_bytes(planes: list[np.ndarray], sampling: list[tuple[int, int]],
               quant: int = 6, restart: int = 0, interleaved: bool = True,
               ids: tuple = (1, 2, 3), jfif: bool = True) -> bytes:
    """A baseline JPEG of full-size uint8 component planes: each is averaged
    down by (hmax / h, vmax / v), transformed and quantised with a flat
    table of step ``quant``; one scan, or one scan a component."""
    height, width = planes[0].shape
    hmax = max(h for h, _ in sampling)
    vmax = max(v for _, v in sampling)
    mcux = -(-width // (8 * hmax))
    mcuy = -(-height // (8 * vmax))
    blocks = []
    for plane, (h, v) in zip(planes, sampling):
        fy, fx = vmax // v, hmax // h
        dh, dw = -(-height * v // vmax), -(-width * h // hmax)
        full = np.pad(plane.astype(np.float64), ((0, dh * fy - height), (0, dw * fx - width)),
                      mode="edge")
        small = full.reshape(dh, fy, dw, fx).mean(axis=(1, 3))
        bh, bw = mcuy * v, mcux * h
        small = np.pad(small, ((0, bh * 8 - dh), (0, bw * 8 - dw)), mode="edge")
        b = small.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3) - 128.0
        coef = np.rint(dctn(b, axes=(2, 3), norm="ortho") / quant).astype(np.int64)
        blocks.append(coef.reshape(bh, bw, 64)[:, :, _ZIGZAG])
    tables = _standard_tables()
    dc = {t[1]: _codes(t[2], t[3]) for t in tables if t[0] == 0}
    ac = {t[1]: _codes(t[2], t[3]) for t in tables if t[0] == 1}
    sel = [0] + [1] * (len(planes) - 1)

    def encode(w, coef, pred, t):
        diff = int(coef[0]) - pred
        s = abs(diff).bit_length()
        w.put(*dc[t][s])
        if s:
            w.put(diff if diff > 0 else diff + (1 << s) - 1, s)
        run = 0
        for k in range(1, 64):
            val = int(coef[k])
            if val == 0:
                run += 1
                continue
            while run > 15:
                w.put(*ac[t][0xF0])
                run -= 16
            s = abs(val).bit_length()
            w.put(*ac[t][(run << 4) | s])
            w.put(val if val > 0 else val + (1 << s) - 1, s)
            run = 0
        if run:
            w.put(*ac[t][0x00])
        return int(coef[0])

    def scan(comps):
        w = _BitWriter()
        preds = [0] * len(planes)
        units = []
        if len(comps) == 1:
            c = comps[0]
            h, v = sampling[c]
            bw = -(-(-(-width * h // hmax)) // 8)
            bh = -(-(-(-height * v // vmax)) // 8)
            units = [[(c, y, x)] for y in range(bh) for x in range(bw)]
        else:
            for my in range(mcuy):
                for mx in range(mcux):
                    units.append([(c, my * sampling[c][1] + v, mx * sampling[c][0] + h)
                                  for c in comps for v in range(sampling[c][1])
                                  for h in range(sampling[c][0])])
        out = bytearray()
        for i, unit in enumerate(units):
            if restart and i and i % restart == 0:
                w.flush()
                out += w.out + bytes([0xFF, 0xD0 + (i // restart - 1) % 8])
                w = _BitWriter()
                preds = [0] * len(planes)
            for c, y, x in unit:
                preds[c] = encode(w, blocks[c][y, x], preds[c], sel[c])
        w.flush()
        out += w.out
        head = bytes([len(comps)]) + b"".join(bytes([ids[c], sel[c] * 17]) for c in comps)
        return _seg(0xDA, head + bytes([0, 63, 0])) + bytes(out)

    data = b"\xff\xd8"
    if jfif:
        data += _seg(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    data += _seg(0xDB, b"".join(bytes([t]) + bytes([quant] * 64) for t in range(2)))
    sof = struct.pack(">BHHB", 8, height, width, len(planes))
    sof += b"".join(bytes([ids[c], (h << 4) | v, sel[c]]) for c, (h, v) in enumerate(sampling))
    data += _seg(0xC0, sof)
    data += _seg(0xC4, b"".join(bytes([(cls << 4) | tid]) + cnt + sym
                                for cls, tid, cnt, sym in tables))
    if restart:
        data += _seg(0xDD, struct.pack(">H", restart))
    comps = list(range(len(planes)))
    for group in ([comps] if interleaved else [[c] for c in comps]):
        data += scan(group)
    return data + b"\xff\xd9"


def _seg(marker: int, body: bytes) -> bytes:
    return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body


def jpeg_segments(data: bytes) -> list[tuple[int, int, int]]:
    """(marker, start, end) of each marker segment, a scan's entropy-coded
    data included in its SOS segment."""
    out, pos = [], 2
    while pos < len(data) - 1:
        marker = data[pos + 1]
        if marker == 0xD9:
            out.append((marker, pos, pos + 2))
            break
        length = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        end = pos + 2 + length
        if marker == 0xDA:
            while not (data[end] == 0xFF and data[end + 1] not in (0,) + tuple(range(0xD0, 0xD8))):
                end += 1
        out.append((marker, pos, end))
        pos = end
    return out


# ---------------------------------------------------------------------------
# BMP and TIFF
# ---------------------------------------------------------------------------

def bmp_bytes(width: int, height: int, bits: int, rows=None, palette=None,
              compression: int = 0, masks=None, top_down: bool = False,
              header: int = 40, rle: bytes | None = None) -> bytes:
    """A BMP of file-order pixel ``rows`` (bytes each, top row first), or of
    RLE data; ``masks`` for BI_BITFIELDS (after a 40-byte header, or in a
    v4 header of 108 bytes)."""
    if header == 12:
        pal = b"" if palette is None else b"".join(bytes([b, g, r]) for r, g, b in palette)
        h = struct.pack("<IHHHH", 12, width, height, 1, bits)
    else:
        pal = b"" if palette is None else b"".join(bytes([b, g, r, 0])
                                                   for r, g, b in palette)
        h = struct.pack("<IiiHHIIiiII", header, width, -height if top_down else height, 1,
                        bits, compression, 0, 2835, 2835,
                        0 if palette is None else len(palette), 0)
        if header > 40:
            h += struct.pack("<IIII", *(masks or (0, 0, 0, 0))) + bytes(header - 56)
    extra = struct.pack("<III", *masks[:3]) if masks is not None and header == 40 else b""
    if rle is not None:
        pix = rle
    else:
        stride = ((width * bits + 31) >> 3) & ~3
        rows = [bytes(r) + bytes(stride - len(r)) for r in rows]
        pix = b"".join(rows if top_down else rows[::-1])
    off = 14 + len(h) + len(extra) + len(pal)
    return (b"BM" + struct.pack("<IHHI", off + len(pix), 0, 0, off) + h + extra + pal
            + pix)


def tiff_bytes(img: np.ndarray, tags: dict[int, tuple[int, tuple]]) -> bytes:
    """An uncompressed little-endian TIFF of uint8 ``img`` ((h, w) or (h, w,
    c)) in one strip, with ``tags`` (tag -> (type, values)) added to or
    replacing the basic ones."""
    img = np.asarray(img, np.uint8)
    h, w = img.shape[:2]
    c = 1 if img.ndim == 2 else img.shape[2]
    pixels = img.tobytes()
    base = {256: (4, (w,)), 257: (4, (h,)), 258: (3, (8,) * c), 259: (3, (1,)),
            262: (3, (1 if c == 1 else 2,)), 273: (4, (0,)), 277: (3, (c,)),
            278: (4, (h,)), 279: (4, (len(pixels),))}
    base.update(tags)
    fmt = {3: "H", 4: "I"}
    entries = sorted(base.items())
    ifd_at = 8
    data_at = ifd_at + 2 + 12 * len(entries) + 4
    blobs, out_entries = b"", []
    for tag, (typ, vals) in entries:
        raw = struct.pack("<" + fmt[typ] * len(vals), *vals)
        if len(raw) <= 4:
            out_entries.append(struct.pack("<HHI", tag, typ, len(vals)) + raw.ljust(4, b"\0"))
        else:
            out_entries.append(struct.pack("<HHII", tag, typ, len(vals),
                                           data_at + len(blobs)))
            blobs += raw + (b"\0" if len(raw) % 2 else b"")
    pix_at = data_at + len(blobs)
    out = []
    for e, (tag, _) in zip(out_entries, entries):
        if tag == 273:
            e = e[:8] + struct.pack("<I", pix_at)
        out.append(e)
    return (b"II*\x00" + struct.pack("<I", ifd_at) + struct.pack("<H", len(entries))
            + b"".join(out) + b"\0\0\0\0" + blobs + pixels)
