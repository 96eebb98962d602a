"""BMP decoding in numpy, as Pillow 12's ``BmpImagePlugin`` reads a file.

Headers: OS/2 1.x (12 bytes) and Windows 3 to 5 (40, 52, 56, 64, 108, 124).
Pixels: 1-, 4- and 8-bit palettes (BGR or BGRX entries; a gray ramp is the
same as its palette), 16-bit 5-5-5 and 24- and 32-bit BGR(X), bottom-up or
top-down (negative height); ``BI_BITFIELDS`` with the masks Pillow accepts
(16-bit 5-6-5 and 5-5-5, 24-bit BGR, the 32-bit layouts of its table); RLE8
and RLE4 with Pillow's own handling of runs, absolute runs and their word
padding, and of deltas (whose offsets Pillow reads two bytes late).  Anything else raises ``ValueError`` naming it.
"""

from __future__ import annotations

import struct

import numpy as np

from diffpir_tpu_torch.utils.imageio import check_size

__all__ = ["decode_bmp"]

_RAW, _RLE8, _RLE4, _BITFIELDS = 0, 1, 2, 3
# 32-bit bitfield masks (r, g, b, a) -> byte index of r, g, b in the pixel
# (Pillow's MASK_MODES: BGRX, XBGR, BGXR, ABGR, RGBA, BGRA, BGAR, BGRA)
_MASKS32 = {
    (0xFF0000, 0xFF00, 0xFF, 0x0): (2, 1, 0),
    (0xFF000000, 0xFF0000, 0xFF00, 0x0): (3, 2, 1),
    (0xFF000000, 0xFF00, 0xFF, 0x0): (3, 1, 0),
    (0xFF000000, 0xFF0000, 0xFF00, 0xFF): (3, 2, 1),
    (0xFF, 0xFF00, 0xFF0000, 0xFF000000): (0, 1, 2),
    (0xFF0000, 0xFF00, 0xFF, 0xFF000000): (2, 1, 0),
    (0xFF000000, 0xFF00, 0xFF, 0xFF0000): (3, 1, 0),
    (0x0, 0x0, 0x0, 0x0): (2, 1, 0),
}


def _rle(data: bytes, pos: int, width: int, height: int, rle4: bool) -> np.ndarray:
    """Pillow's BmpRleDecoder: indices of width * height pixels in file
    order (bottom row first unless top-down), 0 where the data leaves none."""
    out = bytearray()
    x = 0
    total = width * height
    n = len(data)
    while len(out) < total:
        if pos + 2 > n:
            break
        count, byte = data[pos], data[pos + 1]
        pos += 2
        if count:
            if x + count > width:   # too much for the row
                count = max(0, width - x)
            if rle4:
                pair = bytes([byte >> 4, byte & 15])
                out += (pair * ((count + 1) // 2))[:count]
            else:
                out += bytes([byte]) * count
            x += count
        elif byte == 0:         # end of line
            out += bytes(-len(out) % width)
            x = 0
        elif byte == 1:         # end of bitmap
            break
        elif byte == 2:         # delta: Pillow reads (right, up) from the two
            if pos + 4 > n:     # bytes after the two that the format gives
                break
            right, up = data[pos + 2], data[pos + 3]
            pos += 4
            out += bytes(min(right + up * width, total - len(out)))
            x = len(out) % width
        else:                   # absolute run, padded to a 16-bit word
            nbytes = byte // 2 if rle4 else byte
            run = data[pos:pos + nbytes]
            pos += len(run)
            if rle4:
                out += bytes(v for b in run for v in (b >> 4, b & 15))
            else:
                out += run
            if len(run) < nbytes:
                break
            x += byte
            if pos % 2:
                pos += 1
    idx = np.zeros(total, np.uint8)
    got = np.frombuffer(bytes(out[:total]), np.uint8)
    idx[:len(got)] = got
    return idx.reshape(height, width)


def decode_bmp(data: bytes):
    """Decode BMP bytes to ``(mode, pixels, palette)``: ``"RGB"`` (h, w, 3)
    or ``"P"`` (h, w) indices with a (256, 3) palette."""
    if data[:2] != b"BM" or len(data) < 26:
        raise ValueError("not a BMP file")
    offset = struct.unpack_from("<I", data, 10)[0]
    hsize = struct.unpack_from("<I", data, 14)[0]
    h = data[18:14 + hsize]
    masks = None
    if hsize == 12:
        width, height, _, bits = struct.unpack_from("<HHHH", h, 0)
        compression, colors, pad, top_down = _RAW, 0, 3, False
    elif hsize in (40, 52, 56, 64, 108, 124):
        top_down = h[7] == 0xFF
        width = struct.unpack_from("<I", h, 0)[0]
        height = struct.unpack_from("<I", h, 4)[0]
        if top_down:
            height = 2 ** 32 - height
        bits, compression = struct.unpack_from("<HI", h, 10)
        colors = struct.unpack_from("<I", h, 28)[0]
        pad = 4
        if compression == _BITFIELDS:
            if len(h) >= 48:
                masks = list(struct.unpack_from("<III", h, 36))
                masks.append(struct.unpack_from("<I", h, 48)[0] if len(h) >= 52 else 0)
            else:
                masks = list(struct.unpack_from("<III", data, 14 + hsize)) + [0]
    else:
        raise ValueError(f"BMP header of {hsize} bytes is not supported")
    colors = colors or (1 << bits if bits <= 24 else 0)
    if offset == 14 + hsize and bits <= 8:
        offset += 4 * colors
    if width <= 0 or height <= 0:
        raise ValueError("BMP with an empty image")
    check_size("BMP", width, height)

    if bits not in (1, 4, 8, 16, 24, 32):
        raise ValueError(f"{bits}-bit BMP is not supported")
    if compression == _BITFIELDS:
        if bits == 32 and tuple(masks) in _MASKS32:
            order = _MASKS32[tuple(masks)]
        elif bits == 24 and tuple(masks[:3]) == (0xFF0000, 0xFF00, 0xFF):
            order = (2, 1, 0)
        elif bits == 16 and tuple(masks[:3]) in ((0xF800, 0x7E0, 0x1F),
                                                 (0x7C00, 0x3E0, 0x1F)):
            order = "565" if masks[0] == 0xF800 else "555"
        else:
            raise ValueError(f"BMP bitfield masks {[hex(m) for m in masks]} at {bits} "
                             "bits are not supported")
    elif compression == _RAW:
        order = {16: "555", 24: (2, 1, 0), 32: (2, 1, 0)}.get(bits)
    elif compression in (_RLE8, _RLE4):
        order = None
    else:
        raise ValueError(f"BMP compression {compression} is not supported")

    palette = None
    if bits <= 8:
        if not 0 < colors <= 65536:
            raise ValueError(f"BMP with {colors} palette colours")
        start = 14 + hsize
        raw = np.frombuffer(data[start:start + pad * colors], np.uint8)
        entries = raw[:len(raw) // pad * pad].reshape(-1, pad)[:256, 2::-1]
        palette = np.zeros((256, 3), np.uint8)
        palette[:len(entries)] = entries

    if compression in (_RLE8, _RLE4):
        idx = _rle(data, offset, width, height, compression == _RLE4)
        return "P", idx if top_down else idx[::-1], palette

    stride = ((width * bits + 31) >> 3) & ~3
    need = stride * height
    body = np.frombuffer(data[offset:offset + need], np.uint8)
    if len(body) < need:
        raise ValueError("truncated BMP pixel data")
    rows = body.reshape(height, stride)
    if not top_down:
        rows = rows[::-1]
    if bits <= 8:
        if bits == 8:
            idx = rows[:, :width]
        else:
            b = np.unpackbits(rows, axis=1)[:, :width * bits].reshape(height, width, bits)
            idx = (b * (1 << np.arange(bits - 1, -1, -1)).astype(np.uint8)).sum(
                axis=2, dtype=np.uint8)
        return "P", np.ascontiguousarray(idx), palette
    if bits == 16:
        v = rows[:, :2 * width].reshape(height, width, 2).astype(np.uint32)
        v = v[..., 0] | (v[..., 1] << 8)
        if order == "565":
            ch = [(v >> 11) & 31, (v >> 5) & 63, v & 31]
            top = [31, 63, 31]
        else:
            ch = [(v >> 10) & 31, (v >> 5) & 31, v & 31]
            top = [31, 31, 31]
        rgb = np.stack([c * 255 // t for c, t in zip(ch, top)], axis=2)
        return "RGB", rgb.astype(np.uint8), None
    nb = bits // 8
    px = rows[:, :nb * width].reshape(height, width, nb)
    return "RGB", np.ascontiguousarray(px[:, :, list(order)]), None
