"""TIFF decoding of the first image, as Pillow 12 (with libtiff) opens it.

Reads strips of 8-bit samples, chunky (planar configuration 1): gray
(BlackIsZero, and WhiteIsZero inverted; a missing photometric tag is
WhiteIsZero, as Pillow takes it), gray + alpha, RGB with or without extra
samples (associated alpha is divided out as Pillow's "RGBa" does, before a
conversion drops it), palette (the colour map's high bytes) and CMYK; each
strip uncompressed, PackBits, LZW or Deflate, LZW and Deflate with the
horizontal predictor 2; fill order 2 (bits reversed in each byte).  The
EXIF orientation tag is applied, as Pillow's ``TiffImageFile.load_end``
does.  Refused with a ``ValueError`` that names the feature: tiles,
JPEG-in-TIFF and other compressions, planar configuration 2, samples of
other than 8 bits, floating-point samples and the floating-point predictor,
and photometric interpretations other than these.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from diffpir_tpu_torch.utils.imageio import check_size

__all__ = ["decode_tiff"]

_TYPES = {1: ("B", 1), 2: ("c", 1), 3: ("H", 2), 4: ("I", 4), 6: ("b", 1), 8: ("h", 2),
          9: ("i", 4), 16: ("Q", 8)}
_COMPRESSION = {1: "none", 5: "lzw", 8: "deflate", 32946: "deflate", 32773: "packbits"}
_REVERSED = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)


def _ifd(data: bytes, order: str, offset: int) -> dict:
    """Tag -> tuple of values of the IFD at ``offset``."""
    (count,) = struct.unpack_from(order + "H", data, offset)
    tags = {}
    for i in range(count):
        tag, typ, n, value = struct.unpack_from(order + "HHI4s", data, offset + 2 + 12 * i)
        if typ not in _TYPES:
            continue
        fmt, size = _TYPES[typ]
        raw = value if n * size <= 4 else data[struct.unpack(order + "I", value)[0]:][:n * size]
        if typ == 2:
            tags[tag] = (raw[:n],)
        else:
            tags[tag] = struct.unpack(order + fmt * n, raw[:n * size])
    return tags


def _packbits(src: bytes, size: int) -> bytes:
    out = bytearray()
    i, n = 0, len(src)
    while i < n and len(out) < size:
        h = src[i]
        i += 1
        if h < 128:
            out += src[i:i + h + 1]
            i += h + 1
        elif h > 128:
            if i < n:
                out += bytes([src[i]]) * (257 - h)
            i += 1
    return bytes(out[:size])


def _lzw(src: bytes, size: int) -> bytes:
    """TIFF LZW: codes MSB first, 9 to 12 bits, the width growing one code
    early (at 511, 1023 and 2047 entries)."""
    if src[:2] == b"\x00\x01":
        raise ValueError("TIFF with old-style (pre-6.0) LZW is not supported")
    data = src + bytes(4)
    nbits = 8 * len(src)
    table = [bytes([i]) for i in range(256)] + [b"", b""]
    out = bytearray()
    size_bits = 9
    prev = None
    pos = 0
    while len(out) < size and pos + size_bits <= nbits:
        at = pos >> 3
        code = (int.from_bytes(data[at:at + 3], "big") >> (24 - size_bits - (pos & 7))) \
            & ((1 << size_bits) - 1)
        pos += size_bits
        if code == 256:
            del table[258:]
            size_bits = 9
            prev = None
            continue
        if code == 257:
            break
        if prev is None:
            if code >= 256:
                raise ValueError("corrupt TIFF LZW data")
            entry = table[code]
        elif code < len(table):
            entry = table[code]
            table.append(prev + entry[:1])
        elif code == len(table):
            entry = prev + prev[:1]
            table.append(entry)
        else:
            raise ValueError("corrupt TIFF LZW data")
        out += entry
        prev = entry
        if len(table) + 1 >= 1 << size_bits and size_bits < 12:
            size_bits += 1
    return bytes(out[:size])


def _orient(img: np.ndarray, orientation: int) -> np.ndarray:
    """Pillow's exif_transpose for orientations 2..8."""
    ops = {2: lambda a: a[:, ::-1], 3: lambda a: a[::-1, ::-1], 4: lambda a: a[::-1],
           5: lambda a: a.swapaxes(0, 1), 6: lambda a: np.rot90(a, -1),
           7: lambda a: a[::-1, ::-1].swapaxes(0, 1), 8: lambda a: np.rot90(a, 1)}
    op = ops.get(orientation)
    return np.ascontiguousarray(op(img)) if op else img


def decode_tiff(data: bytes):
    """Decode TIFF bytes to ``(mode, pixels, palette)``: ``"L"``,
    ``"RGB"``, ``"P"`` with a (256, 3) palette, or ``"CMYK"``."""
    if data[:4] == b"II*\x00":
        order = "<"
    elif data[:4] == b"MM\x00*":
        order = ">"
    else:
        raise ValueError("not a TIFF file")
    tags = _ifd(data, order, struct.unpack_from(order + "I", data, 4)[0])
    width, height = tags[256][0], tags[257][0]
    check_size("TIFF", width, height)
    if 322 in tags or 324 in tags:
        raise ValueError("tiled TIFF is not supported (strips only)")
    comp = tags.get(259, (1,))[0]
    if comp in (6, 7):
        raise ValueError("JPEG-in-TIFF (compression 6/7) is not supported")
    if comp not in _COMPRESSION:
        raise ValueError(f"TIFF compression {comp} is not supported")
    if tags.get(284, (1,))[0] != 1:
        raise ValueError("TIFF with planar configuration 2 (separate planes) is not "
                         "supported")
    spp = tags.get(277, (1,))[0]
    bps = tags.get(258, (1,))
    if len(bps) == 1:
        bps = bps * spp
    if any(b != 8 for b in bps):
        raise ValueError(f"TIFF with {max(bps)} bits a sample is not supported (8 only)")
    if any(f not in (1, 2) for f in tags.get(339, (1,))):
        raise ValueError("TIFF with floating-point samples is not supported")
    predictor = tags.get(317, (1,))[0]
    if predictor not in (1, 2):
        raise ValueError(f"TIFF predictor {predictor} is not supported")
    photo = tags.get(262, (0,))[0]
    extra = tags.get(338, ())
    if photo in (0, 1, 3):
        base = 1
    elif photo == 2:
        base = 3
    elif photo == 5:
        base = 4
    else:
        raise ValueError(f"TIFF photometric interpretation {photo} is not supported")
    if spp < base or (photo != 2 and spp > base + len(extra)):
        raise ValueError(f"TIFF with {spp} samples a pixel at photometric {photo} is "
                         "not supported")

    offsets = tags[273]
    counts = tags.get(279)
    rps = min(tags.get(278, (height,))[0], height)
    kind = _COMPRESSION[comp]
    row_bytes = width * spp
    rows = []
    for i, off in enumerate(offsets):
        n_rows = min(rps, height - i * rps)
        if n_rows <= 0:
            break
        need = n_rows * row_bytes
        raw = data[off:off + (counts[i] if counts else need)]
        if tags.get(266, (1,))[0] == 2:
            raw = _REVERSED[np.frombuffer(raw, np.uint8)].tobytes()
        if kind == "none":
            out = raw[:need]
        elif kind == "packbits":
            out = _packbits(raw, need)
        elif kind == "lzw":
            out = _lzw(raw, need)
        else:
            out = zlib.decompressobj().decompress(raw, need)
        if len(out) < need:
            raise ValueError("truncated TIFF strip")
        strip = np.frombuffer(out, np.uint8).reshape(n_rows, width, spp)
        if predictor == 2 and kind in ("lzw", "deflate"):
            strip = (np.cumsum(strip, axis=1, dtype=np.uint32) & 0xFF).astype(np.uint8)
        rows.append(strip)
    img = np.concatenate(rows, axis=0)
    if img.shape[0] < height:
        raise ValueError("TIFF strips hold fewer rows than the image")
    orientation = tags.get(274, (1,))[0]

    if photo in (0, 1):
        gray = img[:, :, 0]
        return "L", _orient(255 - gray if photo == 0 else gray, orientation), None
    if photo == 3:
        cmap = np.array(tags[320], np.int64).reshape(3, -1)[:, :256] // 256
        pal = np.zeros((256, 3), np.uint8)
        pal[:cmap.shape[1]] = cmap.T
        return "P", _orient(img[:, :, 0], orientation), pal
    if photo == 5:
        return "CMYK", _orient(img[:, :, :4], orientation), None
    rgb = img[:, :, :3]
    if spp >= 4 and extra[:1] == (1,):
        # associated alpha: Pillow's "RGBa" divides it out
        a = img[:, :, 3:4].astype(np.int64)
        div = np.where(a == 0, 1, a)
        rgb = np.where(a == 0, 0, np.where(a == 255, rgb, np.minimum(
            rgb.astype(np.int64) * 255 // div, 255))).astype(np.uint8)
    return "RGB", _orient(np.ascontiguousarray(rgb), orientation), None
