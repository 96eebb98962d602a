"""PNG reading and writing with the standard library's ``zlib``.

The port reads its test images and writes its restorations without Pillow.
Decoding covers what the repository's images and the usual encoders produce:
8-bit gray, gray+alpha, RGB and RGBA, non-interlaced, with all five row
filters (None, Sub, Up, Average, Paeth; PNG specification section 9).
Encoding writes 8-bit gray or RGB with filter 0 on every row.  Anything else
(palette images, 16-bit samples, Adam7 interlacing) raises ``ValueError``.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

__all__ = ["decode_png", "encode_png", "read_png", "write_png"]

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> samples per pixel (8-bit only)
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _chunks(data: bytes):
    pos = len(_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc_at = pos + 8 + length
        if len(body) != length or crc_at + 4 > len(data):
            raise ValueError("truncated PNG chunk")
        (crc,) = struct.unpack(">I", data[crc_at:crc_at + 4])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"bad CRC in PNG chunk {kind!r}")
        yield kind, body
        if kind == b"IEND":
            return
        pos = crc_at + 4
    raise ValueError("PNG ends without IEND")


def _paeth_row(filt: bytes, prior: bytes, bpp: int) -> bytearray:
    out = bytearray(filt)
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        b = prior[i]
        c = prior[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
        out[i] = (out[i] + pred) & 0xFF
    return out


def _average_row(filt: bytes, prior: bytes, bpp: int) -> bytearray:
    out = bytearray(filt)
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        out[i] = (out[i] + ((a + prior[i]) >> 1)) & 0xFF
    return out


def decode_png(data: bytes) -> np.ndarray:
    """Decode PNG bytes to a uint8 array (H, W, C), C in {1, 2, 3, 4}."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    header = None
    idat = []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"PLTE":
            raise ValueError("palette PNGs are not supported")
    if header is None:
        raise ValueError("PNG has no IHDR chunk")
    width, height, depth, colour, compression, filter_method, interlace = header
    if depth != 8 or colour not in _CHANNELS:
        raise ValueError(f"unsupported PNG: bit depth {depth}, colour type {colour}")
    if compression != 0 or filter_method != 0 or interlace != 0:
        raise ValueError("unsupported PNG: interlaced or non-standard method")
    bpp = _CHANNELS[colour]
    stride = width * bpp
    raw = zlib.decompress(b"".join(idat))
    if len(raw) != height * (stride + 1):
        raise ValueError("PNG image data has the wrong length")

    out = np.empty((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        ftype = raw[y * (stride + 1)]
        filt = raw[y * (stride + 1) + 1:(y + 1) * (stride + 1)]
        if ftype == 0:
            row = np.frombuffer(filt, np.uint8)
        elif ftype == 1:
            # Sub: running sum over pixels, per channel, modulo 256
            cum = np.frombuffer(filt, np.uint8).reshape(width, bpp)
            row = (np.cumsum(cum, axis=0, dtype=np.uint32) & 0xFF).astype(
                np.uint8).reshape(stride)
        elif ftype == 2:
            row = np.frombuffer(filt, np.uint8) + prior  # uint8 wraps mod 256
        elif ftype == 3:
            row = np.frombuffer(_average_row(filt, prior.tobytes(), bpp), np.uint8)
        elif ftype == 4:
            row = np.frombuffer(_paeth_row(filt, prior.tobytes(), bpp), np.uint8)
        else:
            raise ValueError(f"bad PNG filter type {ftype} on row {y}")
        out[y] = row
        prior = out[y]
    return out.reshape(height, width, bpp)


def encode_png(img: np.ndarray) -> bytes:
    """Encode a uint8 (H, W), (H, W, 1) or (H, W, 3) array as PNG bytes."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"encode_png takes uint8, got {img.dtype}")
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[:, :, 0]
    if img.ndim == 2:
        colour = 0
    elif img.ndim == 3 and img.shape[2] == 3:
        colour = 2
    else:
        raise ValueError(f"encode_png takes gray or RGB, got shape {img.shape}")
    height, width = img.shape[:2]
    rows = np.ascontiguousarray(img).reshape(height, -1)
    raw = np.concatenate([np.zeros((height, 1), np.uint8), rows], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    ihdr = struct.pack(">IIBBBBB", width, height, 8, colour, 0, 0, 0)
    return (_SIGNATURE + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())


def write_png(img: np.ndarray, path: str) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))
