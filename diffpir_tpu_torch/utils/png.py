"""PNG reading and writing with the standard library's ``zlib``.

The port reads images and writes its restorations without Pillow.  Decoding
covers the whole of the PNG specification's image data: gray, RGB, gray+alpha
and RGBA at every bit depth it allows (1, 2, 4, 8 and 16 for gray, 8 and 16
otherwise), palette images of 1, 2, 4 and 8 bits with ``PLTE`` (``tRNS`` is
read past: a conversion to RGB or gray drops transparency), Adam7
interlacing, and all five row filters (None, Sub, Up, Average, Paeth; section
9).  ``decode_png`` returns the image as Pillow opens it, so that
``imageio.to_mode`` can convert it as Pillow's ``convert`` does:

  * gray of 1, 2 or 4 bits: ``"L"``, scaled to 8 bits (1 -> 255, 85 or 17);
  * gray of 16 bits: ``"I"`` (Pillow's ``I;16``), converted by clipping at 255;
  * gray+alpha, RGB and RGBA of 16 bits: the high byte of each sample;
  * alpha is dropped; palette images stay ``"P"`` with their palette.

Encoding writes 8-bit gray or RGB with filter 0 on every row.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from diffpir_tpu_torch.utils.imageio import check_size

__all__ = ["decode_png", "encode_png", "read_png", "write_png"]

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> samples per pixel
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
# Adam7 passes: (x0, y0, dx, dy)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
          (1, 0, 2, 2), (0, 1, 1, 2))


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


def _unfilter(raw: bytes, pos: int, stride: int, height: int, bpp: int):
    """Undo the row filters of ``height`` rows of ``stride`` bytes starting at
    ``raw[pos]``; returns (rows (height, stride) uint8, position after)."""
    if pos + height * (stride + 1) > len(raw):
        raise ValueError("PNG image data has the wrong length")
    out = np.empty((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        at = pos + y * (stride + 1)
        ftype = raw[at]
        filt = raw[at + 1:at + 1 + stride]
        if ftype == 0:
            row = np.frombuffer(filt, np.uint8)
        elif ftype == 1:
            # Sub: running sum over pixels, per byte of the pixel, modulo 256
            pad = -stride % bpp
            cum = np.frombuffer(filt + bytes(pad), np.uint8).reshape(-1, bpp)
            row = (np.cumsum(cum, axis=0, dtype=np.uint32) & 0xFF).astype(
                np.uint8).reshape(-1)[:stride]
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
    return out, pos + height * (stride + 1)


def _samples(rows: np.ndarray, width: int, depth: int, channels: int) -> np.ndarray:
    """Unfiltered rows -> (h, width, channels) samples (uint16 at depth 16)."""
    h = rows.shape[0]
    n = width * channels
    if depth == 8:
        return rows[:, :n].reshape(h, width, channels)
    if depth == 16:
        s = rows[:, :2 * n].reshape(h, n, 2).astype(np.uint16)
        return ((s[..., 0] << 8) | s[..., 1]).reshape(h, width, channels)
    bits = np.unpackbits(rows, axis=1)[:, :n * depth].reshape(h, n, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(axis=2, dtype=np.uint8).reshape(h, width, channels)


def decode_png(data: bytes):
    """Decode PNG bytes to ``(mode, pixels, palette)`` as Pillow opens the
    file (see the module's text): ``"L"`` (h, w) uint8, ``"I"`` (h, w) int32,
    ``"RGB"`` (h, w, 3) uint8, or ``"P"`` (h, w) indices with a (256, 3)
    palette, entries past ``PLTE`` black."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    header = None
    idat = []
    plte = None
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"PLTE":
            plte = body
    if header is None:
        raise ValueError("PNG has no IHDR chunk")
    width, height, depth, colour, compression, filter_method, interlace = header
    if colour not in _CHANNELS or depth not in _DEPTHS[colour]:
        raise ValueError(f"unsupported PNG: bit depth {depth}, colour type {colour}")
    if compression != 0 or filter_method != 0 or interlace not in (0, 1):
        raise ValueError("unsupported PNG: non-standard compression, filter or "
                         "interlace method")
    if colour == 3 and plte is None:
        raise ValueError("palette PNG without a PLTE chunk")
    check_size("PNG", width, height)
    channels = _CHANNELS[colour]
    bits = depth * channels
    bpp = max(1, bits // 8)
    # inflated no further than the rows need (and one byte to tell a stream
    # that holds more)
    passes = [(width, height)] if interlace == 0 else [
        ((width - x0 + dx - 1) // dx, (height - y0 + dy - 1) // dy)
        for x0, y0, dx, dy in _ADAM7 if width > x0 and height > y0]
    expected = sum(ph * ((pw * bits + 7) // 8 + 1) for pw, ph in passes)
    inflate = zlib.decompressobj()
    raw = inflate.decompress(b"".join(idat), expected + 1)
    if len(raw) <= expected and not inflate.eof:
        raise ValueError("corrupt PNG data: the zlib stream breaks off")

    if interlace == 0:
        rows, end = _unfilter(raw, 0, (width * bits + 7) // 8, height, bpp)
        img = _samples(rows, width, depth, channels)
    else:
        dtype = np.uint16 if depth == 16 else np.uint8
        img = np.zeros((height, width, channels), dtype)
        end = 0
        for x0, y0, dx, dy in _ADAM7:
            pw = (width - x0 + dx - 1) // dx if width > x0 else 0
            ph = (height - y0 + dy - 1) // dy if height > y0 else 0
            if pw == 0 or ph == 0:
                continue
            rows, end = _unfilter(raw, end, (pw * bits + 7) // 8, ph, bpp)
            img[y0::dy, x0::dx] = _samples(rows, pw, depth, channels)
    if end != len(raw):
        raise ValueError("PNG image data has the wrong length")

    if colour == 3:
        pal = np.zeros((256, 3), np.uint8)
        entries = np.frombuffer(plte[:len(plte) // 3 * 3], np.uint8).reshape(-1, 3)[:256]
        pal[:len(entries)] = entries
        return "P", img[:, :, 0], pal
    if depth == 16:
        if colour == 0:
            return "I", img[:, :, 0].astype(np.int32), None
        img = (img >> 8).astype(np.uint8)
    elif depth < 8:
        img = img * np.uint8(255 // ((1 << depth) - 1))
    if colour in (0, 4):
        return "L", np.ascontiguousarray(img[:, :, 0]), None
    return "RGB", np.ascontiguousarray(img[:, :, :3]), None


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
    """A PNG file as (H, W, 3) uint8 RGB (``imageio.decode_image``)."""
    from diffpir_tpu_torch.utils.imageio import decode_image

    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"not a PNG file: {path!r}")
    return decode_image(data, "RGB")


def write_png(img: np.ndarray, path: str) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))
