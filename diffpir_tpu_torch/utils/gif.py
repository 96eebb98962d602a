"""GIF decoding of the first frame, as Pillow 12's ``GifImagePlugin`` opens it.

The first image of the file is decoded (LZW, interlaced or not) onto the
logical screen, widened to the frame where the frame reaches past it; the
rest of the screen holds the frame's transparent index where it has one, else
index 0.  The frame's colours are its local table, else the global one;
without a table (or with a table that is the gray ramp, which Pillow drops)
an index is its own gray level.  Entries past the table are black.  The
transparent index and every later frame are ignored, as a conversion of the
first frame to RGB or gray ignores them.
"""

from __future__ import annotations

import struct

import numpy as np

from diffpir_tpu_torch.utils.imageio import check_size

__all__ = ["decode_gif"]


def _blocks(data: bytes, pos: int) -> tuple[bytes, int]:
    """The data sub-blocks from ``pos`` joined, and the position after their
    terminator."""
    parts = []
    n = len(data)
    while pos < n:
        size = data[pos]
        pos += 1
        if size == 0:
            break
        parts.append(data[pos:pos + size])
        pos += size
    return b"".join(parts), pos


def _lzw(data: bytes, min_size: int, count: int) -> bytes:
    """Up to ``count`` indices from GIF's variable-width LZW (codes LSB
    first, widths from min_size + 1 to 12, no early change)."""
    if not 1 <= min_size <= 11:
        raise ValueError(f"GIF LZW minimum code size {min_size} is not supported")
    clear = 1 << min_size
    eoi = clear + 1
    data = data + bytes(4)
    nbits = 8 * (len(data) - 4)
    table = [bytes([i]) for i in range(clear)] + [b"", b""]
    size = min_size + 1
    out = bytearray()
    prev = None
    pos = 0
    while len(out) < count and pos + size <= nbits:
        at = pos >> 3
        code = (int.from_bytes(data[at:at + 3], "little") >> (pos & 7)) & ((1 << size) - 1)
        pos += size
        if code == clear:
            del table[eoi + 1:]
            size = min_size + 1
            prev = None
            continue
        if code == eoi:
            break
        if prev is None:
            if code >= len(table):
                raise ValueError("corrupt GIF data: bad LZW code")
            entry = table[code]
        elif code < len(table):
            entry = table[code]
            if len(table) < 4096:
                table.append(prev + entry[:1])
        elif code == len(table):
            entry = prev + prev[:1]
            if len(table) < 4096:
                table.append(entry)
        else:
            raise ValueError("corrupt GIF data: bad LZW code")
        out += entry
        prev = entry
        if len(table) == 1 << size and size < 12:
            size += 1
    return bytes(out[:count])


def decode_gif(data: bytes):
    """Decode GIF bytes to ``(mode, pixels, palette)`` of the first frame:
    ``"P"`` (h, w) indices with a (256, 3) palette, or ``"L"``."""
    if data[:6] not in (b"GIF87a", b"GIF89a") or len(data) < 13:
        raise ValueError("not a GIF file")
    width, height, flags = struct.unpack_from("<HHB", data, 6)
    pos = 13

    def table(flags_byte: int, at: int):
        size = 3 << ((flags_byte & 7) + 1)
        raw = np.frombuffer(data[at:at + size], np.uint8)
        ramp = len(raw) == size and all(
            raw[i] == raw[i + 1] == raw[i + 2] == i // 3 for i in range(0, size, 3))
        pal = np.zeros((256, 3), np.uint8)
        entries = raw[:len(raw) // 3 * 3].reshape(-1, 3)[:256]
        pal[:len(entries)] = entries
        return (None if ramp else pal), at + size

    palette = None
    if flags & 128:
        palette, pos = table(flags, pos)
    transparency = None
    n = len(data)
    while True:
        if pos >= n or data[pos] == 0x3B:
            raise ValueError("GIF without an image")
        kind = data[pos]
        pos += 1
        if kind == 0x21:            # extension
            label = data[pos]
            block_at = pos + 1
            body, pos = _blocks(data, block_at)
            if label == 0xF9 and data[block_at] >= 4 and body[0] & 1:
                transparency = body[3]
        elif kind == 0x2C:          # image descriptor
            x0, y0, fw, fh, iflags = struct.unpack_from("<HHHHB", data, pos)
            pos += 9
            if iflags & 128:
                palette, pos = table(iflags, pos)
            min_size = data[pos]
            lzw, pos = _blocks(data, pos + 1)
            break
        # any other byte between blocks is skipped, as Pillow does
    x1, y1 = x0 + fw, y0 + fh
    width, height = max(width, x1), max(height, y1)
    check_size("GIF", width, height)
    canvas = np.full((height, width), transparency or 0, np.uint8)
    pixels = np.frombuffer(_lzw(lzw, min_size, fw * fh), np.uint8)
    if fw and fh:
        frame = canvas[y0:y1, x0:x1]
        rows = np.arange(fh)
        if iflags & 64:   # interlaced: rows 0, 8, ..; 4, 12, ..; 2, 6, ..; 1, 3, ..
            rows = np.concatenate([np.arange(0, fh, 8), np.arange(4, fh, 8),
                                   np.arange(2, fh, 4), np.arange(1, fh, 2)])
        full, rest = divmod(len(pixels), fw)
        frame[rows[:full]] = pixels[:full * fw].reshape(full, fw)
        if rest:
            frame[rows[full], :rest] = pixels[full * fw:]
    if palette is None:
        return "L", canvas, None
    return "P", canvas, palette
