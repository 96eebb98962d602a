"""PBM, PGM and PPM decoding (P1 to P6), as Pillow 12's ``PpmImagePlugin``.

Pillow opens P1/P4 as bilevel (a set bit or a "1" is black), P2/P5 as gray
and P3/P6 as RGB.  A maxval other than 255 is scaled as Pillow scales it,
``round(v / maxval * top)`` in double precision with ties to even, where
``top`` is 65535 for gray of maxval above 255 (Pillow's mode "I", whose
conversion to 8 bits then clips at 255) and 255 otherwise; gray of maxval
65535 in raw form is read unscaled as 16-bit.  Header comments run from "#"
to the end of the line; in the plain formats Pillow cuts them out of the
data with their line end, and this module does the same.
"""

from __future__ import annotations

import numpy as np

from diffpir_tpu_torch.utils.imageio import check_size

__all__ = ["decode_netpbm"]

_WHITESPACE = b" \t\n\x0b\x0c\r"


def _token(data: bytes, pos: int) -> tuple[bytes, int]:
    """Pillow's header token: skip whitespace and comments, read to the next
    whitespace (which is consumed)."""
    token = b""
    n = len(data)
    while len(token) <= 10:
        if pos >= n:
            break
        c = data[pos:pos + 1]
        pos += 1
        if c in _WHITESPACE:
            if not token:
                continue
            break
        if c == b"#":
            while pos < n and data[pos:pos + 1] not in b"\r\n":
                pos += 1
            pos += 1
            continue
        token += c
    if not token:
        raise ValueError("PPM header ends early")
    if len(token) > 10:
        raise ValueError("PPM header token too long")
    return token, pos


def _strip_comments(block: bytes) -> bytes:
    while True:
        start = block.find(b"#")
        if start < 0:
            return block
        ends = [e for e in (block.find(b"\n", start), block.find(b"\r", start)) if e >= 0]
        if not ends:
            return block[:start]
        block = block[:start] + block[min(ends) + 1:]


def _scale(v: np.ndarray, maxval: int, top: int) -> np.ndarray:
    return np.minimum(top, np.rint(v.astype(np.float64) / maxval * top)).astype(np.int64)


def decode_netpbm(data: bytes):
    """Decode P1..P6 bytes to ``(mode, pixels, None)``: ``"L"`` (h, w)
    uint8, ``"I"`` (h, w) int32 (gray past 8 bits) or ``"RGB"`` (h, w, 3)."""
    magic = data[:2]
    if magic[:1] != b"P" or magic[1:2] not in (b"1", b"2", b"3", b"4", b"5", b"6") \
            or (len(data) > 2 and data[2:3] not in _WHITESPACE):
        raise ValueError("not a PBM/PGM/PPM file (P1 to P6)")
    kind = int(magic[1:2])
    pos = 3
    w, pos = _token(data, pos)
    h, pos = _token(data, pos)
    width, height = int(w), int(h)
    check_size("PPM", width, height)
    bands = 3 if kind in (3, 6) else 1
    count = width * height * bands
    if kind in (1, 4):
        if kind == 1:
            digits = b"".join(_strip_comments(data[pos:]).split())
            if digits.strip(b"01"):
                raise ValueError("PBM data holds a token other than 0 and 1")
            bits = np.frombuffer(digits[:count], np.uint8) - ord("0")
            if len(bits) < count:
                raise ValueError("truncated PBM data")
        else:
            stride = (width + 7) // 8
            raw = np.frombuffer(data[pos:pos + stride * height], np.uint8)
            if len(raw) < stride * height:
                raise ValueError("truncated PBM data")
            bits = np.unpackbits(raw.reshape(height, stride), axis=1)[:, :width]
        return "L", np.where(bits.reshape(height, width) == 1, 0, 255).astype(np.uint8), None
    m, pos = _token(data, pos)
    maxval = int(m)
    if not 0 < maxval < 65536:
        raise ValueError("PPM maxval must be in 1..65535")
    gray_i = bands == 1 and maxval > 255
    top = 65535 if gray_i else 255
    if kind in (2, 3):
        tokens = _strip_comments(data[pos:]).split()[:count]
        if len(tokens) < count:
            raise ValueError("truncated plain PPM data")
        if any(len(t) > 10 for t in tokens):
            raise ValueError("PPM data token too long")
        v = np.array([int(t) for t in tokens], np.int64)
        if (v < 0).any() or (v > maxval).any():
            raise ValueError("PPM data value out of range")
        v = np.rint(v.astype(np.float64) / maxval * top).astype(np.int64)
    else:
        size = 2 if maxval > 255 else 1
        raw = np.frombuffer(data[pos:pos + count * size], ">u2" if size == 2 else np.uint8)
        if len(raw) < count:
            raise ValueError("truncated PPM data")
        v = raw.astype(np.int64)
        if not (maxval == 255 or (gray_i and maxval == 65535)):
            v = _scale(v, maxval, top)
    if gray_i:
        return "I", v.reshape(height, width).astype(np.int32), None
    shape = (height, width, 3) if bands == 3 else (height, width)
    return ("RGB" if bands == 3 else "L"), v.reshape(shape).astype(np.uint8), None
