"""Image decoding without Pillow: the decoder is picked by the file's first
bytes, as Pillow's ``Image.open`` does, not by its extension.

``decode_image(data, mode)`` returns what Pillow 12's
``Image.open(f).convert(mode)`` returns, bit for bit, for ``mode`` "RGB"
((h, w, 3) uint8) or "L" ((h, w) uint8), on PNG (``png.py``), JPEG
(``jpeg.py``), BMP (``bmp.py``), PPM/PGM/PBM (``netpbm.py``), GIF
(``gif.py``, the first frame) and TIFF (``tiff.py``).  Each decoder returns
``(mode, pixels, palette)`` as Pillow opens the file ("L", "RGB", "P" with
a (256, 3) palette, "I" for samples past 8 bits, "CMYK"), and ``to_mode``
converts as Pillow's ``convert`` does: gray repeated to RGB, RGB to gray by
the ITU-R 601-2 luma in fixed point (19595, 38470, 7471), a palette through
its colours, "I" clipped to [0, 255], CMYK by Pillow's ``cmyk2rgb``.
Alpha and transparency are dropped.  What a decoder does not read raises
``ValueError`` naming the feature, and so does data that breaks off or
contradicts itself ("corrupt <format> data").  Every decoder refuses, from
its header and before it allocates the image, more than ``MAX_PIXELS``
pixels, as Pillow's ``Image.open`` refuses a decompression bomb.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

__all__ = ["decode_image", "read_image", "to_mode", "sniff", "check_size", "MAX_PIXELS"]

# Pillow's decompression-bomb limit: Image.open raises DecompressionBombError
# above twice Image.MAX_IMAGE_PIXELS (89478485) pixels
MAX_PIXELS = 2 * 89478485


def check_size(fmt: str, width: int, height: int) -> None:
    """Refuse an image of more than ``MAX_PIXELS`` pixels, or of none."""
    if width <= 0 or height <= 0:
        raise ValueError(f"{fmt} image of {width}x{height} pixels is empty")
    if width * height > MAX_PIXELS:
        raise ValueError(f"{fmt} image of {width}x{height} pixels is over the limit of "
                         f"{MAX_PIXELS} pixels (Pillow's decompression-bomb limit)")


def sniff(data: bytes) -> str:
    """The format of ``data`` from its first bytes."""
    if data[:8] == b"\x89PNG\r\n\x1a\n":
        return "PNG"
    if data[:3] == b"\xff\xd8\xff":
        return "JPEG"
    if data[:2] == b"BM":
        return "BMP"
    if data[:6] in (b"GIF87a", b"GIF89a"):
        return "GIF"
    if data[:4] in (b"II*\x00", b"MM\x00*"):
        return "TIFF"
    if len(data) >= 2 and data[:1] == b"P" and data[1:2] in b"123456":
        return "PPM"
    raise ValueError("unknown image format (not PNG, JPEG, BMP, GIF, TIFF or "
                     "PPM/PGM/PBM)")


def _luma(rgb: np.ndarray) -> np.ndarray:
    c = rgb.astype(np.uint32)
    y = c[..., 0] * 19595 + c[..., 1] * 38470 + c[..., 2] * 7471 + 0x8000
    return (y >> 16).astype(np.uint8)


def to_mode(mode: str, pixels: np.ndarray, palette, target: str) -> np.ndarray:
    """Pillow's ``convert(target)`` of an image opened as ``mode``."""
    if mode == "P":
        pixels = palette[pixels]
        mode = "RGB"
    elif mode == "I":
        pixels = np.clip(pixels, 0, 255).astype(np.uint8)
        mode = "L"
    elif mode == "CMYK":
        from diffpir_tpu_torch.utils.jpeg import cmyk_to_rgb

        pixels = cmyk_to_rgb(pixels)
        mode = "RGB"
    if target == "RGB":
        if mode == "L":
            return np.repeat(pixels[:, :, None], 3, axis=2)
        return np.ascontiguousarray(pixels)
    if target == "L":
        return pixels if mode == "L" else _luma(pixels)
    raise ValueError(f"decode_image converts to 'RGB' or 'L', not {target!r}")


def decode_image(data: bytes, mode: str = "RGB") -> np.ndarray:
    """Image file bytes -> uint8 (h, w, 3) for "RGB" or (h, w) for "L"."""
    fmt = sniff(data)
    if fmt == "PNG":
        from diffpir_tpu_torch.utils.png import decode_png as dec
    elif fmt == "JPEG":
        from diffpir_tpu_torch.utils.jpeg import decode_jpeg as dec
    elif fmt == "BMP":
        from diffpir_tpu_torch.utils.bmp import decode_bmp as dec
    elif fmt == "GIF":
        from diffpir_tpu_torch.utils.gif import decode_gif as dec
    elif fmt == "TIFF":
        from diffpir_tpu_torch.utils.tiff import decode_tiff as dec
    else:
        from diffpir_tpu_torch.utils.netpbm import decode_netpbm as dec
    try:
        decoded = dec(data)
    except (IndexError, KeyError, struct.error, zlib.error, OverflowError) as e:
        raise ValueError(f"corrupt {fmt} data: {type(e).__name__}: {e}") from e
    return to_mode(*decoded, mode)


def read_image(path: str, mode: str = "RGB") -> np.ndarray:
    with open(path, "rb") as f:
        return decode_image(f.read(), mode)
