"""The port's image decoders (``diffpir_tpu_torch/utils/imageio.py`` and the
format modules beside it) held bit for bit to Pillow's
``Image.open(f).convert("RGB")`` and ``.convert("L")``, on files that Pillow
writes here, or that ``tests/_image_writers.py`` writes where Pillow writes
no such file (2- and 4-bit and 16-bit colour PNGs, Adam7, JPEG sampling
factors, scans per component, BMP bitfields and RLE, TIFF tags); each
refused feature raises a ``ValueError`` that names it.  Then the readers
that go through the decoders against the JAX package's, which go through
Pillow: ``imread_uint`` on every file of ``testsets/demo64_formats`` (whose
committed digests Pillow must reproduce), the data path on a JPEG copy of
``testsets/demo32``, and the HTTP handler's ``image/png`` body."""

import concurrent.futures
import hashlib
import io
import json
import os
import struct
import sys
import types
import urllib.request
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from diffpir_tpu import config as jconfig
from diffpir_tpu import data as jdata
from diffpir_tpu import server_http as jserver_http
from diffpir_tpu.utils import image as jim
from diffpir_tpu_torch import config as tconfig
from diffpir_tpu_torch import data as tdata
from diffpir_tpu_torch import server_http as tserver_http
from diffpir_tpu_torch.utils import image as tim
from diffpir_tpu_torch.utils import imageio
from tests._image_writers import (bmp_bytes, jpeg_bytes, jpeg_segments, png_bytes,
                                  tiff_bytes)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORMATS = os.path.join(ROOT, "testsets", "demo64_formats")
ODD = (17, 23)          # every variant at an odd size
SECOND = (64, 48)       # and a second where the size takes another path


def _sizes(names, twice=(), more=()):
    """(name, size) cases: every name at ``ODD``, those in ``twice`` also at
    ``SECOND``, and the (name, size) pairs of ``more``."""
    return ([(n, ODD) for n in names] + [(n, SECOND) for n in names if n in twice]
            + list(more))


def _size_id(v):
    return f"{v[0]}x{v[1]}" if isinstance(v, tuple) else str(v)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _rgb(h: int, w: int, seed: int = 0) -> np.ndarray:
    """Smooth gradients with noise: every value range, and runs that JPEG
    and the PNG filters meet in photographs."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    a = np.stack([(x * 7 + y * 3) % 256, (x * y) % 256,
                  128 + 60 * np.sin(x / 5.0 + y / 7.0)], 2)
    return np.clip(a + rng.normal(0, 20, a.shape), 0, 255).astype(np.uint8)


def _save(img: Image.Image, fmt: str, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, fmt, **kw)
    return buf.getvalue()


def _pillow(data: bytes, mode: str) -> np.ndarray:
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert(mode))


def _assert_as_pillow(data: bytes) -> None:
    for mode in ("RGB", "L"):
        got = imageio.decode_image(data, mode)
        ref = _pillow(data, mode)
        assert got.dtype == np.uint8 and got.shape == ref.shape, mode
        np.testing.assert_array_equal(got, ref, err_msg=mode)


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------

def _palette(rng, n):
    return rng.integers(0, 256, (n, 3))


def _png_case(name, rgb, rng):
    h, w = rgb.shape[:2]
    kind, _, rest = name.partition("_")
    interlace = "adam7" in name
    if name.startswith("pillow"):
        mode = rest.split("_")[0]
        im = Image.fromarray(rgb)
        im = {"P": im.quantize(37), "RGBA": Image.fromarray(np.dstack([rgb, rgb[..., 1]])),
              "LA": im.convert("LA"), "I;16": Image.fromarray(
                  rng.integers(0, 1200, (h, w)).astype(np.uint16))}.get(mode) or im.convert(mode)
        return _save(im, "PNG")
    if kind == "gray":
        depth = int(rest.split("_")[0])
        return png_bytes(rng.integers(0, 1 << depth, (h, w)), depth, 0, interlace)
    if kind in ("rgb", "la", "rgba"):
        depth = int(rest.split("_")[0])
        c, colour = {"rgb": (3, 2), "la": (2, 4), "rgba": (4, 6)}[kind]
        samples = rng.integers(0, 1 << depth, (h, w, c))
        if depth == 16:   # values near the bytes' edges, and high bytes from the image
            samples[..., 0] = rgb[..., 0].astype(np.int64) * 256 + rng.integers(0, 256, (h, w))
        return png_bytes(samples, depth, colour, interlace)
    if kind == "palette":
        depth = int(rest.split("_")[0])
        n = 1 << depth
        short = "short" in name
        pal = _palette(rng, max(1, n - 3) if short else n)
        trns = bytes(rng.integers(0, 256, min(n, 5)).astype(np.uint8)) if "trns" in name else None
        return png_bytes(rng.integers(0, n, (h, w)), depth, 3, interlace, plte=pal, trns=trns)
    if name == "gray8_trns":
        return png_bytes(rgb[..., 0], 8, 0, trns=struct.pack(">H", 7))
    raise KeyError(name)


PNG_CASES = ["gray_1", "gray_2", "gray_4", "gray_8", "gray_16", "rgb_8", "rgb_16", "la_8",
             "la_16", "rgba_8", "rgba_16", "palette_1_trns", "palette_2", "palette_4_trns",
             "palette_8", "palette_8_short", "gray8_trns", "gray_1_adam7", "gray_4_adam7",
             "gray_16_adam7", "rgb_8_adam7", "rgba_16_adam7", "la_8_adam7",
             "palette_4_adam7", "palette_8_trns_adam7", "pillow_L", "pillow_LA",
             "pillow_RGB", "pillow_RGBA", "pillow_P", "pillow_1", "pillow_I;16"]


# sub-byte rows end inside a byte at the odd width and on one at the second;
# Adam7's passes differ in number and size between the two
@pytest.mark.parametrize("name,size", _sizes(
    PNG_CASES, twice=[n for n in PNG_CASES if "adam7" in n]
    + ["gray_1", "gray_2", "gray_4", "palette_1_trns", "palette_2"]), ids=_size_id)
def test_png_as_pillow(name, size):
    rng = np.random.default_rng(len(name) * 7 + size[0])
    _assert_as_pillow(_png_case(name, _rgb(*size, seed=size[1]), rng))


def test_png_refusals_name_the_fault():
    good = png_bytes(np.zeros((3, 3)), 8, 0)
    with pytest.raises(ValueError, match="CRC"):
        imageio.decode_image(good[:20] + bytes([good[20] ^ 1]) + good[21:])
    with pytest.raises(ValueError, match="bit depth 16, colour type 3"):
        imageio.decode_image(png_bytes(np.zeros((3, 3)), 16, 3, plte=np.zeros((4, 3))))
    with pytest.raises(ValueError, match="without a PLTE"):
        imageio.decode_image(png_bytes(np.zeros((3, 3)), 8, 3))
    with pytest.raises(ValueError, match="unknown image format"):
        imageio.decode_image(b"\x89PNX" + good[4:])


# ---------------------------------------------------------------------------
# JPEG
# ---------------------------------------------------------------------------

def _ycc_planes(rgb):
    r, g, b = (rgb[..., i].astype(np.float64) for i in range(3))
    y = 0.299 * r + 0.587 * g + 0.114 * b
    return [y, (b - y) * 0.564 + 128, (r - y) * 0.713 + 128]


def _adobe_cmyk(rgb, transform):
    c = np.dstack([rgb, rgb[..., :1] // 2])
    data = _save(Image.fromarray(c, "CMYK"), "JPEG", quality=90)
    at = data.find(b"Adobe")
    if transform is None:   # no Adobe marker at all
        start = data.rfind(b"\xff\xee", 0, at)
        return data[:start] + data[start + 2 + struct.unpack(">H", data[start + 2:start + 4])[0]:]
    out = bytearray(data)
    out[at + 11] = transform
    return bytes(out)


def _jpeg_case(name, rgb):
    im = Image.fromarray(rgb)
    prog = name.endswith("_prog")
    base = name[:-5] if prog else name
    pillow = {
        "444": dict(subsampling=0), "422": dict(subsampling=1), "420": dict(subsampling=2),
        "411": dict(subsampling="4:1:1"), "q100": dict(quality=100), "q5": dict(quality=5),
        "optimize": dict(optimize=True), "restart_blocks": dict(restart_marker_blocks=3),
        "restart_rows": dict(restart_marker_rows=1), "keep_rgb": dict(keep_rgb=True)}
    if base in pillow:
        return _save(im, "JPEG", progressive=prog, **{"quality": 90, **pillow[base]})
    if base == "gray":
        return _save(im.convert("L"), "JPEG", quality=85, progressive=prog)
    if base == "cmyk":
        c = np.dstack([rgb, rgb[..., :1] // 2])
        return _save(Image.fromarray(c, "CMYK"), "JPEG", quality=90, progressive=prog)
    if base == "ycck":
        return _adobe_cmyk(rgb, 2)
    if base == "cmyk_no_adobe":
        return _adobe_cmyk(rgb, None)
    planes = _ycc_planes(rgb)
    written = {
        "440": dict(sampling=[(1, 2), (1, 1), (1, 1)]),
        "mixed": dict(sampling=[(2, 2), (1, 2), (2, 1)]),
        "chroma_full": dict(sampling=[(1, 1), (2, 2), (1, 1)]),
        "per_component_scans": dict(sampling=[(2, 2), (1, 1), (1, 1)], interleaved=False,
                                    restart=5),
        "restart_420": dict(sampling=[(2, 2), (1, 1), (1, 1)], restart=2),
        "rgb_ids": dict(sampling=[(1, 1)] * 3, ids=(82, 71, 66), jfif=False),
    }
    if base in written:
        kw = written[base]
        src = [rgb[..., i] for i in range(3)] if base == "rgb_ids" else planes
        return jpeg_bytes(src, **kw)
    if base == "gray_2x2":
        return jpeg_bytes(planes[:1], [(2, 2)], ids=(1,))
    raise KeyError(name)


JPEG_CASES = ["444", "444_prog", "422", "422_prog", "420", "420_prog", "411", "411_prog",
              "q100", "q5", "q5_prog", "optimize", "restart_blocks", "restart_blocks_prog",
              "restart_rows", "restart_rows_prog", "keep_rgb", "keep_rgb_prog", "gray",
              "gray_prog", "cmyk", "cmyk_prog", "ycck", "cmyk_no_adobe", "440", "mixed",
              "chroma_full", "per_component_scans", "restart_420", "rgb_ids", "gray_2x2"]


# subsampled chroma at 3x3 and 9x5 (planes of two samples or fewer, where
# the triangle filters give way to replication, and partial MCUs), and whole
# MCUs at the second size
_SUBSAMPLED = ["420", "420_prog", "422", "422_prog", "411", "440", "mixed", "chroma_full",
               "gray_2x2"]


@pytest.mark.parametrize("name,size", _sizes(
    JPEG_CASES, twice=["444", "420", "420_prog", "restart_420"],
    more=[(n, s) for n in _SUBSAMPLED for s in ((3, 3), (9, 5))]), ids=_size_id)
def test_jpeg_as_pillow(name, size):
    _assert_as_pillow(_jpeg_case(name, _rgb(*size, seed=size[0])))


def _patched_sof(data: bytes, marker: int) -> bytes:
    at = next(s for m, s, _ in jpeg_segments(data) if m in (0xC0, 0xC1, 0xC2))
    return data[:at + 1] + bytes([marker]) + data[at + 2:]


def _inserted(data: bytes, marker: int, body: bytes) -> bytes:
    return data[:2] + bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body + data[2:]


def _patched_component(data: bytes, comp: int, field: int, value: int) -> bytes:
    """``data`` with byte ``field`` of frame component ``comp`` (0 its id, 1
    its sampling factors, 2 its table; -2 the count of components) set."""
    at = next(s for m, s, _ in jpeg_segments(data) if m in (0xC0, 0xC1, 0xC2))
    i = at + 9 if field == -2 else at + 10 + 3 * comp + field
    return data[:i] + bytes([value]) + data[i + 1:]


def _dc_scans_only(data: bytes) -> bytes:
    """A progressive file cut after its first scan: every AC coefficient is
    left unrefined, where libjpeg smooths the blocks."""
    segs = jpeg_segments(data)
    first = next(i for i, (m, _, _) in enumerate(segs) if m == 0xDA)
    return data[:segs[first][2]] + b"\xff\xd9"


@pytest.mark.parametrize("fault,match", [
    ("arithmetic", "arithmetic-coded JPEG"), ("dac", "arithmetic-coded JPEG"),
    ("12bit", "12-bit JPEG samples"), ("lossless", "lossless"),
    ("hierarchical", "hierarchical JPEG"), ("dhp", "hierarchical JPEG"),
    ("smoothing", "block smoothing"), ("garbage", "corrupt JPEG"),
    ("sampling_0", "sampling factors 0x1 are outside 1..4"),
    ("sampling_5", "sampling factors 5x1 are outside 1..4"),
    ("two_components", "2 components")])
def test_jpeg_refusals_name_the_feature(fault, match):
    rgb = _rgb(17, 23)
    base = _save(Image.fromarray(rgb), "JPEG", quality=90)
    data = {
        "arithmetic": lambda: _patched_sof(base, 0xC9),
        "dac": lambda: _inserted(base, 0xCC, b"\x00\x10"),
        "12bit": lambda: base.replace(b"\xff\xc0\x00\x11\x08", b"\xff\xc0\x00\x11\x0c", 1),
        "lossless": lambda: _patched_sof(base, 0xC3),
        "hierarchical": lambda: _patched_sof(base, 0xC5),
        "dhp": lambda: _inserted(base, 0xDE, base[base.find(b"\xff\xc0") + 4:][:15]),
        "smoothing": lambda: _dc_scans_only(
            _save(Image.fromarray(rgb), "JPEG", quality=90, progressive=True)),
        "garbage": lambda: b"\xff\xd8\xff\xe0 not a JPEG at all",
        "sampling_0": lambda: _patched_component(base, 0, 1, 0x01),
        "sampling_5": lambda: _patched_component(base, 0, 1, 0x51),
        "two_components": lambda: _patched_component(base, 0, -2, 2),
    }[fault]()
    with pytest.raises(ValueError, match=match):
        imageio.decode_image(data)
    if fault == "smoothing":   # Pillow decodes it, with libjpeg's smoothing
        assert _pillow(data, "RGB").shape == (17, 23, 3)


def test_jpeg_imagenet_size_decodes_quickly_enough():
    """A 500x375 4:2:0 JPEG, an ImageNet validation image's size: equal to
    Pillow, and decoded within a few seconds on this box (the card's host
    time is what phase ``formats`` records)."""
    import time

    path = os.path.join(FORMATS, "imagenet_size", "synth0_500x375.jpg")
    with open(path, "rb") as f:
        data = f.read()
    t0 = time.perf_counter()
    got = imageio.decode_image(data)
    assert time.perf_counter() - t0 < 5.0
    np.testing.assert_array_equal(got, _pillow(data, "RGB"))


# ---------------------------------------------------------------------------
# BMP, PPM, GIF, TIFF
# ---------------------------------------------------------------------------

def _bmp_case(name, rgb, rng):
    h, w = rgb.shape[:2]
    if name.startswith("pillow_"):
        mode = name[7:]
        im = Image.fromarray(rgb)
        im = (im.quantize(37) if mode == "P" else
              Image.fromarray(np.dstack([rgb, rgb[..., 1]])) if mode == "RGBA" else im.convert(mode))
        return _save(im, "BMP")
    pal = [tuple(int(v) for v in c) for c in rng.integers(0, 256, (16, 3))]
    idx = rng.integers(0, 16, (h, w)).astype(np.uint8)
    rows4 = [bytes((int(r[i]) << 4) | (int(r[i + 1]) if i + 1 < w else 0)
                   for i in range(0, w, 2)) for r in idx]
    v16 = rng.integers(0, 65536, (h, w)).astype("<u2")
    v32 = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    if name in ("4bit", "4bit_top_down"):
        return bmp_bytes(w, h, 4, rows4, pal, top_down=name.endswith("down"))
    if name == "8bit_short_palette":
        return bmp_bytes(w, h, 8, [bytes(r) for r in rng.integers(0, 20, (h, w)).astype(np.uint8)],
                         pal)
    if name == "8bit_os2":
        return bmp_bytes(w, h, 8, [bytes(r) for r in idx], pal, header=12)
    if name == "16bit":
        return bmp_bytes(w, h, 16, [r.tobytes() for r in v16])
    if name in ("16bit_565", "16bit_555"):
        masks = (0xF800, 0x7E0, 0x1F) if name.endswith("565") else (0x7C00, 0x3E0, 0x1F)
        return bmp_bytes(w, h, 16, [r.tobytes() for r in v16], compression=3, masks=masks)
    if name == "24bit_top_down":
        return bmp_bytes(w, h, 24, [r[:, ::-1].tobytes() for r in rgb], top_down=True)
    if name == "32bit":
        return bmp_bytes(w, h, 32, [r.tobytes() for r in v32])
    if name.startswith("32bit_bf"):
        masks = {"32bit_bf_bgrx": (0xFF0000, 0xFF00, 0xFF, 0),
                 "32bit_bf_rgba": (0xFF, 0xFF00, 0xFF0000, 0xFF000000),
                 "32bit_bf_abgr": (0xFF000000, 0xFF0000, 0xFF00, 0xFF)}[name]
        return bmp_bytes(w, h, 32, [r.tobytes() for r in v32], compression=3, masks=masks,
                         header=108 if masks[3] else 40)
    if name == "rle8":
        out = bytearray()
        for y in range(h):
            if y == 3:
                out += bytes([0, 2, 9, 9, 3, 1])  # a delta, its offsets where Pillow reads them
                continue
            out += bytes([5, y % 16, 0, 7]) + bytes(rng.integers(0, 16, 7).tolist()) + b"\x00"
            out += bytes([3, 9, 0, 0])
        return bmp_bytes(w, h, 8, palette=pal, compression=1, rle=bytes(out) + b"\x00\x01")
    if name == "rle4":
        out = bytearray()
        for _ in range(h):
            out += bytes([5, 0x3A, 0, 5, 0x12, 0x34, 0x50, 0, 4, 0x77, 0, 0])
        return bmp_bytes(w, h, 4, palette=pal, compression=2, rle=bytes(out) + b"\x00\x01")
    raise KeyError(name)


BMP_CASES = ["pillow_1", "pillow_L", "pillow_P", "pillow_RGB", "pillow_RGBA", "4bit",
             "4bit_top_down", "8bit_short_palette", "8bit_os2", "16bit", "16bit_565",
             "16bit_555", "24bit_top_down", "32bit", "32bit_bf_bgrx", "32bit_bf_rgba",
             "32bit_bf_abgr", "rle8", "rle4"]


# rows padded to 4 bytes at the odd width; RLE's runs and deltas fill rows
# differently at the second width
@pytest.mark.parametrize("name,size", _sizes(BMP_CASES, twice=["4bit", "rle8", "rle4"]),
                         ids=_size_id)
def test_bmp_as_pillow(name, size):
    rng = np.random.default_rng(len(name) + size[1])
    _assert_as_pillow(_bmp_case(name, _rgb(*size, seed=3), rng))


def _ppm_case(name, rgb, rng):
    h, w = rgb.shape[:2]
    if name.startswith("pillow_"):
        return _save(Image.fromarray(rgb).convert(name[7:]), "PPM")
    kind, maxval = name.split("_")[0], int(name.split("_")[1][3:]) if "_max" in name else 255
    if kind in ("P2", "P3"):
        vals = rng.integers(0, maxval + 1, (h, w) if kind == "P2" else (h, w, 3))
        head = b"%s\n# a comment\n%d %d\n%d\n" % (kind.encode(), w, h, maxval)
        return head + b" ".join(b"%d" % v for v in vals.ravel()) + b"\n"
    if kind in ("P5", "P6"):
        vals = rng.integers(0, maxval + 1, (h, w) if kind == "P5" else (h, w, 3))
        raw = vals.astype(">u2" if maxval > 255 else np.uint8).tobytes()
        return b"%s %d %d %d\n" % (kind.encode(), w, h, maxval) + raw
    bits = rng.integers(0, 2, (h, w))
    if kind == "P1":
        body = b"".join(b"%d" % v for v in bits.ravel())
        return b"P1\n%d %d\n" % (w, h) + body[:5] + b"#x\n" + body[5:]
    return b"P4\n%d %d\n" % (w, h) + np.packbits(bits, axis=1).tobytes()


PPM_CASES = ["pillow_RGB", "pillow_L", "pillow_1", "P1", "P4", "P2_max255", "P2_max15",
             "P2_max1000", "P2_max65535", "P3_max255", "P3_max7", "P3_max4000",
             "P5_max15", "P5_max1000", "P5_max65535", "P6_max255", "P6_max100", "P6_max1000",
             "P6_max65535"]


@pytest.mark.parametrize("name,size", _sizes(PPM_CASES, twice=["P4", "pillow_1"]),
                         ids=_size_id)
def test_netpbm_as_pillow(name, size):
    rng = np.random.default_rng(len(name) + size[0])
    _assert_as_pillow(_ppm_case(name, _rgb(*size, seed=4), rng))


def _local_table(data: bytes) -> bytes:
    """The same GIF with its global colour table moved into the image
    descriptor as a local one."""
    flags = data[10]
    size = 3 << ((flags & 7) + 1)
    table = data[13:13 + size]
    rest = bytearray(data[:10] + bytes([flags & 0x7F]) + data[11:13] + data[13 + size:])
    at = rest.index(b",", 13)
    rest[at + 9] |= 0x80 | (flags & 7)
    return bytes(rest[:at + 10] + table + rest[at + 10:])


def _gif_case(name, rgb):
    im = Image.fromarray(rgb)
    if name.startswith("colours"):
        n, il = int(name.split("_")[1]), name.endswith("il")
        return _save(im.quantize(n), "GIF", interlace=il)
    if name == "gray":
        return _save(im.convert("L"), "GIF")
    if name == "bilevel":
        return _save(im.convert("1"), "GIF")
    if name == "transparency":
        return _save(im.quantize(16), "GIF", transparency=3)
    if name == "local_table":
        return _local_table(_save(im.quantize(32), "GIF"))
    if name in ("wider_screen", "wider_screen_transparency"):
        extra = dict(transparency=5) if "transparency" in name else {}
        data = bytearray(_save(im.quantize(16), "GIF", **extra))
        w, h = struct.unpack("<HH", data[6:10])
        data[6:10] = struct.pack("<HH", w + 5, h + 3)
        return bytes(data)
    raise KeyError(name)


GIF_CASES = ["colours_2", "colours_3", "colours_16", "colours_17", "colours_64", "colours_256",
             "colours_2_il", "colours_16_il", "colours_256_il", "gray", "bilevel",
             "transparency", "local_table", "wider_screen", "wider_screen_transparency"]


@pytest.mark.parametrize("name,size", _sizes(
    GIF_CASES, twice=[n for n in GIF_CASES if n.endswith("_il")]), ids=_size_id)
def test_gif_as_pillow(name, size):
    _assert_as_pillow(_gif_case(name, _rgb(*size, seed=5)))


TIFF_MODES = ["L", "RGB", "RGBA", "P", "CMYK", "LA"]
TIFF_COMPRESSIONS = [None, "packbits", "tiff_lzw", "tiff_adobe_deflate"]


@pytest.mark.parametrize("compression", TIFF_COMPRESSIONS, ids=str)
@pytest.mark.parametrize("mode", TIFF_MODES)
def test_tiff_as_pillow(mode, compression):
    rgb = _rgb(23, 17, seed=6)
    im = Image.fromarray(rgb)
    im = (im.quantize(40) if mode == "P" else
          Image.fromarray(np.dstack([rgb, rgb[..., :1]])) if mode == "RGBA" else im.convert(mode))
    for tags in ({}, {317: 2}, {278: 5}, {274: 6}, {274: 5}, {274: 8}, {317: 2, 278: 4}):
        _assert_as_pillow(_save(im, "TIFF", compression=compression, tiffinfo=tags))


@pytest.mark.parametrize("name", ["associated_alpha", "white_is_zero", "fill_order_2",
                                  "no_photometric"])
def test_tiff_tags_as_pillow(name):
    rgb = _rgb(17, 23, seed=7)
    if name == "associated_alpha":
        rgba = np.dstack([rgb, np.clip(rgb[..., :1] + 40, 0, 255)])
        rgba[0, 0, 3] = 0
        data = tiff_bytes(rgba, {262: (3, (2,)), 338: (3, (1,))})
    elif name == "white_is_zero":
        data = tiff_bytes(rgb[..., 0], {262: (3, (0,))})
    elif name == "fill_order_2":
        data = tiff_bytes(rgb, {266: (3, (2,))})
    else:
        data = tiff_bytes(rgb[..., 1], {})
        data = data.replace(struct.pack("<HHI", 262, 3, 1), struct.pack("<HHI", 263, 3, 1))
    _assert_as_pillow(data)


@pytest.mark.parametrize("fault,match", [
    ("tiles", "tiled TIFF"), ("jpeg", "JPEG-in-TIFF"), ("planar", "planar configuration 2"),
    ("16bit", "16 bits a sample"), ("float", "32 bits a sample"),
    ("ycbcr", "photometric interpretation 6")])
def test_tiff_refusals_name_the_feature(fault, match):
    rgb = _rgb(16, 16, seed=8)
    data = {
        "tiles": lambda: tiff_bytes(rgb, {322: (3, (16,)), 323: (3, (16,)), 324: (4, (0,)),
                                          325: (4, (768,))}),
        "jpeg": lambda: _save(Image.fromarray(rgb), "TIFF", compression="jpeg"),
        "planar": lambda: tiff_bytes(rgb, {284: (3, (2,))}),
        "16bit": lambda: _save(Image.fromarray(rgb[..., 0].astype(np.uint16) * 200), "TIFF"),
        "float": lambda: _save(Image.fromarray(rgb[..., 0].astype(np.float32)), "TIFF"),
        "ycbcr": lambda: tiff_bytes(rgb, {262: (3, (6,))}),
    }[fault]()
    with pytest.raises(ValueError, match=match):
        imageio.decode_image(data)


@pytest.mark.parametrize("fault,match", [
    ("bmp_masks", "bitfield masks"), ("bmp_jpeg", "BMP compression 4"),
    ("bmp_2bit", "2-bit BMP"), ("ppm_pam", "unknown image format"),
    ("gif_truncated", "GIF without an image")])
def test_other_refusals_name_the_feature(fault, match):
    rgb = _rgb(8, 8)
    v32 = [r.tobytes() for r in np.dstack([rgb, rgb[..., :1]])]
    data = {
        "bmp_masks": lambda: bmp_bytes(8, 8, 32, v32, compression=3,
                                       masks=(0xFF00, 0xFF, 0xFF0000, 0)),
        "bmp_jpeg": lambda: bmp_bytes(8, 8, 24, [r.tobytes() for r in rgb], compression=4),
        "bmp_2bit": lambda: bmp_bytes(8, 8, 2, [bytes(2)] * 8, [(0, 0, 0)] * 4),
        "ppm_pam": lambda: b"P7\nWIDTH 8\n",
        "gif_truncated": lambda: _save(Image.fromarray(rgb).quantize(4), "GIF")[:20],
    }[fault]()
    with pytest.raises(ValueError, match=match):
        imageio.decode_image(data)


def _png_chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def _rgb_png(width: int, height: int, idat: bytes) -> bytes:
    """An 8-bit RGB PNG of the given size whose image data is ``idat``."""
    return (b"\x89PNG\r\n\x1a\n"
            + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, 8, 2, 0, 0, 0))
            + _png_chunk(b"IDAT", idat) + _png_chunk(b"IEND", b""))


def _oversized(fmt: str) -> bytes:
    """A file of a few hundred bytes whose header claims 20000x20000 pixels
    (a GIF's screen 65535x65535)."""
    n = 20000
    rgb = np.zeros((8, 8, 3), np.uint8)
    if fmt == "png":
        return _rgb_png(n, n, zlib.compress(b""))
    if fmt == "jpeg":
        data = bytearray(_save(Image.fromarray(rgb), "JPEG"))
        at = data.find(b"\xff\xc0")
        data[at + 5:at + 9] = struct.pack(">HH", n, n)
        return bytes(data)
    if fmt == "bmp":
        data = bytearray(bmp_bytes(8, 8, 24, [r.tobytes() for r in rgb]))
        data[18:26] = struct.pack("<ii", n, n)
        return bytes(data)
    if fmt == "bmp_rle":
        data = bytearray(bmp_bytes(8, 8, 8, palette=[(0, 0, 0)] * 2, compression=1,
                                   rle=b"\x00\x02\x00\x00\xff\xff" * 4 + b"\x00\x01"))
        data[18:26] = struct.pack("<ii", n, n)
        return bytes(data)
    if fmt == "gif":
        data = bytearray(_save(Image.fromarray(rgb).quantize(4), "GIF"))
        data[6:10] = struct.pack("<HH", 65535, 65535)
        return bytes(data)
    if fmt == "tiff":
        return tiff_bytes(rgb, {256: (4, (n,)), 257: (4, (n,))})
    return b"P6 %d %d 255\n" % (n, n) + bytes(30)


@pytest.mark.parametrize("fmt", ["png", "jpeg", "bmp", "bmp_rle", "gif", "tiff", "ppm"])
def test_oversized_header_is_refused_before_decoding(fmt):
    """A header over Pillow's decompression-bomb limit (twice
    ``Image.MAX_IMAGE_PIXELS``): Pillow refuses to open it, and the port's
    HTTP parser refuses the body with a request error that names the limit,
    from the header alone."""
    data = _oversized(fmt)
    assert len(data) < 1024
    with pytest.raises(Image.DecompressionBombError):
        Image.open(io.BytesIO(data))
    with pytest.raises(tserver_http.RequestError, match="over the limit of 178956970 pixels"):
        tserver_http._parse_png(data)


def test_png_inflates_no_more_than_its_rows():
    """A 4x4 PNG whose image data inflates to 64 MiB: refused for its length
    with the inflated data held to the rows' size."""
    import tracemalloc

    data = _rgb_png(4, 4, zlib.compress(bytes(64 << 20), 9))
    tracemalloc.start()
    try:
        with pytest.raises(tserver_http.RequestError, match="wrong length"):
            tserver_http._parse_png(data)
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    assert peak < 4 << 20
    with pytest.raises(ValueError, match="zlib stream breaks off"):
        imageio.decode_image(_rgb_png(4, 4, zlib.compress(bytes(4 * 13))[:-6]))


# ---------------------------------------------------------------------------
# The fixtures, the readers and the data path against the JAX package
# ---------------------------------------------------------------------------

def _fixture_files():
    return sorted(os.path.relpath(os.path.join(d, f), FORMATS).replace(os.sep, "/")
                  for d, _, files in os.walk(FORMATS) for f in files if f != "digests.json")


def test_committed_digests_are_pillows():
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    from make_format_fixtures import pillow_digests

    with open(os.path.join(FORMATS, "digests.json")) as f:
        committed = json.load(f)
    assert committed == pillow_digests()
    assert sorted(committed) == _fixture_files()


@pytest.mark.parametrize("rel", _fixture_files())
def test_fixture_reads_as_jax(rel):
    """Every file of ``testsets/demo64_formats``: ``imread_uint`` of both
    packages (the JAX one through Pillow) and the committed digest."""
    path = os.path.join(FORMATS, rel)
    with open(os.path.join(FORMATS, "digests.json")) as f:
        want = json.load(f)[rel]
    for n, mode in ((3, "RGB"), (1, "L")):
        got = tim.imread_uint(path, n)
        np.testing.assert_array_equal(got, jim.imread_uint(path, n))
        assert hashlib.sha256(got[..., 0].tobytes() if n == 1 else got.tobytes()
                              ).hexdigest() == want[mode]


@pytest.mark.parametrize("overrides", [dict(), dict(n_channels=1, mask_type="box",
                                                    mask_len_range=[8, 12])],
                         ids=["rgb_random_mask", "gray_box_mask"])
def test_data_path_on_jpeg_testset_equals_jax(tmp_path, overrides):
    """``prepare_images`` of both packages on a JPEG copy of demo32: ground
    truths, masks and degraded observations bit for bit."""
    os.makedirs(tmp_path / "testsets" / "demo32")
    for name in sorted(os.listdir(os.path.join(ROOT, "testsets", "demo32"))):
        with Image.open(os.path.join(ROOT, "testsets", "demo32", name)) as im:
            im.convert("RGB").save(tmp_path / "testsets" / "demo32" /
                                   (os.path.splitext(name)[0] + ".jpg"), quality=85)
    path = os.path.join(ROOT, "configs", "demo32_inpaint.yaml")
    over = dict(overrides, cwd=str(tmp_path))
    jcfg, tcfg = jconfig.load_config(path, over), tconfig.load_config(path, over)
    np.random.seed(jcfg.seed)
    ref = jdata.prepare_images(jcfg)
    np.random.seed(tcfg.seed)
    got = tdata.prepare_images(tcfg)
    assert len(got) == len(ref) == len(os.listdir(tmp_path / "testsets" / "demo32")) > 0
    for g, r in zip(got, ref):
        assert g["name"] == r["name"] and g["name"].endswith(".jpg")
        for key in ("img_H", "img_L", "mask"):
            np.testing.assert_array_equal(g[key], r[key], err_msg=key)


class _EchoService:
    """What the HTTP handler needs of a RestorationService: the restored
    image is the decoded observation itself."""

    batch = 1
    cfg = types.SimpleNamespace(task="inpaint", model_name="echo", iter_num=1, n_channels=3,
                                sf=1)

    def submit(self, image, **_):
        fut = concurrent.futures.Future()
        fut.set_result(np.asarray(image, np.float32))
        return fut

    def close(self):
        pass


@pytest.mark.parametrize("fmt", ["jpeg", "gif", "bmp", "tiff"])
def test_http_image_body_decodes_as_pillow(fmt):
    """An ``image/png`` body in another format: the port's handler decodes
    it as the JAX handler (Pillow) does, and a live server echoes it back."""
    rgb = _rgb(19, 21, seed=9)
    im = Image.fromarray(rgb)
    body = {"jpeg": lambda: _save(im, "JPEG", quality=80),
            "gif": lambda: _save(im.quantize(64), "GIF"),
            "bmp": lambda: _save(im, "BMP"),
            "tiff": lambda: _save(im, "TIFF", compression="tiff_lzw")}[fmt]()
    np.testing.assert_array_equal(tserver_http._parse_png(body), jserver_http._parse_png(body))
    httpd = tserver_http.start_server(_EchoService(), port=0)
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}/restore"
        req = urllib.request.Request(url, data=body, headers={"Content-Type": "image/png"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            out = resp.read()
    finally:
        httpd.shutdown()
    np.testing.assert_array_equal(_pillow(out, "RGB"), _pillow(body, "RGB"))
