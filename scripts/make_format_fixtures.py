#!/usr/bin/env python3
"""Writes ``testsets/demo64_formats``: the four demo64 images in the formats
the port's decoders read, and ``digests.json``, the sha256 of Pillow's
``Image.open(f).convert("RGB")`` and ``.convert("L")`` of every file (the
bytes of the numpy array).

    python scripts/make_format_fixtures.py [--check]

Each variant is a folder of four files (a test set the CLI can be pointed at
with ``--set testset_name=demo64_formats/<variant>``): baseline 4:2:0,
progressive and gray JPEG; palette, 16-bit gray and Adam7-interlaced PNG
(the interlaced ones from the test-side writer in ``tests/_image_writers.py``:
Pillow writes no interlaced PNG); BMP, PPM, GIF and LZW TIFF.
``imagenet_size`` holds one 500x375 baseline 4:2:0 JPEG (demo256's first
image, resized by Pillow), the size of an ImageNet validation image.  With
``--check`` nothing is written; the digests Pillow gives for the files on
disk are compared with ``digests.json`` (exit 1 on a difference).
"""

from __future__ import annotations

import argparse
import hashlib
import io
import json
import os
import sys

import numpy as np
from PIL import Image

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "testsets", "demo64_formats")
DIGESTS = os.path.join(OUT, "digests.json")


def digest(arr: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def pillow_digests(root: str = OUT) -> dict:
    """{relative path: {"RGB": sha256, "L": sha256, "shape": [h, w]}} of
    every image under ``root``, from Pillow."""
    out = {}
    for dirpath, _, files in sorted(os.walk(root)):
        for name in sorted(files):
            if name == "digests.json":
                continue
            path = os.path.join(dirpath, name)
            with Image.open(path) as im:
                rgb = np.asarray(im.convert("RGB"))
                gray = np.asarray(im.convert("L"))
            out[os.path.relpath(path, root).replace(os.sep, "/")] = {
                "RGB": digest(rgb), "L": digest(gray), "shape": list(rgb.shape[:2])}
    return out


def _encode(img: Image.Image, fmt: str, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, fmt, **kw)
    return buf.getvalue()


def variants(rgb: np.ndarray) -> dict:
    """Variant folder -> (extension, file bytes) of one RGB image."""
    sys.path.insert(0, ROOT)
    from tests._image_writers import png_bytes

    im = Image.fromarray(rgb)
    gray16 = np.asarray(im.convert("L"), np.uint16) * 257
    return {
        "jpeg_420": (".jpg", _encode(im, "JPEG", quality=90, subsampling=2)),
        "jpeg_progressive": (".jpg", _encode(im, "JPEG", quality=90, progressive=True)),
        "jpeg_gray": (".jpg", _encode(im.convert("L"), "JPEG", quality=90)),
        "png_palette": (".png", _encode(im.quantize(64), "PNG")),
        "png_16bit": (".png", _encode(Image.fromarray(gray16), "PNG")),
        "png_interlaced": (".png", png_bytes(rgb, 8, 2, interlace=True)),
        "bmp": (".bmp", _encode(im, "BMP")),
        "ppm": (".ppm", _encode(im, "PPM")),
        "gif": (".gif", _encode(im.quantize(128), "GIF")),
        "tiff_lzw": (".tif", _encode(im, "TIFF", compression="tiff_lzw")),
    }


def write() -> None:
    src = sorted(os.listdir(os.path.join(ROOT, "testsets", "demo64")))
    for name in src:
        rgb = np.asarray(Image.open(os.path.join(ROOT, "testsets", "demo64", name))
                         .convert("RGB"))
        stem = os.path.splitext(name)[0]
        for folder, (ext, data) in variants(rgb).items():
            os.makedirs(os.path.join(OUT, folder), exist_ok=True)
            with open(os.path.join(OUT, folder, stem + ext), "wb") as f:
                f.write(data)
    big = Image.open(os.path.join(ROOT, "testsets", "demo256", "synth0.png")).convert("RGB")
    big = big.resize((500, 375), Image.BICUBIC)
    os.makedirs(os.path.join(OUT, "imagenet_size"), exist_ok=True)
    with open(os.path.join(OUT, "imagenet_size", "synth0_500x375.jpg"), "wb") as f:
        f.write(_encode(big, "JPEG", quality=90, subsampling=2))
    with open(DIGESTS, "w") as f:
        json.dump(pillow_digests(), f, indent=1, sort_keys=True)
        f.write("\n")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--check", action="store_true")
    args = ap.parse_args()
    if args.check:
        with open(DIGESTS) as f:
            ok = json.load(f) == pillow_digests()
        print("digests match" if ok else "digests differ")
        return 0 if ok else 1
    write()
    return 0


if __name__ == "__main__":
    sys.exit(main())
