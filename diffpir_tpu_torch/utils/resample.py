"""Pillow's ``Image.resize`` with ``BOX``, ``BICUBIC`` or ``LANCZOS`` for
8-bit images, in numpy.

The training loader resizes as the JAX package's does with Pillow
(``diffpir_tpu/train/datasets.py:73-86``), and the motion PSF downsamples its
canvas with LANCZOS (``diffpir_tpu/ops/degrade.py:300``); the port does not
depend on Pillow.
This follows Pillow's separable resampler (``libImaging/Resample.c``):

* per output pixel a filter window centred at ``(x + 0.5) * scale``, its
  support widened by the downscale factor, its weights normalised to sum 1
  and rounded to fixed point with 22 fractional bits;
* a horizontal pass, then a vertical one, each summing in integers from a
  rounding offset of 2^21 and clipping to 0..255 (the intermediate image is
  8-bit too); a pass whose size does not change is skipped.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = ["BOX", "BICUBIC", "LANCZOS", "resize"]

BOX, BICUBIC, LANCZOS = "box", "bicubic", "lanczos"
_PRECISION_BITS = 32 - 8 - 2


def _box(x: np.ndarray) -> np.ndarray:
    return ((x > -0.5) & (x <= 0.5)).astype(np.float64)


def _bicubic(x: np.ndarray) -> np.ndarray:
    a = -0.5
    x = np.abs(x)
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


def _sinc(x: float) -> float:
    if x == 0.0:
        return 1.0
    x = x * math.pi
    return math.sin(x) / x


def _lanczos(x: np.ndarray) -> np.ndarray:
    """The sinc windowed by a sinc, support 3; ``math.sin`` per tap, the C
    library's sine as Pillow's."""
    return np.array([_sinc(v) * _sinc(v / 3) if -3.0 <= v < 3.0 else 0.0
                     for v in x.ravel()]).reshape(x.shape)


_FILTERS = {BOX: (_box, 0.5), BICUBIC: (_bicubic, 2.0), LANCZOS: (_lanczos, 3.0)}


def _coeffs(in_size: int, out_size: int, resample: str):
    """(first input index, fixed-point weights (out, ksize)) of one axis,
    as Pillow's ``precompute_coeffs`` and ``normalize_coeffs_8bpc``."""
    fn, support = _FILTERS[resample]
    scale = filterscale = in_size / out_size
    if filterscale < 1.0:
        filterscale = 1.0
    support = support * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    # C's (int) cast truncates toward zero
    xmin = np.maximum(np.trunc(center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum(np.trunc(center + support + 0.5).astype(np.int64), in_size) - xmin
    taps = np.arange(ksize)
    w = fn(((taps[None] + xmin[:, None]) - center[:, None] + 0.5) * (1.0 / filterscale))
    w = np.where(taps[None] < xmax[:, None], w, 0.0)
    ww = np.zeros(out_size)
    for k in range(ksize):  # Pillow sums in order; numpy's sum would pair
        ww = ww + w[:, k]
    w = np.where(ww[:, None] != 0.0, w / np.where(ww == 0.0, 1.0, ww)[:, None], w)
    fixed = np.trunc(w * (1 << _PRECISION_BITS) + np.where(w < 0, -0.5, 0.5))
    return xmin, fixed.astype(np.int64)


def _pass(img: np.ndarray, axis: int, out_size: int, resample: str) -> np.ndarray:
    """Resample ``img`` (uint8, (H, W, C)) along ``axis`` to ``out_size``."""
    xmin, k = _coeffs(img.shape[axis], out_size, resample)
    src = np.moveaxis(img, axis, 0).astype(np.int64)
    n = src.shape[0]
    acc = np.full((out_size,) + src.shape[1:], 1 << (_PRECISION_BITS - 1), np.int64)
    for j in range(k.shape[1]):
        idx = np.minimum(xmin + j, n - 1)   # taps past xmax carry weight 0
        acc += src[idx] * k[:, j].reshape((-1,) + (1,) * (src.ndim - 1))
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def resize(img: np.ndarray, size: tuple[int, int], resample: str) -> np.ndarray:
    """``Image.fromarray(img).resize(size, resample)`` for uint8 (H, W) or
    (H, W, C) arrays; ``size`` is (width, height) as Pillow takes it."""
    if img.dtype != np.uint8:
        raise TypeError(f"resize takes uint8 images, got {img.dtype}")
    if resample not in _FILTERS:
        raise ValueError(f"resample must be one of {sorted(_FILTERS)}, got {resample!r}")
    width, height = size
    out = img
    if width != img.shape[1]:
        out = _pass(out, 1, width, resample)
    if height != img.shape[0]:
        out = _pass(out, 0, height, resample)
    return np.ascontiguousarray(out)
