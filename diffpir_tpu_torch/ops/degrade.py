"""Degradation helpers: inpainting masks, blur kernels and the classical SR
degradation on the host (numpy and scipy), and the DPS forward blur on the
device.

Copies of ``diffpir_tpu/ops/degrade.py``:

  * ``box_mask``/``random_mask``/``make_mask`` == ``utils/utils_inpaint.py:67-137``:
    the same numpy RNG draws in the same order, so a seed gives the JAX
    package's masks bit for bit
  * ``fspecial_gaussian``      == ``utils/utils_deblur.py:488-499``
  * ``gaussian_psf``           == DPS ``Blurkernel`` gaussian init
                                  (``utils_deblur.py:658-666``)
  * ``shift_pixel``            == ``utils/utils_sisr.py:118-144``
  * ``classical_degradation``  == ``utils/utils_sisr.py:100-114``
  * ``blur_reflect``           == ``ReflectionPad2d`` + grouped ``F.conv2d``
                                  (``main_ddpir.py:304-310``)
  * ``motion_psf``             == ``diffpir_tpu/ops/degrade.py:236-310``: the
                                  same numpy draws in the same order, the
                                  path rasterised by ``utils/raster.py`` and
                                  ``utils/resample.py`` (Pillow's line,
                                  Gaussian blur and LANCZOS in numpy), equal
                                  to the JAX package's PSF bit for bit
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["box_mask", "random_mask", "make_mask", "fspecial_gaussian",
           "gaussian_psf", "motion_psf", "shift_pixel", "classical_degradation",
           "blur_reflect"]


def box_mask(image_size=256, mask_len_range=(128, 129), margin=(16, 16),
             rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Random square zero-box mask, (H, W) float in {0,1}. 1 = observed.

    image_size: int (square) or (H, W) — the RNG draw order is unchanged for
    square inputs, preserving per-seed reproducibility.
    """
    rng = rng or np.random.default_rng()
    H, W = ((image_size, image_size) if np.isscalar(image_size) else image_size)
    lo, hi = int(mask_len_range[0]), int(mask_len_range[1])
    h = int(rng.integers(lo, hi))
    w = int(rng.integers(lo, hi))
    mh, mw = margin
    # max(..) keeps the exactly-fitting case (H == h + 2*mh) placeable at the
    # margin instead of raising low >= high (the reference would crash too)
    t = int(rng.integers(mh, max(H - mh - h, mh + 1)))
    l = int(rng.integers(mw, max(W - mw - w, mw + 1)))
    mask = np.ones((H, W), np.float32)
    mask[t:t + h, l:l + w] = 0.0
    return mask


def random_mask(image_size=256, mask_prob_range=(0.5, 0.5),
                rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Random-pixel dropout mask, same prob for all channels."""
    rng = rng or np.random.default_rng()
    H, W = ((image_size, image_size) if np.isscalar(image_size) else image_size)
    prob = rng.uniform(*mask_prob_range)
    total = H * W
    mask = np.ones(total, np.float32)
    drop = rng.choice(total, int(total * prob), replace=False)
    mask[drop] = 0.0
    return mask.reshape(H, W)


def make_mask(mask_type: str, image_size=256, mask_len_range=(128, 129),
              mask_prob_range=(0.5, 0.5), margin=(16, 16),
              rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Dispatch over the reference's mask types (box|random|both|extreme).

    ``both`` = a per-image fair coin between the box and random families (the
    semantics the name implies).  The reference asserts 'both' as a valid
    type (``utils/utils_inpaint.py:95``) but its ``__call__`` has no branch
    for it and silently returns ``None`` (``utils_inpaint.py:127-137``) — a
    reference bug this implementation fixes rather than reproduces.
    """
    rng = rng or np.random.default_rng()
    if mask_type == "both":
        mask_type = "box" if rng.uniform() < 0.5 else "random"
    if mask_type == "random":
        return random_mask(image_size, mask_prob_range, rng)
    if mask_type == "box":
        return box_mask(image_size, mask_len_range, margin, rng)
    if mask_type == "extreme":
        return 1.0 - box_mask(image_size, mask_len_range, margin, rng)
    raise ValueError(f"unknown mask_type: {mask_type}")


def fspecial_gaussian(hsize: int, sigma: float) -> np.ndarray:
    """MATLAB fspecial('gaussian'): truncated, normalized Gaussian."""
    siz = (hsize - 1) / 2.0
    y, x = np.mgrid[-siz:siz + 1, -siz:siz + 1]
    h = np.exp(-(x * x + y * y) / (2.0 * sigma * sigma))
    h[h < np.finfo(float).eps * h.max()] = 0
    s = h.sum()
    return h / s if s != 0 else h


def gaussian_psf(kernel_size: int, std: float) -> np.ndarray:
    """Impulse response of scipy's gaussian_filter (DPS Blurkernel 'gaussian')."""
    from scipy.ndimage import gaussian_filter

    n = np.zeros((kernel_size, kernel_size))
    n[kernel_size // 2, kernel_size // 2] = 1.0
    return gaussian_filter(n, sigma=std)


def motion_psf(kernel_size: int, intensity: float = 0.5,
               rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Random motion-blur PSF with an intensity knob in [0, 1] (the public
    ``motionblur.Kernel`` algorithm the reference imports,
    ``utils/utils_deblur.py:7,691-693``): random step lengths and angles on a
    2x supersampled canvas, the complex path centred on its centre of mass
    and randomly rotated, drawn as a polyline of width ``diag/150``, blurred
    by ``GaussianBlur(0.01 diag)``, LANCZOS-downsampled to ``kernel_size`` and
    normalised.  A grey RGB canvas converts to L exactly (Pillow's weights
    19595 + 38470 + 7471 sum to 2^16), so the raster runs on one channel."""
    from diffpir_tpu_torch.utils.raster import draw_line, gaussian_blur
    from diffpir_tpu_torch.utils.resample import LANCZOS, resize

    rng = rng or np.random.default_rng()
    eps = 0.1
    intensity = float(np.clip(intensity, 0.0, 1.0))
    sx = sy = 2 * kernel_size
    diagonal = (sx**2 + sy**2) ** 0.5

    # 1. step lengths
    max_path_len = 0.75 * diagonal * (rng.uniform() + rng.uniform(0, intensity**2))
    steps: list[float] = []
    while sum(steps) < max_path_len:
        step = rng.beta(1, 30) * (1 - intensity + eps) * diagonal
        if step < max_path_len:
            steps.append(step)
    num_steps = len(steps)

    # 2. step angles
    max_angle = rng.uniform(0, intensity * math.pi)
    jitter = rng.beta(2, 20)
    angles = [rng.uniform(-max_angle, max_angle)]
    while len(angles) < num_steps:
        angle = rng.triangular(0, intensity * max_angle, max_angle + eps)
        sign = -np.sign(angles[-1]) if rng.uniform() < jitter else np.sign(angles[-1])
        angles.append(angle * (sign if sign != 0 else 1.0))

    # 3. complex path, centred on its centre of mass, randomly rotated
    incr = np.asarray(steps) * np.exp(1j * np.asarray(angles[:num_steps]))
    path = np.cumsum(incr) if num_steps else np.zeros(1, complex)
    path = path - path.mean()
    path = path * np.exp(1j * rng.uniform(0, math.pi))
    path = path + (sx + 1j * sy) / 2

    # 4. rasterise on the supersampled canvas, blur, downsample, normalise
    canvas = np.zeros((sy, sx), np.uint8)
    draw_line(canvas, [(p.real, p.imag) for p in path], width=int(diagonal / 150))
    canvas = gaussian_blur(canvas, int(diagonal * 0.01))
    k = resize(canvas, (kernel_size, kernel_size), LANCZOS).astype(np.float32)
    k = np.maximum(k, 0.0)
    if k.sum() <= 0:  # the path fell outside the canvas: a delta PSF
        k[kernel_size // 2, kernel_size // 2] = 1.0
    return k / k.sum()


def shift_pixel(x: np.ndarray, sf: int, upper_left: bool = True) -> np.ndarray:
    """Half-pixel grid shift compensating classical sf-fold downsampling
    (bilinear resample at coordinates shifted by (sf-1)/2, clipped at the
    border)."""
    from scipy.interpolate import RegularGridInterpolator

    h, w = x.shape[:2]
    shift = (sf - 1) * 0.5
    xv, yv = np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64)
    x1 = np.clip(xv + (shift if upper_left else -shift), 0, w - 1)
    y1 = np.clip(yv + (shift if upper_left else -shift), 0, h - 1)
    yy, xx = np.meshgrid(y1, x1, indexing="ij")
    pts = np.stack([yy.ravel(), xx.ravel()], axis=1)

    def interp(ch):
        f = RegularGridInterpolator((yv, xv), ch, method="linear")
        return f(pts).reshape(h, w)

    if x.ndim == 2:
        return interp(x)
    out = x.copy().astype(np.float64)
    for c in range(x.shape[-1]):
        out[:, :, c] = interp(x[:, :, c].astype(np.float64))
    return out


def classical_degradation(x: np.ndarray, k: np.ndarray, sf: int = 3) -> np.ndarray:
    """Blur (wrap) + strided subsample."""
    from scipy import ndimage

    y = ndimage.convolve(x, np.expand_dims(k, axis=2), mode="wrap")
    return y[::sf, ::sf, ...]


def blur_reflect(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Reflection-padded depthwise correlation, the DPS forward blur.

    x: (B, H, W, C); k: (B, kh, kw), one kernel per batch element, or one
    (kh, kw) kernel for all.  ``F.conv2d`` is correlation, as the
    reference's (no kernel flip).  Both sides are padded by kw//2, as in the
    JAX package.  Differentiable in x.
    """
    b, h, w, c = x.shape
    pad = k.shape[-1] // 2
    k = k.to(x.dtype).expand((b,) + tuple(k.shape[-2:]))
    xp = F.pad(x.permute(0, 3, 1, 2), (pad, pad, pad, pad), mode="reflect")
    weight = k[:, None].repeat_interleave(c, dim=0)          # (B*C, 1, kh, kw)
    y = F.conv2d(xp.reshape(1, b * c, *xp.shape[2:]), weight, groups=b * c)
    return y.reshape(b, c, *y.shape[2:]).permute(0, 2, 3, 1)
