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
  * ``fspecial_laplacian``/``_average``/``_prewitt``/``_sobel`` and the
    ``fspecial`` factory  == ``utils/utils_deblur.py:502-547``
  * ``get_rho_sigma``          == ``utils/utils_inpaint.py:15-25``
  * ``shepard_initialize``     == ``utils/utils_inpaint.py:28-63`` (vectorised)
  * ``trajectory_psf``         == ``utils/utils_deblur.py:556-632``: the same
                                  numpy draws in the same order as the JAX
                                  package's, so a seed gives its kernel
  * ``blur_circular``          == ``scipy.ndimage.convolve(..., mode='wrap')``
                                  (``main_ddpir.py:99``), spectral, on the
                                  tensor's device
  * ``add_awgn``               == ``main_ddpir.py:112-114``
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["box_mask", "random_mask", "make_mask", "fspecial_gaussian",
           "fspecial_laplacian", "fspecial_average", "fspecial_prewitt",
           "fspecial_sobel", "fspecial", "get_rho_sigma", "shepard_initialize",
           "gaussian_psf", "motion_psf", "trajectory_psf", "shift_pixel",
           "classical_degradation", "blur_circular", "blur_reflect", "add_awgn"]


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


def fspecial_laplacian(alpha: float) -> np.ndarray:
    """MATLAB fspecial('laplacian', alpha) (reference ``utils_deblur.py:502-508``)."""
    alpha = max(0.0, min(alpha, 1.0))
    h1 = alpha / (alpha + 1)
    h2 = (1 - alpha) / (alpha + 1)
    return np.array([[h1, h2, h1], [h2, -4 / (alpha + 1), h2], [h1, h2, h1]])


def fspecial_average(hsize: int = 3) -> np.ndarray:
    return np.ones((hsize, hsize)) / hsize**2


def fspecial_prewitt() -> np.ndarray:
    return np.array([[1, 1, 1], [0, 0, 0], [-1, -1, -1]], dtype=np.float64)


def fspecial_sobel() -> np.ndarray:
    return np.array([[1, 2, 1], [0, 0, 0], [-1, -2, -1]], dtype=np.float64)


def fspecial(filter_type: str, *args, **kwargs) -> np.ndarray:
    """MATLAB-style filter factory (reference ``utils_deblur.py:527-547``)."""
    table = {"gaussian": fspecial_gaussian, "laplacian": fspecial_laplacian,
             "average": fspecial_average, "prewitt": fspecial_prewitt,
             "sobel": fspecial_sobel}
    return table[filter_type](*args, **kwargs)


def get_rho_sigma(sigma: float = 2.55 / 255, iter_num: int = 15,
                  model_sigma2: float = 2.55):
    """DPIR rho/sigma log-schedule (reference ``utils_inpaint.py:15-25``)."""
    model_sigma1 = 49.0
    sigmas = np.logspace(np.log10(model_sigma1), np.log10(model_sigma2),
                         iter_num) / 255.0
    rhos = [(sigma**2) / (s**2) / 3 for s in sigmas]
    return rhos, sigmas


def shepard_initialize(image: np.ndarray, measurement_mask: np.ndarray,
                       window: int = 5, p: int = 2) -> np.ndarray:
    """Inverse-distance-weighted (Shepard) inpainting initialisation: each
    unobserved pixel becomes the IDW average of the observed pixels in its
    (window x window) neighbourhood, weights 1/(|di|^p + |dj|^p)."""
    from scipy.signal import convolve2d

    img = image.astype(np.float64)
    if img.ndim == 2:
        img = img[:, :, None]
    m = measurement_mask.astype(np.float64)
    wing = window // 2
    # the weight stencil over offsets; the centre is left out (an unobserved
    # pixel has nothing at distance 0)
    ii, jj = np.meshgrid(np.arange(-wing, wing + 1), np.arange(-wing, wing + 1),
                         indexing="ij")
    wgt = np.zeros_like(ii, dtype=np.float64)
    nz = (ii != 0) | (jj != 0)
    wgt[nz] = 1.0 / (np.abs(ii[nz]) ** p + np.abs(jj[nz]) ** p)
    denom = convolve2d(m, wgt, mode="same")
    out = img.copy()
    for c in range(img.shape[-1]):
        num = convolve2d(img[:, :, c] * m, wgt, mode="same")
        fill = np.divide(num, denom, out=np.zeros_like(num), where=denom > 0)
        out[:, :, c] = np.where(m > 0, img[:, :, c], fill)
    return out if image.ndim == 3 else out[:, :, 0]


def trajectory_psf(h: int = 37, rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Random camera-shake kernel from a 3-D random trajectory (reference
    ``blurkernel_synthesis``, ``utils_deblur.py:556-623``): random rotational
    and translational impulses integrated, the projected path histogrammed,
    smoothed by a 3x3 Gaussian and centre-padded to (h, h)."""
    rng = rng or np.random.default_rng()
    T = 150
    x = np.zeros((3, T))
    v = rng.standard_normal((3, T))
    r = np.zeros((3, T))
    trr = 2 * math.pi / T
    for t in range(1, T):
        f_rot = rng.standard_normal(3) / (t + 1) + r[:, t - 1]
        f_trans = rng.standard_normal(3) / (t + 1)
        r[:, t] = r[:, t - 1] + trr * f_rot
        v[:, t] = v[:, t - 1] + f_trans
        st = _rot3d(v[:, t], r[:, t])
        x[:, t] = x[:, t - 1] + st
    k = None
    while k is None:
        k = _kernel_from_trajectory(x, rng)
    pad0 = (h - k.shape[0]) // 2
    pad1 = (h - k.shape[1]) // 2
    if pad0 < 0 or pad1 < 0:
        k = k[:h, :h]
    else:
        k = np.pad(k, ((pad0, h - k.shape[0] - pad0), (pad1, h - k.shape[1] - pad1)))
    return k / k.sum()


def _rot3d(x: np.ndarray, r: np.ndarray) -> np.ndarray:
    cx, sx = math.cos(r[0]), math.sin(r[0])
    cy, sy = math.cos(r[1]), math.sin(r[1])
    cz, sz = math.cos(r[2]), math.sin(r[2])
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx @ x


def _kernel_from_trajectory(x: np.ndarray, rng: np.random.Generator) -> Optional[np.ndarray]:
    from scipy.signal import convolve2d

    h = 5 - math.log(rng.uniform()) / 0.15
    h = int(round(min(h, 27.0)))
    h = h + 1 - h % 2
    w = h
    k = np.zeros((h, w))
    xmin, xmax = x[0].min(), x[0].max()
    ymin, ymax = x[1].min(), x[1].max()
    xthr = np.arange(xmin, xmax, (xmax - xmin) / w)
    ythr = np.arange(ymin, ymax, (ymax - ymin) / h)
    for i in range(1, xthr.size):
        for j in range(1, ythr.size):
            idx = ((x[0] >= xthr[i - 1]) & (x[0] < xthr[i]) &
                   (x[1] >= ythr[j - 1]) & (x[1] < ythr[j]))
            k[i - 1, j - 1] = idx.sum()
    if k.sum() == 0:
        return None
    k = k / k.sum()
    k = convolve2d(k, fspecial_gaussian(3, 1), "same")
    return k / k.sum()


def blur_circular(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Circular (wrap) convolution of NHWC ``x`` with (B, kh, kw) kernels,
    spectral, on ``x``'s device: ``scipy.ndimage.convolve(img, k,
    mode='wrap')`` for odd-sized kernels, the degradation the FFT prox
    assumes (``main_ddpir.py:98-99``)."""
    from diffpir_tpu_torch.ops.fft_prox import psf_to_otf

    H, W = x.shape[1:3]
    otf = psf_to_otf(k.to(x.device), (H, W))[:, :, :, None]      # (B, H, W, 1)
    X = torch.fft.fft2(x.float(), dim=(1, 2))
    return torch.fft.ifft2(X * otf, dim=(1, 2)).real


def add_awgn(img01: np.ndarray, noise_level: float,
             rng: Optional[np.random.Generator] = None,
             legacy_seed: Optional[int] = None) -> np.ndarray:
    """AWGN of standard deviation ``noise_level`` on a [0, 1] image: the
    reference's N(0, 2 sigma) in [-1, 1] (``main_ddpir.py:112-114``).
    ``legacy_seed`` reproduces the reference's ``np.random.seed`` stream."""
    if legacy_seed is not None:
        np.random.seed(legacy_seed)
        x = img01 * 2 - 1
        x = x + np.random.normal(0, noise_level * 2, img01.shape)
        return x / 2 + 0.5
    rng = rng or np.random.default_rng()
    return img01 + rng.normal(0, noise_level, img01.shape)
