"""Image I/O, dtype conversion and quality metrics for the PyTorch port.

Copy of the parts of ``diffpir_tpu/utils/image.py`` that the inpainting path
uses, with the same semantics, without Pillow: files are read by
``diffpir_tpu_torch.utils.imageio`` (PNG, JPEG, BMP, PPM/PGM/PBM, GIF and
TIFF, each bit-equal to Pillow's ``convert("RGB")``/``convert("L")``) and
written as PNG by ``diffpir_tpu_torch.utils.png``.

  * ``psnr``        uint8 [0,255] images, border crop, fp64 MSE
  * ``psnr_batch``  mean per-image PSNR over a batch, max_pixel=2 for [-1,1]
  * ``psnr_region`` PSNR over a region's pixels only (inpainting holes)
  * ``ssim``        MATLAB SSIM: 11x11 Gaussian sigma 1.5, valid-region crop,
                    optionally averaged over a region
  * ``rgb_to_y``    MATLAB rgb2ycbcr Y channel
  * ``rgb_to_ycbcr``/``ycbcr_to_rgb`` MATLAB rgb2ycbcr/ycbcr2rgb, mutation-free
  * ``augment``/``augment_inverse`` the 8 dihedral modes of the x8 ensemble
"""

from __future__ import annotations

import math
import os
from typing import Optional, Sequence

import numpy as np
from scipy.ndimage import correlate1d

from diffpir_tpu_torch.utils.imageio import read_image
from diffpir_tpu_torch.utils.png import write_png

__all__ = [
    "list_images", "imread_uint", "imsave", "imsave_batch", "uint2single",
    "single2uint", "modcrop", "shave", "psnr", "psnr_batch", "psnr_region", "ssim",
    "rgb_to_y", "rgb_to_y_batch", "rgb_to_ycbcr", "ycbcr_to_rgb", "augment",
    "augment_inverse",
]

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".tif", ".tiff")


def list_images(root: str) -> list[str]:
    """Sorted recursive listing of image files (reference ``get_image_paths``)."""
    paths = []
    for dirpath, _, files in sorted(os.walk(root)):
        for f in sorted(files):
            if f.lower().endswith(IMG_EXTENSIONS):
                paths.append(os.path.join(dirpath, f))
    return paths


def imread_uint(path: str, n_channels: int = 3) -> np.ndarray:
    """Read an image as uint8 HxWxC: RGB for 3 channels, gray for 1, as
    Pillow's ``Image.open(path).convert("RGB")``/``convert("L")`` (the
    format from the file's first bytes, not its extension)."""
    if n_channels == 1:
        return read_image(path, "L")[:, :, None]
    return read_image(path, "RGB")


def imsave(img: np.ndarray, path: str) -> None:
    img = np.squeeze(img)
    if img.dtype != np.uint8:
        img = single2uint(img)
    write_png(img, path)


def imsave_batch(imgs: np.ndarray, names: Sequence[str], out_dir: str,
                 prefix: str = "") -> None:
    """Save a batch (B,H,W,C); filenames ``<prefix><stem>.png``."""
    os.makedirs(out_dir, exist_ok=True)
    for img, name in zip(imgs, names):
        stem = os.path.splitext(os.path.basename(name))[0]
        imsave(img, os.path.join(out_dir, f"{prefix}{stem}.png"))


def uint2single(img: np.ndarray) -> np.ndarray:
    return np.float32(img / 255.0)


def single2uint(img: np.ndarray) -> np.ndarray:
    return np.uint8((np.clip(img, 0.0, 1.0) * 255.0).round())


def modcrop(img: np.ndarray, scale: int) -> np.ndarray:
    """Crop H, W to multiples of `scale` (reference ``utils_image.py:538-551``)."""
    h, w = img.shape[:2]
    return img[: h - h % scale, : w - w % scale, ...]


def shave(img: np.ndarray, border: int = 0) -> np.ndarray:
    h, w = img.shape[:2]
    return img[border : h - border, border : w - border, ...]


def psnr(img1: np.ndarray, img2: np.ndarray, border: int = 0) -> float:
    """PSNR between uint8-range [0,255] images, border-cropped, fp64."""
    if img1.shape != img2.shape:
        raise ValueError("Input images must have the same dimensions.")
    img1 = shave(img1, border).astype(np.float64)
    img2 = shave(img2, border).astype(np.float64)
    mse = np.mean((img1 - img2) ** 2)
    if mse == 0:
        return float("inf")
    return 20 * math.log10(255.0 / math.sqrt(mse))


def psnr_batch(batch1: np.ndarray, batch2: np.ndarray, max_pixel: float = 2.0,
               eps: float = 1e-10) -> float:
    """Mean per-image PSNR over a batch (any layout; reduces all but axis 0)."""
    if batch1.shape != batch2.shape:
        raise ValueError("Input images must have the same dimensions.")
    d = np.asarray(batch1, np.float32) - np.asarray(batch2, np.float32)
    d = d.reshape(d.shape[0], -1)
    mse = np.einsum("bi,bi->b", d, d, dtype=np.float64) / d.shape[1]
    vals = np.where(mse == 0, np.inf, 20 * np.log10(max_pixel / np.sqrt(mse + eps)))
    vals = np.where(np.isnan(vals), 0.0, vals)
    return float(np.mean(vals))


def psnr_region(img1: np.ndarray, img2: np.ndarray, region: np.ndarray,
                max_pixel: float = 2.0) -> float:
    """PSNR over the ``region > 0`` pixels of one image (fp64); ``region``
    broadcasts against the image, e.g. (H, W, 1) against (H, W, C).  With
    ``recover_known`` the observed pixels are pasted back exactly, so this
    measures what the model painted into the hole."""
    if img1.shape != img2.shape:
        raise ValueError("Input images must have the same dimensions.")
    w = np.broadcast_to(np.asarray(region, np.float64) > 0, img1.shape)
    n = w.sum()
    if n == 0:
        return float("nan")
    d = ((img1.astype(np.float64) - img2.astype(np.float64)) * w).ravel()
    mse = np.einsum("i,i->", d, d) / n
    if mse == 0:
        return float("inf")
    return float(20 * np.log10(max_pixel / np.sqrt(mse)))


def _gaussian_kernel1d(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    ax = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    k = np.exp(-(ax**2) / (2.0 * sigma**2))
    return k / k.sum()


def _gauss_filter_valid(x: np.ndarray, k1d: np.ndarray) -> np.ndarray:
    """Separable Gaussian correlation, cropped to the valid region."""
    wing = len(k1d) // 2
    y = correlate1d(x, k1d, axis=0)
    y = correlate1d(y, k1d, axis=1)
    return y[wing:-wing, wing:-wing]


def _ssim_single(img1: np.ndarray, img2: np.ndarray,
                 region: Optional[np.ndarray] = None) -> float:
    C1, C2 = (0.01 * 255) ** 2, (0.03 * 255) ** 2
    img1 = img1.astype(np.float64)
    img2 = img2.astype(np.float64)
    k1d = _gaussian_kernel1d(11, 1.5)
    mu1 = _gauss_filter_valid(img1, k1d)
    mu2 = _gauss_filter_valid(img2, k1d)
    mu1_sq, mu2_sq, mu1_mu2 = mu1**2, mu2**2, mu1 * mu2
    s1 = _gauss_filter_valid(img1**2, k1d) - mu1_sq
    s2 = _gauss_filter_valid(img2**2, k1d) - mu2_sq
    s12 = _gauss_filter_valid(img1 * img2, k1d) - mu1_mu2
    ssim_map = ((2 * mu1_mu2 + C1) * (2 * s12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (s1 + s2 + C2))
    if region is None:
        return float(ssim_map.mean())
    # the SSIM map's mean over the region's pixels, on the same valid grid
    wing = len(k1d) // 2
    w = (np.asarray(region, np.float64) > 0)[wing:-wing, wing:-wing]
    n = w.sum()
    if n == 0:
        return float("nan")
    return float((ssim_map * w).sum() / n)


def ssim(img1: np.ndarray, img2: np.ndarray, border: int = 0,
         region: Optional[np.ndarray] = None) -> float:
    """MATLAB-style SSIM on [0,255] images; RGB averages per-channel SSIM.
    ``region`` (H, W), if given, averages the SSIM map over its pixels > 0
    only (the inpainting hole metric)."""
    if img1.shape != img2.shape:
        raise ValueError("Input images must have the same dimensions.")
    img1, img2 = shave(img1, border), shave(img2, border)
    if region is not None:
        region = shave(region, border)
    if img1.ndim == 2:
        return _ssim_single(img1, img2, region)
    if img1.shape[2] == 1:
        return _ssim_single(img1[..., 0], img2[..., 0], region)
    return float(np.mean([_ssim_single(img1[..., c], img2[..., c], region)
                          for c in range(img1.shape[2])]))


def rgb_to_y(img: np.ndarray) -> np.ndarray:
    """MATLAB rgb2ycbcr Y channel. uint8 in -> uint8 out; float [0,1] -> [0,1]."""
    in_type = img.dtype
    x = img.astype(np.float64)
    if in_type != np.uint8:
        x = x * 255.0
    y = x @ np.array([65.481, 128.553, 24.966]) / 255.0 + 16.0
    if in_type == np.uint8:
        return y.round().astype(np.uint8)
    return (y / 255.0).astype(in_type)


def rgb_to_y_batch(batch: np.ndarray) -> np.ndarray:
    """BT.601 luma combo on (B,H,W,3) in the caller's domain
    (the reference applies it directly to [-1,1] images for PSNR-Y)."""
    return (0.299 * batch[..., 0] + 0.587 * batch[..., 1]
            + 0.114 * batch[..., 2])[..., None]


def rgb_to_ycbcr(img: np.ndarray, only_y: bool = True) -> np.ndarray:
    """MATLAB rgb2ycbcr (reference ``utils_image.py:446-467``): uint8 [0,255]
    in -> uint8 out, float [0,1] -> float [0,1].  Unlike the reference, the
    input is never changed in place."""
    if only_y:
        return rgb_to_y(img)
    in_type = img.dtype
    x = img.astype(np.float64)
    if in_type != np.uint8:
        x = x * 255.0
    m = np.array([[65.481, -37.797, 112.0],
                  [128.553, -74.203, -93.786],
                  [24.966, 112.0, -18.214]])
    out = x @ m / 255.0 + np.array([16.0, 128.0, 128.0])
    if in_type == np.uint8:
        return out.round().astype(np.uint8)
    return (out / 255.0).astype(in_type)


def ycbcr_to_rgb(img: np.ndarray) -> np.ndarray:
    """MATLAB ycbcr2rgb (reference ``utils_image.py:493-511``), the inverse of
    ``rgb_to_ycbcr(only_y=False)`` up to the [0,255] clip; input unchanged."""
    in_type = img.dtype
    x = img.astype(np.float64)
    if in_type != np.uint8:
        x = x * 255.0
    m = np.array([[0.00456621, 0.00456621, 0.00456621],
                  [0.0, -0.00153632, 0.00791071],
                  [0.00625893, -0.00318811, 0.0]])
    out = x @ m * 255.0 + np.array([-222.921, 135.576, -276.836])
    out = np.clip(out, 0, 255)
    if in_type == np.uint8:
        return out.round().astype(np.uint8)
    return (out / 255.0).astype(in_type)


def augment(img: np.ndarray, mode: int) -> np.ndarray:
    """Dihedral modes 0-7 of reference ``augment_img`` (``utils_image.py:333-351``)."""
    if mode == 0:
        return img
    if mode == 1:
        return np.flipud(np.rot90(img))
    if mode == 2:
        return np.flipud(img)
    if mode == 3:
        return np.rot90(img, k=3)
    if mode == 4:
        return np.flipud(np.rot90(img, k=2))
    if mode == 5:
        return np.rot90(img)
    if mode == 6:
        return np.rot90(img, k=2)
    if mode == 7:
        return np.flipud(np.rot90(img, k=3))
    raise ValueError(mode)


def augment_inverse(img: np.ndarray, mode: int) -> np.ndarray:
    """The inverse of ``augment`` (the reference's x8 ensemble undoes modes
    3 and 5 with each other)."""
    inv = {0: 0, 1: 1, 2: 2, 3: 5, 4: 4, 5: 3, 6: 6, 7: 7}
    return augment(img, inv[mode])
