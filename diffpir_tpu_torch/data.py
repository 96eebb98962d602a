"""Host-side data pipeline: load, degrade, and batch test images.

Port of ``diffpir_tpu/data.py`` (reference ``main_ddpir.py:38-117``) for
deblurring, super-resolution and inpainting, in plain numpy and scipy; the SR
resizes run through ``ops.resize.resize2d`` on the CPU in fp32.  The numpy
RNG calls happen in the same order as in the JAX package (the caller seeds
``np.random`` with ``cfg.seed`` first; a DIY blur kernel reseeds it with
``idx * 10``, and a DIY motion PSF draws from ``default_rng(idx * 10)``;
each mask draws from ``default_rng(cfg.seed + idx)``; the AWGN
from ``np.random.normal``), so the degraded inputs match it bit for bit where
the path is numpy or scipy.

Kernel assets are the reference's .mat collections converted to .npz
(``assets/kernels/``): ``bicubic_x234`` (= kernels_bicubicx234.mat),
``classical_12`` (= kernels_12.mat), ``levin09`` (= Levin09.mat).
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Optional

import numpy as np
import torch

from diffpir_tpu_torch.config import TaskConfig
from diffpir_tpu_torch.ops.degrade import (classical_degradation, gaussian_psf,
                                           make_mask, motion_psf, shift_pixel)
from diffpir_tpu_torch.ops.resize import resize2d
from diffpir_tpu_torch.utils import image as im

__all__ = ["Batch", "load_kernel_asset", "prepare_images", "make_batches"]

_ASSETS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "assets", "kernels")


@dataclasses.dataclass
class Batch:
    """One fixed-shape work unit for the sampler."""

    img_H: np.ndarray           # (B, H, W, C) uint8 ground truth
    img_L: np.ndarray           # (B, h, w, C) float32 degraded, [0, 1]
    kernel: np.ndarray          # (B, kh, kw) float32 (1x1 ones for inpaint)
    mask: np.ndarray            # (B, H, W, C) float32 in {0,1}
    names: list[str]
    init: Optional[np.ndarray] = None  # (B, H, W, C) [0,1] x-init override
                                       # (SR classical: shifted upscale)


@functools.lru_cache(maxsize=32)
def load_kernel_asset(name: str, key: str) -> np.ndarray:
    with np.load(os.path.join(_ASSETS, f"{name}.npz")) as z:
        return z[key]


def _kernel_for(cfg: TaskConfig, idx: int) -> np.ndarray:
    if cfg.task == "sr":
        if cfg.sr_mode == "classical":
            # classical PSF set (kernels_12.mat; main_ddpir_sisr.py:153)
            return load_kernel_asset("classical_12",
                                     f"k{cfg.classical_kernel_index}").astype(np.float64)
        k_index = cfg.sf if cfg.sf < 5 else 4
        return load_kernel_asset("bicubic_x234", f"x{k_index}").astype(np.float64)
    if cfg.task == "deblur":
        if cfg.use_DIY_kernel:
            # per-image reproducible kernel stream (main_ddpir.py:59)
            np.random.seed(idx * 10)
            if cfg.blur_mode == "Gaussian":
                std_i = cfg.kernel_std * np.abs(np.random.rand() * 2 + 1)
                return gaussian_psf(cfg.kernel_size, std_i).astype(np.float32)
            rng = np.random.default_rng(idx * 10)
            return motion_psf(cfg.kernel_size, cfg.kernel_std, rng).astype(np.float32)
        return load_kernel_asset("levin09", "k0").astype(np.float32)
    return np.ones((1, 1), np.float32)


def _resize(img: np.ndarray, scale: float, **kw) -> np.ndarray:
    return resize2d(torch.from_numpy(np.ascontiguousarray(img))[None], scale,
                    **kw)[0].numpy()


def prepare_images(cfg: TaskConfig, paths: Optional[list[str]] = None) -> list[dict]:
    """Degrade each test image; returns per-image dicts (kernels of different
    sizes are padded at batching time)."""
    from scipy import ndimage

    paths = paths if paths is not None else im.list_images(cfg.L_path)
    items = []
    for idx, path in enumerate(paths):
        k = _kernel_for(cfg, idx)
        img_H = im.imread_uint(path, cfg.n_channels)
        img_H = im.modcrop(img_H, cfg.sf)
        H, W = img_H.shape[:2]

        init = None
        if cfg.task == "sr":
            if cfg.sr_mode == "blur":
                img_L = _resize(im.uint2single(img_H), 1 / cfg.sf)
            elif cfg.sr_mode == "classical":
                # blur (wrap) + strided subsample (main_ddpir_sisr.py:212-248);
                # the init is built from the noisy observation, after the AWGN
                img_L = classical_degradation(im.uint2single(img_H), k, cfg.sf)
            else:  # cubic
                img_L = _resize(img_H.astype(np.float32) / 255.0, 1 / cfg.sf)
            mask = np.ones((H, W, img_H.shape[2]), np.float32)
        elif cfg.task == "deblur":
            # wrap-mode blur of the uint8 image, then /255 (main_ddpir.py:99-100,
            # scipy's integer rounding included)
            img_L = ndimage.convolve(img_H, np.expand_dims(k, axis=2), mode="wrap")
            img_L = im.uint2single(img_L)
            mask = np.ones_like(img_L, np.float32)
        else:  # inpaint
            if cfg.load_mask:
                mask_path = os.path.join(cfg.testsets, cfg.mask_name)
                mask = im.imread_uint(mask_path, cfg.n_channels).astype(bool)
                mask = mask.astype(np.float32)
            else:
                m2d = make_mask(cfg.mask_type, image_size=(H, W),
                                mask_len_range=cfg.mask_len_range,
                                mask_prob_range=cfg.mask_prob_range,
                                rng=np.random.default_rng(cfg.seed + idx))
                mask = np.repeat(m2d[:, :, None], img_H.shape[2], axis=2)
            img_L = img_H * mask / 255.0

        # AWGN in [-1,1] domain (main_ddpir.py:112-114)
        img_L = img_L * 2 - 1
        img_L = img_L + np.random.normal(0, cfg.noise_level_img * 2, img_L.shape)
        img_L = img_L / 2 + 0.5

        if cfg.task == "sr" and cfg.sr_mode == "classical":
            # bicubic upscale of the noisy observation, then the half-pixel
            # shift (main_ddpir_sisr.py:216-248: AWGN at 218 comes before the
            # upscale at 244 and shift_pixel at 248)
            up = _resize(img_L.astype(np.float32), float(cfg.sf),
                         kernel="cubic_torch", antialiasing=False)
            init = shift_pixel(up, cfg.sf).astype(np.float32)

        items.append(dict(img_H=img_H, img_L=img_L.astype(np.float32),
                          kernel=np.asarray(k, np.float32), mask=mask,
                          init=init, name=os.path.basename(path)))
    return items


def make_batches(items: list[dict], batch_size: int,
                 pad_to_batch: bool = False) -> list[Batch]:
    """Group per-image items into batches of at most ``batch_size``.

    Kernels inside one batch are zero-padded to a common size with the centre
    kept at size//2, which ``psf_to_otf`` rolls to the origin, so the padding
    leaves the OTF unchanged.  With ``pad_to_batch`` a short last batch is
    filled up by repeating its first item (a batch split over data ranks);
    its ``names`` keep only the real items."""
    batches = []
    for i in range(0, len(items), batch_size):
        chunk = items[i:i + batch_size]
        n_real = len(chunk)
        if pad_to_batch and n_real < batch_size:
            chunk = chunk + [chunk[0]] * (batch_size - n_real)
        kmax = max(it["kernel"].shape[0] for it in chunk)
        kmax2 = max(it["kernel"].shape[1] for it in chunk)

        def pad_k(k):
            p0 = kmax // 2 - k.shape[0] // 2
            p1 = kmax2 // 2 - k.shape[1] // 2
            return np.pad(k, ((p0, kmax - k.shape[0] - p0),
                              (p1, kmax2 - k.shape[1] - p1)))

        has_init = chunk[0]["init"] is not None
        batches.append(Batch(
            img_H=np.stack([it["img_H"] for it in chunk]),
            img_L=np.stack([it["img_L"] for it in chunk]).astype(np.float32),
            kernel=np.stack([pad_k(it["kernel"]) for it in chunk]).astype(np.float32),
            mask=np.stack([it["mask"] for it in chunk]).astype(np.float32),
            names=[it["name"] for it in chunk[:n_real]],
            init=(np.stack([it["init"] for it in chunk]).astype(np.float32)
                  if has_init else None),
        ))
    return batches
