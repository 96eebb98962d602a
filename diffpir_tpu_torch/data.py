"""Host-side data pipeline: load, degrade, and batch test images.

The inpainting branch of ``diffpir_tpu/data.py`` (reference
``main_ddpir.py:38-117``), in plain numpy.  The numpy RNG calls happen in the
same order as in the JAX package (the caller seeds ``np.random`` with
``cfg.seed`` first, each mask draws from ``default_rng(cfg.seed + idx)``, the
AWGN from ``np.random.normal``), so the degraded inputs match it bit for bit.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np

from diffpir_tpu_torch.config import TaskConfig
from diffpir_tpu_torch.ops.degrade import make_mask
from diffpir_tpu_torch.utils import image as im

__all__ = ["Batch", "prepare_images", "make_batches"]


@dataclasses.dataclass
class Batch:
    """One fixed-shape work unit for the sampler."""

    img_H: np.ndarray           # (B, H, W, C) uint8 ground truth
    img_L: np.ndarray           # (B, H, W, C) float32 degraded, [0, 1]
    mask: np.ndarray            # (B, H, W, C) float32 in {0,1}
    names: list[str]


def prepare_images(cfg: TaskConfig, paths: Optional[list[str]] = None) -> list[dict]:
    """Degrade each test image; returns per-image dicts."""
    if cfg.task != "inpaint":
        raise NotImplementedError(
            f"task {cfg.task!r} is not ported yet (ROADMAP.md queue A: "
            "deblur and SR with ops/fft_prox.py and ops/resize.py)")
    paths = paths if paths is not None else im.list_images(cfg.L_path)
    items = []
    for idx, path in enumerate(paths):
        img_H = im.imread_uint(path, cfg.n_channels)
        img_H = im.modcrop(img_H, cfg.sf)
        H, W = img_H.shape[:2]
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

        items.append(dict(img_H=img_H, img_L=img_L.astype(np.float32),
                          mask=mask,
                          name=os.path.basename(path)))
    return items


def make_batches(items: list[dict], batch_size: int) -> list[Batch]:
    """Group per-image items into batches of at most ``batch_size``."""
    batches = []
    for i in range(0, len(items), batch_size):
        chunk = items[i:i + batch_size]
        batches.append(Batch(
            img_H=np.stack([it["img_H"] for it in chunk]),
            img_L=np.stack([it["img_L"] for it in chunk]).astype(np.float32),
            mask=np.stack([it["mask"] for it in chunk]).astype(np.float32),
            names=[it["name"] for it in chunk],
        ))
    return batches
