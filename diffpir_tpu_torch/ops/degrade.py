"""Inpainting masks (host-side numpy; reference ``utils/utils_inpaint.py:67-137``).

Copy of ``box_mask``/``random_mask``/``make_mask`` from
``diffpir_tpu/ops/degrade.py``: the same numpy RNG draws in the same order, so
a seed gives the JAX package's masks bit for bit.  The blur kernels and
forward operators of that module belong to the deblur and SR tasks, which the
port does not run yet.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = ["box_mask", "random_mask", "make_mask"]


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
