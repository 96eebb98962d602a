"""Large-image and ensemble evaluation of the denoiser (``test_mode`` 0-4).

Port of ``diffpir_tpu/inference.py`` (reference ``utils/utils_model.py:16-195``)
on NHWC tensors: pad to a modulo, recursive overlapping quadrants for images
larger than the model's size, and the x8 dihedral self-ensemble with the 8
variants stacked into one model call (two calls of four for non-square
inputs).  ``fn`` is any NHWC -> NHWC function, typically the UNet at a
fixed timestep.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F

__all__ = ["augment8", "invert8", "x8_apply", "pad_modulo_apply", "split_apply",
           "test_mode"]


def test_mode(fn: Callable, x: torch.Tensor, mode: int = 0, *, refield: int = 32,
              min_size: int = 256, modulo: int = 16) -> torch.Tensor:
    """The reference's evaluation modes (``utils/utils_model.py:16-45``):
    0 direct, 1 pad to modulo, 2 recursive split, 3 x8 ensemble, 4 split and
    x8."""
    if mode == 0:
        return fn(x)
    if mode == 1:
        return pad_modulo_apply(fn, x, modulo)
    if mode == 2:
        return split_apply(fn, x, refield=refield, min_size=min_size, modulo=modulo)
    if mode == 3:
        return x8_apply(fn, x)
    if mode == 4:
        return x8_apply(lambda v: split_apply(fn, v, refield=refield,
                                              min_size=min_size, modulo=modulo), x)
    raise ValueError(f"unknown test mode {mode}")


def _dihedral(x: torch.Tensor, mode: int) -> torch.Tensor:
    """Variant ``mode`` (0-7) of an NHWC batch (``utils_image.augment_img``)."""
    if mode >= 4:
        x = x.transpose(1, 2)
    rot = mode % 4
    if rot == 1:
        x = x.flip(1)
    elif rot == 2:
        x = x.flip(1, 2)
    elif rot == 3:
        x = x.flip(2)
    return x


# the flips are involutions; after a transpose the flip axis swaps (1 <-> 3)
_INV = [0, 1, 2, 3, 4, 7, 6, 5]


def augment8(x: torch.Tensor) -> torch.Tensor:
    """(B,H,W,C) -> (8B,H,W,C): the eight dihedral variants on the batch axis."""
    return torch.cat([_dihedral(x, m) for m in range(8)], dim=0)


def invert8(x8: torch.Tensor) -> torch.Tensor:
    """Undo each group's transform and average -> (B,H,W,C)."""
    b = x8.shape[0] // 8
    return torch.stack([_dihedral(x8[m * b:(m + 1) * b], _INV[m])
                        for m in range(8)]).mean(dim=0)


def x8_apply(fn: Callable, x: torch.Tensor) -> torch.Tensor:
    """Geometric self-ensemble: ``fn`` on all eight variants, averaged back.
    A non-square input cannot stack its transposed variants with the others,
    so it takes two calls of four variants."""
    b, h, w, _ = x.shape
    if h == w:
        return invert8(fn(augment8(x)))
    out_r = fn(torch.cat([_dihedral(x, m) for m in range(4)], dim=0))
    out_t = fn(torch.cat([_dihedral(x, m) for m in range(4, 8)], dim=0))
    parts = [_dihedral(out_r[m * b:(m + 1) * b], _INV[m]) for m in range(4)]
    parts += [_dihedral(out_t[(m - 4) * b:(m - 3) * b], _INV[m]) for m in range(4, 8)]
    return torch.stack(parts).mean(dim=0)


def pad_modulo_apply(fn: Callable, x: torch.Tensor, modulo: int = 16) -> torch.Tensor:
    """Pad H and W up to a multiple of ``modulo`` by repeating the edge
    (reference ``test_pad``, ``utils_model.py:60-66``), apply, crop."""
    _, h, w, _ = x.shape
    ph, pw = (-h) % modulo, (-w) % modulo
    if ph or pw:
        x = F.pad(x.permute(0, 3, 1, 2), (0, pw, 0, ph), mode="replicate").permute(0, 2, 3, 1)
    return fn(x)[:, :h, :w, :]


def split_apply(fn: Callable, x: torch.Tensor, *, refield: int = 32,
                min_size: int = 256, modulo: int = 16) -> torch.Tensor:
    """Recursive overlapping quadrants for large images (reference
    ``test_split_fn``, ``utils_model.py:84-117``): the quarters overlap by
    ``refield`` so every output pixel sees its full receptive field, and the
    stitched output takes each quadrant's interior."""
    b, h, w, _ = x.shape
    if h * w <= min_size ** 2:
        return pad_modulo_apply(fn, x, modulo)
    th = (h // 2 // refield + 1) * refield
    tw = (w // 2 // refield + 1) * refield
    top, bottom = slice(0, th), slice(h - th, h)
    left, right = slice(0, tw), slice(w - tw, w)
    outs = [split_apply(fn, x[:, r, c], refield=refield, min_size=min_size,
                        modulo=modulo)
            for r, c in ((top, left), (top, right), (bottom, left), (bottom, right))]
    # the output may have more channels than the input (a learned-sigma UNet)
    out = outs[0].new_zeros((b, h, w, outs[0].shape[-1]))
    h2, w2 = math.ceil(h / 2), math.ceil(w / 2)
    out[:, :h2, :w2] = outs[0][:, :h2, :w2]
    out[:, :h2, w2:] = outs[1][:, :h2, w2 - w:]
    out[:, h2:, :w2] = outs[2][:, h2 - h:, :w2]
    out[:, h2:, w2:] = outs[3][:, h2 - h:, w2 - w:]
    return out
