"""MATLAB-exact separable image resizing as two dense contractions.

Port of ``diffpir_tpu/ops/resize.py`` (reference ``utils/utils_resizer.py``
and ``utils/utils_image.py:680-805``).  Each spatial dimension's resize is a
dense (out_len, in_len) matrix built once on the host in numpy
(``resize_matrix``, copied as it is from the JAX package); applying it is two
fp32 ``torch.einsum`` contractions.  On the card fp32 means fp32 only with
``torch.backends.cuda.matmul.allow_tf32`` off, which the Runner sets for
fp32 configs.

``bilinear_resize`` is ``jax.image.resize(..., "bilinear")``, which
``SuperResUNet`` and the FID's input resize use: the same two contractions
with ``bilinear_matrix``'s weights.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Callable

import numpy as np
import torch

__all__ = ["resize_matrix", "resize2d", "Resizer2D", "cubic_kernel",
           "bilinear_matrix", "bilinear_resize"]


def cubic_kernel(x: np.ndarray) -> np.ndarray:
    """Keys cubic (a = -0.5), the MATLAB 'bicubic' kernel."""
    ax = np.abs(x)
    ax2, ax3 = ax**2, ax**3
    return ((1.5 * ax3 - 2.5 * ax2 + 1.0) * (ax <= 1) +
            (-0.5 * ax3 + 2.5 * ax2 - 4.0 * ax + 2.0) * ((1 < ax) & (ax <= 2)))


def cubic_torch_kernel(x: np.ndarray) -> np.ndarray:
    """Keys cubic with a = -0.75 — torch/OpenCV 'bicubic' (F.interpolate)."""
    a = -0.75
    ax = np.abs(x)
    ax2, ax3 = ax**2, ax**3
    return (((a + 2) * ax3 - (a + 3) * ax2 + 1.0) * (ax <= 1) +
            (a * ax3 - 5 * a * ax2 + 8 * a * ax - 4 * a) * ((1 < ax) & (ax <= 2)))


def linear_kernel(x: np.ndarray) -> np.ndarray:
    return (x + 1) * ((-1 <= x) & (x < 0)) + (1 - x) * ((0 <= x) & (x <= 1))


def box_kernel(x: np.ndarray) -> np.ndarray:
    return (((-0.5 <= x) & (x < 0.5))).astype(np.float64)


def _lanczos(x: np.ndarray, a: int) -> np.ndarray:
    eps = np.finfo(np.float32).eps
    return (((np.sin(math.pi * x) * np.sin(math.pi * x / a) + eps) /
             ((math.pi**2 * x**2 / a) + eps)) * (np.abs(x) < a))


_KERNELS: dict[str, tuple[Callable, float]] = {
    "cubic": (cubic_kernel, 4.0),
    "cubic_torch": (cubic_torch_kernel, 4.0),
    "linear": (linear_kernel, 2.0),
    "box": (box_kernel, 1.0),
    "lanczos2": (lambda x: _lanczos(x, 2), 4.0),
    "lanczos3": (lambda x: _lanczos(x, 3), 6.0),
}


@lru_cache(maxsize=64)
def resize_matrix(in_length: int, out_length: int, scale: float,
                  kernel: str = "cubic", antialiasing: bool = True) -> np.ndarray:
    """Dense 1-D resize operator R: (out_length, in_length) float32.

    out[i] = sum_j R[i, j] * in[j].  Weights/field-of-view math follows
    reference ``utils_resizer.py:104-167`` exactly (including the +-1 pixel
    expanded support, weight normalization, and mirror boundary folding).
    """
    kfunc, kwidth = _KERNELS[kernel]
    antialiasing = antialiasing and scale < 1
    fixed = (lambda arg: scale * kfunc(scale * arg)) if antialiasing else kfunc
    kwidth = kwidth / scale if antialiasing else kwidth

    out_coords = np.arange(1, out_length + 1, dtype=np.float64)
    shifted = out_coords - (out_length - in_length * scale) / 2
    match = shifted / scale + 0.5 * (1 - 1 / scale)
    left = np.floor(match - kwidth / 2)
    p = int(math.ceil(kwidth)) + 2
    fov = left[:, None] + np.arange(p)[None, :] - 1          # (out, p)
    weights = fixed(match[:, None] - fov - 1)
    ssum = weights.sum(axis=1)
    ssum[ssum == 0] = 1.0
    weights = weights / ssum[:, None]
    # mirror (symmetric) boundary folding
    mirror = np.concatenate([np.arange(in_length), np.arange(in_length - 1, -1, -1)])
    fov_idx = mirror[np.mod(fov.astype(np.int64), mirror.shape[0])]

    R = np.zeros((out_length, in_length), dtype=np.float64)
    for j in range(p):
        np.add.at(R, (np.arange(out_length), fov_idx[:, j]), weights[:, j])
    return R.astype(np.float32)


def _apply(rh: torch.Tensor, rw: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    x = torch.einsum("oh,bhwc->bowc", rh, x)
    return torch.einsum("ow,bhwc->bhoc", rw, x)


def resize2d(x: torch.Tensor, scale: float | tuple[float, float] = None,
             out_shape: tuple[int, int] | None = None, kernel: str = "cubic",
             antialiasing: bool = True) -> torch.Tensor:
    """Resize the NHWC batch ``x`` by ``scale`` (or to ``out_shape``) with
    MATLAB semantics, in fp32; returns ``x``'s type."""
    b, h, w, c = x.shape
    if out_shape is None:
        sh, sw = (scale, scale) if np.isscalar(scale) else scale
        out_shape = (int(np.ceil(h * sh)), int(np.ceil(w * sw)))
    else:
        sh, sw = out_shape[0] / h, out_shape[1] / w
    rh, rw = (torch.from_numpy(resize_matrix(n, o, float(s), kernel, antialiasing))
              .to(x.device) for n, o, s in ((h, out_shape[0], sh), (w, out_shape[1], sw)))
    return _apply(rh, rw, x.float()).to(x.dtype)


class Resizer2D:
    """Resize operator for a fixed (in_shape, scale), fp32 (reference
    ``utils_resizer.Resizer``; the SR 'cubic' degradation and init).  The two
    matrices are copied to a device once, at the first call there."""

    def __init__(self, in_hw: tuple[int, int], scale: float,
                 kernel: str = "cubic", antialiasing: bool = True):
        h, w = in_hw
        out_h, out_w = int(np.ceil(h * scale)), int(np.ceil(w * scale))
        self.out_hw = (out_h, out_w)
        self.Rh = torch.from_numpy(resize_matrix(h, out_h, scale, kernel, antialiasing))
        self.Rw = torch.from_numpy(resize_matrix(w, out_w, scale, kernel, antialiasing))

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.Rh.device != x.device:
            self.Rh, self.Rw = self.Rh.to(x.device), self.Rw.to(x.device)
        return _apply(self.Rh, self.Rw, x.float())


def bilinear_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(in_size, out_size) float32 weights of ``jax.image.resize``'s bilinear
    resize along one axis (``compute_weight_mat`` of ``jax/_src/image/
    scale.py``, antialiased): sample points at half-pixel centres, a triangle
    kernel widened by in/out when it shrinks, each output's weights divided
    by their sum, outputs outside the input zero."""
    f = np.float32
    inv_scale = f(1.0 / (out_size / in_size))
    kernel_scale = max(inv_scale, f(1.0))
    sample = (np.arange(out_size, dtype=f) + f(0.5)) * inv_scale - f(0.5)
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=f)[:, None]) / kernel_scale
    w = np.maximum(f(0.0), f(1.0) - np.abs(x)).astype(f)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f(1.0)), f(0.0)).astype(f)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, f(0.0)).astype(f)


@lru_cache(maxsize=64)
def _bilinear_on(in_size: int, out_size: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(bilinear_matrix(in_size, out_size)).to(device)


def bilinear_resize(x: torch.Tensor, hw: tuple[int, int]) -> torch.Tensor:
    """``jax.image.resize(x, (B, *hw, C), "bilinear")`` for an NHWC tensor,
    in fp32 (the input's type for bf16 inputs, as JAX casts the weights)."""
    mh = _bilinear_on(x.shape[1], hw[0], x.device).to(x.dtype)
    mw = _bilinear_on(x.shape[2], hw[1], x.device).to(x.dtype)
    x = torch.einsum("bhwc,hH->bHwc", x, mh)
    return torch.einsum("bHwc,wW->bHWc", x, mw)
