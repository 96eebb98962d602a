"""Closed-form FFT data-fidelity proximal solver for SR and deblurring.

Port of ``diffpir_tpu/ops/fft_prox.py`` (reference ``utils/utils_sisr.py``).
Solves  argmin_x ||y - (k * x) ↓sf||^2 + tau ||x - x0||^2  exactly in the
Fourier domain with the sf x sf alias-block split:

  * ``psf_to_otf``  == ``p2o``           (``utils_sisr.py:22-41``)
  * ``precompute``  == ``pre_calculate`` (``utils_sisr.py:78-95``)
  * ``prox_solve``  == ``data_solution`` (``utils_sisr.py:65-75``), in the
    JAX package's cancellation-free form

NHWC layout, FFTs over dims (1, 2) with ``torch.fft`` in complex64: the prox
is an fp32 island whatever type the UNet runs in.  The JAX package leaves
the FFTs to XLA; on the card they run on cuFFT.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["psf_to_otf", "ProxOperator", "precompute", "prox_solve",
           "upsample_zeros", "downsample_strided", "alias_block_mean"]


def psf_to_otf(psf: torch.Tensor, shape: tuple[int, int]) -> torch.Tensor:
    """PSF -> OTF: zero-pad to ``shape``, roll the centre (``size//2``) to the
    origin, 2-D FFT.

    psf: (h, w), (B, h, w) or (B, h, w, 1).  Returns complex64 (..., H, W).
    The trailing singleton is a channel axis on 4-D input only: (B, h, 1) is
    a batch of 1-pixel-wide kernels.
    """
    if psf.ndim == 4 and psf.shape[-1] == 1:
        psf = psf[..., 0]
    h, w = psf.shape[-2:]
    H, W = shape
    otf = torch.nn.functional.pad(psf.float(), (0, W - w, 0, H - h))
    otf = torch.roll(otf, (-(h // 2), -(w // 2)), dims=(-2, -1))
    return torch.fft.fft2(otf, dim=(-2, -1))


def upsample_zeros(x: torch.Tensor, sf: int) -> torch.Tensor:
    """S^T y: zero-filling sf-fold upsampler, NHWC (reference ``upsample``)."""
    if sf == 1:
        return x
    b, h, w, c = x.shape
    z = x.new_zeros((b, h, sf, w, sf, c))
    z[:, :, 0, :, 0, :] = x
    return z.reshape(b, h * sf, w * sf, c)


def downsample_strided(x: torch.Tensor, sf: int) -> torch.Tensor:
    """S x: keep the upper-left pixel of each sf x sf block, NHWC."""
    return x if sf == 1 else x[:, ::sf, ::sf, :]


def alias_block_mean(a: torch.Tensor, sf: int) -> torch.Tensor:
    """Mean over the sf x sf coarse blocks (reference ``splits`` + mean):
    (B, H, W, C) -> (B, H/sf, W/sf, C)."""
    if sf == 1:
        return a
    b, H, W, c = a.shape
    return a.reshape(b, sf, H // sf, sf, W // sf, c).mean(dim=(1, 3))


class ProxOperator(NamedTuple):
    """Per-batch spectra, computed once and reused at every step."""

    FB: torch.Tensor    # (B, H, W, C) complex64: OTF of k at HR size
    FBC: torch.Tensor   # conj(FB)
    F2B: torch.Tensor   # |FB|^2 (real)
    FBFy: torch.Tensor  # FBC * FFT(S^T y)
    sf: int


def precompute(y: torch.Tensor, k: torch.Tensor, sf: int) -> ProxOperator:
    """(FB, FBC, F2B, FBFy) from the LR observation ``y`` (B, h, w, C) in
    [0, 1] and the kernels ``k`` (B, kh, kw) or (B, kh, kw, 1)."""
    y = y.float()
    h, w = y.shape[1:3]
    FB = psf_to_otf(k, (h * sf, w * sf))[:, :, :, None]
    FB = FB.expand(*FB.shape[:3], y.shape[-1])
    FBC = torch.conj_physical(FB)
    F2B = FB.abs() ** 2
    FBFy = FBC * torch.fft.fft2(upsample_zeros(y, sf), dim=(1, 2))
    return ProxOperator(FB=FB, FBC=FBC, F2B=F2B, FBFy=FBFy, sf=sf)


def prox_solve(x0: torch.Tensor, op: ProxOperator, tau) -> torch.Tensor:
    """The minimiser of ||y - SHx||^2 + tau ||x - x0||^2 for x0 (B, H, W, C)
    in [0, 1]; ``tau`` is a float or a (B,) tensor.

    The JAX package's cancellation-free form of the reference's
    distinct-block solve (``diffpir_tpu/ops/fft_prox.py:116-133``): without
    the reference's /tau, whose fp32 rounding grows ~1/tau-fold at the small
    taus of early steps.  At sf = 1 it is (FBFy + tau F0) / (|FB|^2 + tau).
    """
    x0 = x0.float()
    if isinstance(tau, torch.Tensor) and tau.ndim:
        tau = tau.float().reshape(-1, 1, 1, 1)
    sf = op.sf
    F0 = torch.fft.fft2(x0, dim=(1, 2))
    if sf == 1:
        FX = (op.FBFy + tau * F0) / (op.F2B + tau)
        return torch.fft.ifft2(FX, dim=(1, 2)).real
    invW = alias_block_mean(op.F2B, sf)
    FBF0_mean = alias_block_mean(op.FB * F0, sf)
    denom = invW.repeat(1, sf, sf, 1) + tau
    FX = F0 + (op.FBFy - op.FBC * FBF0_mean.repeat(1, sf, sf, 1)) / denom
    return torch.fft.ifft2(FX, dim=(1, 2)).real
