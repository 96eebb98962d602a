"""Boundary-artifact tools for spectral deconvolution, on the host.

A copy of ``diffpir_tpu/ops/boundary.py`` (numpy and ``scipy.fftpack``
only), after the reference's ``utils/utils_deblur.py``:

  * ``psf2otf`` / ``otf2psf``      (``utils_deblur.py:123-200``); the device
    path is ``ops.fft_prox.psf_to_otf``
  * ``zero_pad``                   (``:203-242``)
  * ``opt_fft_size``               (``:250-297``; Cho's 2/3/5/7(*11,13)-smooth
    FFT length table)
  * ``wrap_boundary_liu``          (``:300-379``; Liu and Jia, ICIP 2008: extend
    an image to a target FFT size with a smooth periodic boundary by solving
    a minimal-Laplacian membrane with DSTs)
  * ``solve_min_laplacian``        (``:382-438``)

They prepare non-periodic images for the circular-convolution model the FFT
prox assumes.  Nothing in either package calls them on its main path.
"""

from __future__ import annotations

import numpy as np
from scipy import fftpack

__all__ = ["psf2otf", "otf2psf", "zero_pad", "opt_fft_size",
           "wrap_boundary_liu", "solve_min_laplacian"]


def zero_pad(image: np.ndarray, shape, position: str = "corner") -> np.ndarray:
    """Zero-extend a 2-D array to `shape` (top-left or centered)."""
    shape = np.asarray(shape, int)
    imshape = np.asarray(image.shape, int)
    if (imshape == shape).all():
        return image
    if (shape <= 0).any():
        raise ValueError("zero_pad: null or negative shape")
    dshape = shape - imshape
    if (dshape < 0).any():
        raise ValueError("zero_pad: target smaller than source")
    if position == "center":
        if (dshape % 2 != 0).any():
            raise ValueError("zero_pad: parity mismatch for centered padding")
        off = dshape // 2
    else:
        off = np.zeros(2, int)
    out = np.zeros(shape, image.dtype)
    out[off[0]:off[0] + imshape[0], off[1]:off[1] + imshape[1]] = image
    return out


def psf2otf(psf: np.ndarray, shape=None) -> np.ndarray:
    """PSF -> OTF with center-to-origin circular shift (MATLAB psf2otf)."""
    if shape is None:
        shape = psf.shape
    if np.all(psf == 0):
        return np.zeros(shape)
    if psf.ndim == 1:
        psf = psf.reshape(1, -1)
    inshape = psf.shape
    psf = zero_pad(psf, shape, position="corner")
    for axis, axis_size in enumerate(inshape):
        psf = np.roll(psf, -int(axis_size / 2), axis=axis)
    otf = np.fft.fft2(psf, axes=(0, 1))
    n_ops = np.sum(psf.size * np.log2(psf.shape))
    return np.real_if_close(otf, tol=n_ops)


def otf2psf(otf: np.ndarray, outsize=None) -> np.ndarray:
    """Exact inverse of ``psf2otf``: ifft, shift origin back to the PSF center,
    crop to `outsize`.

    Note: the reference's translation (``utils_deblur.py:123-150``) rolls by
    floor(otf_size/2) and center-crops, which does NOT invert its own psf2otf
    for padded shapes; MATLAB's convention (rolled by floor(outsize/2),
    corner crop) does, and is what this implements.
    """
    insize = np.array(otf.shape)
    psf = np.fft.ifftn(otf, axes=(0, 1))
    if outsize is not None:
        outsize = np.asarray(outsize, int)
        if (outsize > insize).any():
            raise ValueError("otf2psf: outsize must be <= otf size")
        for axis, axis_size in enumerate(outsize):
            psf = np.roll(psf, int(axis_size / 2), axis=axis)
        psf = psf[:outsize[0], :outsize[1]]
    else:
        for axis, axis_size in enumerate(insize):
            psf = np.roll(psf, int(np.floor(axis_size / 2)), axis=axis)
    n_ops = np.sum(otf.size * np.log2(otf.shape))
    return np.real_if_close(psf, tol=n_ops)


def opt_fft_size(n) -> np.ndarray:
    """Smallest 2^a*3^b*5^c*7^d(*11|13) FFT-friendly length >= each n (Cho)."""
    LUT_size = 2048
    lut = np.zeros(LUT_size)
    e2 = 1
    while e2 <= LUT_size:
        e3 = e2
        while e3 <= LUT_size:
            e5 = e3
            while e5 <= LUT_size:
                e7 = e5
                while e7 <= LUT_size:
                    lut[e7 - 1] = e7
                    if e7 * 11 <= LUT_size:
                        lut[e7 * 11 - 1] = e7 * 11
                    if e7 * 13 <= LUT_size:
                        lut[e7 * 13 - 1] = e7 * 13
                    e7 *= 7
                e5 *= 5
            e3 *= 3
        e2 *= 2
    nn = 0
    for i in range(LUT_size, 0, -1):
        if lut[i - 1] != 0:
            nn = i - 1
        else:
            lut[i - 1] = nn + 1
    return np.array([lut[v - 1] if v <= LUT_size else -1 for v in np.atleast_1d(n)])


def solve_min_laplacian(boundary_image: np.ndarray) -> np.ndarray:
    """Fill the interior with the minimal-Laplacian membrane given boundary
    values (DST-diagonalized Poisson solve)."""
    H, W = boundary_image.shape
    bi = boundary_image.copy()
    bi[1:-1, 1:-1] = 0
    j = np.arange(1, H - 1)
    k = np.arange(1, W - 1)
    f_bp = np.zeros((H, W))
    f_bp[np.ix_(j, k)] = (-4 * bi[np.ix_(j, k)] + bi[np.ix_(j, k + 1)]
                          + bi[np.ix_(j, k - 1)] + bi[np.ix_(j - 1, k)]
                          + bi[np.ix_(j + 1, k)])
    f2 = (-f_bp)[1:-1, 1:-1]

    # DST solve — the branch structure mirrors the reference's MATLAB
    # translation exactly (utils_deblur.py:403-432): degenerate single-row /
    # single-column interiors (H==3 or W==3) switch the transform axis and
    # normalization, and diverge measurably if folded into the general case
    if f2.shape[1] == 1:
        tt = fftpack.dst(f2, type=1, axis=0) / 2
    else:
        tt = fftpack.dst(f2, type=1) / 2
    if tt.shape[0] == 1:
        f2sin = (fftpack.dst(tt.T, type=1, axis=0) / 2).T
    else:
        f2sin = (fftpack.dst(tt.T, type=1) / 2).T

    x, y = np.meshgrid(np.arange(1, W - 1), np.arange(1, H - 1))
    denom = (2 * np.cos(np.pi * x / (W - 1)) - 2) + (2 * np.cos(np.pi * y / (H - 1)) - 2)
    f3 = f2sin / denom

    if f3.shape[0] == 1:
        tt = fftpack.idst(f3 * 2, type=1, axis=1) / (2 * (f3.shape[1] + 1))
    else:
        tt = fftpack.idst(f3 * 2, type=1, axis=0) / (2 * (f3.shape[0] + 1))
    if tt.shape[1] == 1:
        img_tt = (fftpack.idst(tt.T * 2, type=1) / (2 * (tt.shape[0] + 1))).T
    else:
        img_tt = (fftpack.idst(tt.T * 2, type=1, axis=0) / (2 * (tt.shape[1] + 1))).T

    out = bi
    out[1:-1, 1:-1] = img_tt
    return out


def _wrap_boundary_2d(img: np.ndarray, img_size) -> np.ndarray:
    H, W = img.shape
    H_w = int(img_size[0]) - H
    W_w = int(img_size[1]) - W

    # vertical strip A: interpolate between bottom and top rows, then membrane
    r_A = np.zeros((2 + H_w, W))
    r_A[0, :] = img[-1, :]
    r_A[-1, :] = img[0, :]
    a = np.arange(H_w) / (H_w - 1)
    r_A[1:-1, 0] = (1 - a) * r_A[0, 0] + a * r_A[-1, 0]
    r_A[1:-1, -1] = (1 - a) * r_A[0, -1] + a * r_A[-1, -1]

    r_B = np.zeros((H, 2 + W_w))
    r_B[:, 0] = img[:, -1]
    r_B[:, -1] = img[:, 0]
    a = np.arange(W_w) / (W_w - 1)
    r_B[0, 1:-1] = (1 - a) * r_B[0, 0] + a * r_B[0, -1]
    r_B[-1, 1:-1] = (1 - a) * r_B[-1, 0] + a * r_B[-1, -1]

    r_A = solve_min_laplacian(r_A)
    r_B = solve_min_laplacian(r_B)
    A, B = r_A, r_B

    r_C = np.zeros((2 + H_w, 2 + W_w))
    r_C[0, :] = B[-1, :]
    r_C[-1, :] = B[0, :]
    r_C[:, 0] = A[:, -1]
    r_C[:, -1] = A[:, 0]
    C = solve_min_laplacian(r_C)

    A = A[:-2, :]
    B = B[:, 1:-1]
    C = C[1:-1, 1:-1]
    return np.vstack((np.hstack((img, B)), np.hstack((A, C))))


def wrap_boundary_liu(img: np.ndarray, img_size) -> np.ndarray:
    """Extend `img` to `img_size` with a smooth periodic boundary (Liu-Jia)."""
    if img.ndim == 2:
        return _wrap_boundary_2d(img, img_size)
    return np.stack([_wrap_boundary_2d(img[:, :, i], img_size)
                     for i in range(img.shape[2])], axis=2)
