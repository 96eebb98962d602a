"""DiffPIR's restore in plain PyTorch: the reference the benchmark judges by.

Written from the method (Zhu et al., CVPR 2023, Algorithm 1) and its public
code (``main_ddpir.py``, ``utils/utils_sisr.py``), not from the program under
test, whose module it never imports.  The trajectory's arithmetic runs in
float64 (schedule, x0, the data prox in complex128, the renoise); only the
UNet runs in float32 with TF32 off, or in the precision ``Precision`` asks
for.  Every input (observation, PSF, mask, the noise draws) comes from the
benchmark's generator; the plan, the spectra and the initial x are worked
out here again.

Steps (quad skip over 1000 linear-beta steps, t from 999 down):

  x0  = clip(sqrt(1/abar_t) x - sqrt(1/abar_t - 1) eps(x, t), -1, 1)
  x0  = prox(x0, rho_t), rho_t = lambda sigma_y^2 / sigma_bar_t^2
  eps = (x - sqrt(abar_t) x0) / sqrt(1 - abar_t)
  x   = sqrt(abar_prev) x0 + sqrt(1 - zeta) sqrt(1 - abar_prev) eps
        + sqrt(zeta) sqrt(1 - abar_prev) n2            (eta = 0)

over every step but the last; the output is x/2 + 1/2, with the observed
pixels put back for inpainting when ``recover_known`` is set.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

__all__ = ["Schedule", "quad_timesteps", "sigma_to_t", "cubic_up", "psf_to_otf",
           "fft_prox", "inpaint_prox", "restore"]


class Schedule:
    """The linear-beta schedule of the published models, float64."""

    def __init__(self, beta_start: float = 1e-4, beta_end: float = 0.02, T: int = 1000):
        self.T = T
        self.betas = np.linspace(beta_start, beta_end, T, dtype=np.float64)
        self.abar = np.cumprod(1.0 - self.betas)
        # sigma_bar_t, the noise on the image x_t / sqrt(abar_t) carries
        self.sigma_bar = np.sqrt(1.0 - self.abar) / np.sqrt(self.abar)


def sigma_to_t(s: Schedule, sigma: float) -> int:
    """The step whose sigma_bar is nearest ``sigma``, in the float32 table of
    the public code (``main_ddpir.py:190``)."""
    return int(np.abs(s.sigma_bar.astype(np.float32) - sigma).argmin())


def quad_timesteps(T: int, iter_num: int) -> list[int]:
    """Quadratic skip (``main_ddpir.py:330-335``): t_i = T - 1 - floor(sqrt(i T^2/(n-1))),
    the last one moved to 0."""
    seq = [int(v) for v in np.sqrt(np.linspace(0, T ** 2, iter_num))]
    seq[-1] -= 1
    return [T - 1 - v for v in seq]


def _cubic(x: np.ndarray, a: float = -0.75) -> np.ndarray:
    ax = np.abs(x)
    return np.where(ax <= 1, (a + 2) * ax ** 3 - (a + 3) * ax ** 2 + 1,
                    np.where(ax <= 2, a * ax ** 3 - 5 * a * ax ** 2 + 8 * a * ax - 4 * a, 0.0))


def _up_matrix(n: int, sf: int) -> np.ndarray:
    """(n sf, n) bicubic (a = -0.75) upscale along one axis: output pixel i
    samples input coordinate (i + 1/2)/sf - 1/2, the four taps around it,
    indices past an edge mirrored back onto the image (edge pixel repeated)."""
    m = np.zeros((n * sf, n), np.float64)
    for i in range(n * sf):
        u = (i + 0.5) / sf - 0.5
        base = math.floor(u)
        taps = np.arange(base - 1, base + 3)
        w = _cubic(u - taps)
        w = w / w.sum()
        for j, wj in zip(taps, w):
            j = -j - 1 if j < 0 else (2 * n - 1 - j if j >= n else j)
            m[i, j] += wj
    return m


def cubic_up(y: torch.Tensor, sf: int) -> torch.Tensor:
    """Bicubic upscale of (B, h, w, C) by ``sf``, float64."""
    mh = torch.from_numpy(_up_matrix(y.shape[1], sf)).to(y.device)
    mw = torch.from_numpy(_up_matrix(y.shape[2], sf)).to(y.device)
    y = torch.einsum("oh,bhwc->bowc", mh, y.double())
    return torch.einsum("pw,bowc->bopc", mw, y)


def psf_to_otf(k: torch.Tensor, hw: tuple[int, int]) -> torch.Tensor:
    """``p2o``: the (B, kh, kw) PSFs zero-padded to ``hw``, their centres
    (index size // 2) rolled to the origin, 2-D FFT; complex128 (B, H, W)."""
    kh, kw = k.shape[-2:]
    pad = torch.zeros(k.shape[:-2] + tuple(hw), dtype=torch.float64, device=k.device)
    pad[..., :kh, :kw] = k.double()
    pad = torch.roll(pad, (-(kh // 2), -(kw // 2)), dims=(-2, -1))
    return torch.fft.fft2(pad)


def _block_mean(a: torch.Tensor, sf: int) -> torch.Tensor:
    """Mean over the sf x sf blocks of (B, H, W, C): the ``splits`` mean."""
    b, H, W, c = a.shape
    return a.reshape(b, sf, H // sf, sf, W // sf, c).mean(dim=(1, 3))


def fft_prox(y: torch.Tensor, k: torch.Tensor, sf: int) -> Callable:
    """The closed-form solve of argmin_x ||y - (k * x) down_sf||^2 + tau ||x - x0||^2
    (Zhao et al. 2016; ``utils_sisr.data_solution``) for (B, h, w, C) y in
    [0, 1]; returns ``prox(x0, tau)`` over (B, H, W, C) x0 in [0, 1]."""
    b, h, w, c = y.shape
    H, W = h * sf, w * sf
    FB = psf_to_otf(k, (H, W))[..., None]                    # (B, H, W, 1)
    FBC, F2B = FB.conj(), FB.abs() ** 2
    sty = torch.zeros((b, H, W, c), dtype=torch.float64, device=y.device)
    sty[:, ::sf, ::sf] = y.double()
    FBFy = FBC * torch.fft.fft2(sty, dim=(1, 2))
    invW = _block_mean(F2B.expand(b, H, W, c), sf)

    def prox(x0: torch.Tensor, tau: float) -> torch.Tensor:
        FR = FBFy + tau * torch.fft.fft2(x0.double(), dim=(1, 2))
        FBR = _block_mean(FB * FR, sf)
        invWBR = FBR / (invW + tau)
        FX = (FR - FBC * invWBR.repeat(1, sf, sf, 1)) / tau
        return torch.fft.ifft2(FX, dim=(1, 2)).real

    return prox


def inpaint_prox(y: torch.Tensor, mask: torch.Tensor) -> Callable:
    """The masked average (x0 tau + mask y) / (tau + mask) in [-1, 1]."""
    y2, m = 2.0 * y.double() - 1.0, mask.double()
    return lambda x0, tau: (m * y2 + tau * x0) / (m + tau)


def restore(unet: Callable, task: dict, y: torch.Tensor, mask: torch.Tensor,
            kernel: torch.Tensor, noise: Callable) -> torch.Tensor:
    """Restore (B, h, w, C) observations ``y`` in [0, 1]; returns (B, H, W, C)
    float64 in [0, 1].

    ``unet(x (B,C,H,W) float32, t (B,) int64) -> (B, 2C, H, W)``; ``task``:
    ``task`` ("deblur", "sr", "inpaint"), ``sf``, ``nfe``, ``lambda``,
    ``zeta``, ``noise_level_img`` (/255), ``ty_init`` (deblur: y taken as
    x_t at sigma_bar = 2 sigma_y), ``recover_known``; ``noise(i, which,
    shape)`` the draws ("init" at i = -1, then "n1", "n2" each step) with
    ``y``'s batch."""
    if task.get("skip_type", "quad") != "quad" or task.get("eta", 0.0) != 0.0:
        raise ValueError("the reference follows quad-skip trajectories with eta 0 only")
    s = Schedule()
    T = s.T
    sf = task.get("sf", 1)
    sigma_y = max(1e-3, task["noise_level_img"] / 255.0)
    lam, zeta = task["lambda"], task["zeta"]
    b, h, w, c = y.shape
    H, W = h * sf, w * sf
    y = y.double()
    ts = quad_timesteps(T, task["nfe"])
    kind = task["task"]
    if kind == "inpaint":
        prox = inpaint_prox(y, mask)
    else:
        fft = fft_prox(y, kernel, sf)
        prox = lambda x0, tau: 2.0 * fft(x0 * 0.5 + 0.5, tau) - 1.0  # noqa: E731
    x = {"sr": lambda: cubic_up(y, sf), "deblur": lambda: y,
         "inpaint": lambda: y * mask.double()}[kind]()
    n0 = noise(-1, "init", (b, H, W, c)).double()
    sa0, s1m0 = math.sqrt(s.abar[T - 1]), math.sqrt(1.0 - s.abar[T - 1])
    if kind == "deblur" and task.get("ty_init", True):
        t_y = sigma_to_t(s, 2.0 * sigma_y)
        sae = sa0 / math.sqrt(s.abar[t_y])
        coef = math.sqrt(max(s1m0 ** 2 - sae ** 2 * (1.0 - s.abar[t_y]), 0.0))
        x = sae * (2.0 * x - 1.0) + coef * n0
    else:
        x = sa0 * (2.0 * x - 1.0) + s1m0 * n0
    sqz, sq1mz = math.sqrt(zeta), math.sqrt(1.0 - zeta)
    for i in range(len(ts) - 1):
        t, tp = ts[i], ts[i + 1]
        sa_t, s1m_t = math.sqrt(s.abar[t]), math.sqrt(1.0 - s.abar[t])
        sa_p, s1m_p = math.sqrt(s.abar[tp]), math.sqrt(1.0 - s.abar[tp])
        t_vec = torch.full((b,), t, dtype=torch.int64, device=y.device)
        x_in = x.permute(0, 3, 1, 2).float().contiguous()
        eps = unet(x_in, t_vec)[:, :c].permute(0, 2, 3, 1).double()
        x0 = (x / sa_t - math.sqrt(1.0 / s.abar[t] - 1.0) * eps).clamp(-1.0, 1.0)
        x0 = prox(x0, lam * sigma_y ** 2 / s.sigma_bar[t] ** 2)
        eps_hat = (x - sa_t * x0) / s1m_t
        # eta = 0: the draw "n1" is weighted by 0 and not needed
        x = sa_p * x0 + sq1mz * s1m_p * eps_hat + sqz * s1m_p * noise(i, "n2", tuple(x.shape)).double()
    if kind == "inpaint" and task.get("recover_known", False):
        m = mask.double()
        x = m * (2.0 * y - 1.0) + (1.0 - m) * x
    return x * 0.5 + 0.5
