"""The DiffPIR sampling trajectory, as a Python loop of steps.

Port of the DiffPIR-mode path of ``diffpir_tpu/sampler.py``
(``make_denoiser``/``denoise_x0`` at ``:53-89``, the data proxes
``make_inpaint_prox``, ``make_fft_prox`` and ``make_cubic_sr_prox`` at
``:117-167``, ``init_x`` at ``:174-213`` and ``diffpir_sample`` at
``:287-421``; reference loop ``main_ddpir.py:341-467``).
Per step: one UNet denoise estimating x0 from x_t, the task's data prox,
then the DDIM-like renoise to x_{t-1} controlled by (eta, zeta).  The JAX
package runs steps 0..n-2 in one ``lax.scan``; here they are a Python loop
that reads its per-step scalars from the host-side plan, so it never waits
for the device.  The reference's final denoise is skipped as there: its
result is never used.

Noise.  By default every draw comes from a ``torch.Generator`` on the
sampler's device.  A caller may instead pass ``noise(i, u, which, shape)``,
which returns the draw for step ``i``, inner repeat ``u`` and ``which`` in
{"n1", "n2"} (the eta and zeta noises); ``init_x`` takes its initial noise as
an argument.  Tests use these to feed the JAX package's draws to both
packages.  Other trajectory modes (repaint, vanilla, iter_num_U > 1, progress
snapshots) are not ported yet.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np
import torch

from diffpir_tpu_torch.ops.fft_prox import ProxOperator, prox_solve
from diffpir_tpu_torch.ops.resize import Resizer2D
from diffpir_tpu_torch.schedule import NoiseSchedule, TrajectoryPlan

__all__ = ["Denoiser", "make_denoiser", "denoise_x0", "make_inpaint_prox",
           "make_fft_prox", "make_cubic_sr_prox", "init_x", "generator_noise",
           "diffpir_sample"]

NoiseFn = Callable[[int, int, str, tuple], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Denoiser:
    """A UNet and the schedule tables for x0-prediction."""

    model: Callable                    # (x (B,H,W,C), t (B,)) -> (B,H,W,out)
    sqrt_recip_acp: np.ndarray         # (T,) float32
    sqrt_recipm1_acp: np.ndarray       # (T,) float32
    compute_dtype: torch.dtype = torch.float32


def make_denoiser(model: Callable, schedule: NoiseSchedule, *,
                  compute_dtype: torch.dtype = torch.float32) -> Denoiser:
    return Denoiser(
        model=model,
        sqrt_recip_acp=schedule.sqrt_recip_alphas_cumprod.astype(np.float32),
        sqrt_recipm1_acp=schedule.sqrt_recipm1_alphas_cumprod.astype(np.float32),
        compute_dtype=compute_dtype)


def denoise_x0(den: Denoiser, x: torch.Tensor, t: int) -> torch.Tensor:
    """x0_hat = clip(sqrt(1/acp_t) x - sqrt(1/acp_t - 1) eps_theta(x, t), -1, 1).

    The epsilon head is the first C output channels; x0 is clamped before
    any later step uses it (reference ``gaussian_diffusion.py:293-311``).
    """
    t_vec = torch.full((x.shape[0],), int(t), dtype=torch.int32, device=x.device)
    with torch.no_grad():
        out = den.model(x.to(den.compute_dtype), t_vec)
    eps = out[..., : x.shape[-1]].float()
    x0 = float(den.sqrt_recip_acp[t]) * x - float(den.sqrt_recipm1_acp[t]) * eps
    return x0.clamp(-1.0, 1.0)


def make_inpaint_prox(y: torch.Tensor, mask: torch.Tensor,
                      guidance_scale: float = 1.0) -> Callable:
    """Masked-average prox (reference ``main_ddpir.py:393-394``).

    y in [0,1], mask in {0,1} broadcastable to y.
    """
    y2 = (2.0 * y - 1.0).float()
    mask = mask.float()

    def prox(x0: torch.Tensor, tau: float) -> torch.Tensor:
        x0_p = (mask * y2 + tau * x0) / (mask + tau)
        return x0 + guidance_scale * (x0_p - x0)

    return prox


def make_fft_prox(op: ProxOperator, guidance_scale: float = 1.0) -> Callable:
    """FFT closed-form prox for deblur and blur/classical SR
    (``main_ddpir.py:395-400``)."""

    def prox(x0: torch.Tensor, tau: float) -> torch.Tensor:
        x0_p = prox_solve(x0 * 0.5 + 0.5, op, tau)
        x0_p = x0_p * 2.0 - 1.0
        return x0 + guidance_scale * (x0_p - x0)

    return prox


def make_cubic_sr_prox(y: torch.Tensor, sf: int, *, gamma: float = 0.01,
                       in_iter: int = 1, hr_hw: tuple[int, int]) -> Callable:
    """Iterative back-projection prox for cubic SR (``main_ddpir.py:401-406``):
    down is the antialiased MATLAB-cubic 1/sf resize (reference ``Resizer``),
    up is nearest x sf (``F.interpolate``'s default mode)."""
    down = Resizer2D(hr_hw, 1.0 / sf)
    y = y.float()

    def up_nearest(v: torch.Tensor) -> torch.Tensor:
        return v.repeat_interleave(sf, dim=1).repeat_interleave(sf, dim=2)

    def prox(x0: torch.Tensor, tau: float) -> torch.Tensor:
        for _ in range(in_iter):
            x01 = x0 * 0.5 + 0.5
            x01 = x01 + gamma * up_nearest(y - down(x01)) / (1.0 + tau)
            x0 = x01 * 2.0 - 1.0
        return x0

    return prox


def init_x(task: str, y: torch.Tensor, mask: Optional[torch.Tensor], sf: int,
           noise: torch.Tensor, *, sqrt_acp_start: float, sqrt_1m_acp_start: float,
           ty: Optional[tuple[float, float]] = None) -> torch.Tensor:
    """x_{t_start} (reference ``main_ddpir.py:293-316``): the bicubic
    ``cubic_torch`` upscale of y for sr, y for deblur, y*mask for inpaint,
    diffused to t_start with ``noise`` (of the high-resolution shape).

    ty: optional ``(sqrt_acp[t_y], sqrt_1m_acp[t_y])``; y is then taken as
    already sitting at step t_y and diffused the rest of the way with the
    effective alpha sae = sqrt_acp[t_start] / sqrt_acp[t_y]
    (``main_ddpir_deblur.py:227-231``).
    """
    if task == "sr":
        # torch's F.interpolate bicubic (a = -0.75, main_ddpir.py:295)
        x = Resizer2D((y.shape[1], y.shape[2]), float(sf), kernel="cubic_torch",
                      antialiasing=False)(y)
    elif task == "deblur":
        x = y
    elif task == "inpaint":
        x = y * mask
    else:
        raise ValueError(task)
    x = x.float()
    if ty is not None:
        sqrt_acp_ty, sqrt_1m_acp_ty = ty
        sae = sqrt_acp_start / sqrt_acp_ty
        coef = float(np.sqrt(max(
            sqrt_1m_acp_start**2 - sae**2 * sqrt_1m_acp_ty**2, 0.0)))
        return sae * (2.0 * x - 1.0) + coef * noise
    return sqrt_acp_start * (2.0 * x - 1.0) + sqrt_1m_acp_start * noise


def generator_noise(gen: torch.Generator, device: torch.device) -> NoiseFn:
    """The default noise source: standard normals from ``gen`` on ``device``."""

    def noise(i: int, u: int, which: str, shape: tuple) -> torch.Tensor:
        return torch.randn(shape, generator=gen, device=device, dtype=torch.float32)

    return noise


def diffpir_sample(den: Denoiser, prox_fn: Optional[Callable],
                   plan: TrajectoryPlan, x_init: torch.Tensor, *,
                   noise: NoiseFn, zeta: float = 0.25,
                   y: Optional[torch.Tensor] = None,
                   mask: Optional[torch.Tensor] = None,
                   recover_known: bool = False) -> torch.Tensor:
    """Run the DiffPIR trajectory; returns the restored image in [0, 1].

    Steps 0..n-2 each do denoise -> (prox) -> renoise; the renoise is skipped
    on rows whose ``plan.renoise`` is False (duplicate-of-last quad rows).
    ``recover_known`` overwrites the observed pixels at the end
    (``main_ddpir.py:475-476``).
    """
    zeta32 = np.float32(zeta)
    sqrt_zeta = float(np.sqrt(zeta32))
    sqrt_1m_zeta = float(np.sqrt(np.float32(1.0) - zeta32))
    x = x_init.float()
    for i in range(plan.n_steps - 1):
        sa_t, s1m_t = float(plan.sqrt_acp_t[i]), float(plan.sqrt_1m_acp_t[i])
        sa_p, s1m_p = float(plan.sqrt_acp_prev[i]), float(plan.sqrt_1m_acp_prev[i])
        eta_sigma = float(plan.eta_sigma[i])
        x0 = denoise_x0(den, x, int(plan.t[i]))
        if prox_fn is not None and plan.prox[i]:
            x0 = prox_fn(x0, float(plan.rho[i]))
        eps_hat = (x - sa_t * x0) / s1m_t
        n1 = noise(i, 0, "n1", tuple(x.shape))
        n2 = noise(i, 0, "n2", tuple(x.shape))
        dir_coef = math.sqrt(max(np.float32(s1m_p) ** 2 - np.float32(eta_sigma) ** 2, 0.0))
        if plan.renoise[i]:
            x = (sa_p * x0 + sqrt_1m_zeta * (dir_coef * eps_hat + eta_sigma * n1)
                 + sqrt_zeta * s1m_p * n2)
    if recover_known and mask is not None:
        y2 = (2.0 * y - 1.0).float()
        x = mask * y2 + (1.0 - mask) * x
    return x * 0.5 + 0.5
