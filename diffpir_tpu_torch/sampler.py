"""The sampling trajectories, as Python loops of steps.

Port of ``diffpir_tpu/sampler.py``: ``make_denoiser``/``denoise_x0`` and
``denoise_output`` (``:53-110``), the data proxes ``make_inpaint_prox``,
``make_fft_prox`` and ``make_cubic_sr_prox`` (``:117-167``), ``init_x``
(``:174-213``), ``xprev_sample`` (``:220-270``) and ``diffpir_sample``
(``:287-421``); reference loop ``main_ddpir.py:341-467``.
DiffPIR step: one UNet denoise estimating x0 from x_t, the task's data prox,
then the DDIM-like renoise to x_{t-1} controlled by (eta, zeta); repaint
re-injects the forward-diffused known pixels before the denoise and runs no
prox, vanilla runs no prox, and ``iter_num_U > 1`` sets x_{t-1} back to x_t
between inner repeats.  The JAX package runs the steps in one ``lax.scan``;
here they are a Python loop that reads its per-step scalars from the
host-side plan, so it never waits for the device.  The reference's final
denoise is skipped as there: its result is never used.

Noise.  By default every draw comes from a ``torch.Generator`` on the
sampler's device.  A caller may instead pass ``noise(i, u, which, shape)``,
which returns the draw for step ``i``, inner repeat ``u`` and ``which``:
"n1" and "n2" (the eta and zeta noises of the renoise), "n3" (the set-back
of ``iter_num_U > 1``), "rp" (repaint's noised known pixels) and "xprev"
(the ancestral or DDIM step of ``xprev_sample``); ``guidance.dps_sample``
adds "samp" and "yt".  ``init_x`` takes its initial noise as an argument.
Tests use these to feed the JAX package's draws to both packages.
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

__all__ = ["Denoiser", "make_denoiser", "model_fn", "denoise_x0", "denoise_output",
           "make_inpaint_prox", "make_fft_prox", "make_cubic_sr_prox", "init_x",
           "generator_noise", "per_sample", "StepTables", "step_tables", "diffpir_step",
           "diffpir_sample", "xprev_tables", "xprev_step", "xprev_sample"]

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


def model_fn(den: Denoiser) -> Callable:
    """``model_fn(x, t_vec)`` for ``diffusion.Diffusion``: the UNet on x cast
    to the compute type (differentiable; the caller chooses the grad mode)."""
    return lambda x, t: den.model(x.to(den.compute_dtype), t)


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


def denoise_output(den: Denoiser, x: torch.Tensor, t: int,
                   output_type: str = "pred_xstart") -> torch.Tensor:
    """Denoiser output in the reference ``model_fn`` vocabulary
    (``utils/utils_model.py:242-258``): pred_xstart | epsilon | score,
    epsilon and score re-derived from the clamped x0 as the reference does."""
    x0 = denoise_x0(den, x, t)
    if output_type == "pred_xstart":
        return x0
    sqrt_acp = np.float32(1.0) / den.sqrt_recip_acp[t]
    sqrt_1m = den.sqrt_recipm1_acp[t] / den.sqrt_recip_acp[t]
    eps = (x - float(sqrt_acp) * x0) / float(sqrt_1m)
    if output_type == "epsilon":
        return eps
    if output_type == "score":
        return -eps / float(sqrt_1m)
    raise ValueError(f"unknown output_type {output_type!r}")


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


def per_sample(v, like: torch.Tensor):
    """A (B,) operating point as a (B, 1, 1, 1) fp32 tensor on ``like``'s
    device; a scalar (or None) stays as it is."""
    if v is None or np.ndim(v) == 0:
        return v
    return torch.as_tensor(v, dtype=torch.float32, device=like.device).reshape(-1, 1, 1, 1)


STEP_COLUMNS = ("sqrt_acp_t", "sqrt_1m_acp_t", "sqrt_acp_prev", "sqrt_1m_acp_prev",
                "eta_sigma", "dir_coef", "rho", "sae", "setback_sd", "c1", "c2")
STEP_FLAGS = ("prox", "renoise", "setback")


@dataclasses.dataclass(frozen=True)
class StepTables:
    """One row per (step i, inner repeat u) of a DiffPIR trajectory, in the
    order the loop runs them: the scalars ``diffpir_step`` reads
    (``STEP_COLUMNS``: the plan's schedule values, the renoise's direction
    coefficient, rho, the set-back's factor and noise scale, and the
    denoiser's x0 coefficients at t_i), its ``torch.where`` selectors
    (``STEP_FLAGS``) and t_i.  Every value is the float32 the loop used to
    compute per step from the plan."""

    coef: np.ndarray      # (R, len(STEP_COLUMNS)) float32
    flags: np.ndarray     # (R, len(STEP_FLAGS)) bool
    t: np.ndarray         # (R,) int32
    step: np.ndarray      # (R,) int32, i of each row
    repeat: np.ndarray    # (R,) int32, u of each row


def step_tables(den: Denoiser, plan: TrajectoryPlan, iter_num_U: int = 1) -> StepTables:
    """The rows of steps 0..n-2, ``iter_num_U`` rows each."""
    f32 = np.float32
    coef, flags, ts, steps, repeats = [], [], [], [], []
    for i in range(plan.n_steps - 1):
        sa_t, s1m_t = f32(plan.sqrt_acp_t[i]), f32(plan.sqrt_1m_acp_t[i])
        sa_p, s1m_p = f32(plan.sqrt_acp_prev[i]), f32(plan.sqrt_1m_acp_prev[i])
        eta_sigma = f32(plan.eta_sigma[i])
        dir_coef = math.sqrt(max(s1m_p ** 2 - eta_sigma ** 2, 0.0))
        sae = sa_t / sa_p
        var = s1m_t ** 2 - sae ** 2 * s1m_p ** 2
        t = int(plan.t[i])
        renoise = bool(plan.renoise[i])
        for u in range(iter_num_U):
            last_u = u == iter_num_U - 1
            coef.append((sa_t, s1m_t, sa_p, s1m_p, eta_sigma, dir_coef, plan.rho[i], sae,
                         np.sqrt(max(var, 0.0)), den.sqrt_recip_acp[t],
                         den.sqrt_recipm1_acp[t]))
            flags.append((bool(plan.prox[i]), renoise or not last_u,
                          renoise and not last_u))
            ts.append(t)
            steps.append(i)
            repeats.append(u)
    k = len(STEP_COLUMNS)
    return StepTables(coef=np.asarray(coef, np.float32).reshape(-1, k),
                      flags=np.asarray(flags, bool).reshape(-1, len(STEP_FLAGS)),
                      t=np.asarray(ts, np.int32), step=np.asarray(steps, np.int32),
                      repeat=np.asarray(repeats, np.int32))


def diffpir_step(den: Denoiser, prox_fn: Optional[Callable], x: torch.Tensor,
                 coef: torch.Tensor, flags: torch.Tensor, t: torch.Tensor,
                 n1: torch.Tensor, n2: torch.Tensor, *, sqrt_zeta, sqrt_1m_zeta,
                 lam_b: Optional[torch.Tensor] = None,
                 rp: Optional[torch.Tensor] = None, n3: Optional[torch.Tensor] = None,
                 y2: Optional[torch.Tensor] = None,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One (step, inner repeat) of ``diffpir_sample``: repaint's injection
    of the noised known pixels (where ``rp`` is given), the denoise to a
    clamped x0, the prox (where ``prox_fn`` is given; rho scaled by
    ``lam_b``), and the DDIM-like renoise, then the set-back to x_t before
    the next inner repeat (where ``n3`` is given).  Every per-step value is a
    tensor: ``coef`` and ``flags`` a row of ``StepTables`` (the flags select
    with ``torch.where``), ``t`` the 0-d timestep; so one traced program
    serves every step (``export.py``)."""
    (sa_t, s1m_t, sa_p, s1m_p, eta_sigma, dir_coef, rho, sae, setback_sd, c1,
     c2) = coef.unbind(0)
    do_prox, do_renoise, do_setback = flags.unbind(0)
    if rp is not None:
        noised_known = sa_t * y2 + s1m_t * rp
        x = noised_known * mask + (1.0 - mask) * x
    out = den.model(x.to(den.compute_dtype), t.expand(x.shape[0]))
    eps = out[..., : x.shape[-1]].float()
    x0 = (c1 * x - c2 * eps).clamp(-1.0, 1.0)
    if prox_fn is not None:
        tau = rho if lam_b is None else rho * lam_b
        x0 = torch.where(do_prox, prox_fn(x0, tau), x0)
    eps_hat = (x - sa_t * x0) / s1m_t
    renoised = (sa_p * x0 + sqrt_1m_zeta * (dir_coef * eps_hat + eta_sigma * n1)
                + sqrt_zeta * s1m_p * n2)
    x = torch.where(do_renoise, renoised, x)
    if n3 is not None:
        # set x_{t-1} back to x_t for the next inner repeat (main_ddpir.py:462-467)
        x = torch.where(do_setback, sae * x + setback_sd * n3, x)
    return x


def diffpir_sample(den: Denoiser, prox_fn: Optional[Callable],
                   plan: TrajectoryPlan, x_init: torch.Tensor, *,
                   noise: NoiseFn, zeta=0.25, iter_num_U: int = 1,
                   generate_mode: str = "DiffPIR",
                   y: Optional[torch.Tensor] = None,
                   mask: Optional[torch.Tensor] = None,
                   recover_known: bool = False,
                   progress_slots: Optional[np.ndarray] = None,
                   lam_scale=None):
    """Run the DiffPIR trajectory; returns the restored image in [0, 1].

    Steps 0..n-2 each do ``iter_num_U`` times (repaint injection) -> denoise
    -> (prox, DiffPIR mode only) -> renoise (``diffpir_step``, one row of
    ``step_tables`` each); at the last inner repeat the renoise is skipped
    on rows whose ``plan.renoise`` is False (duplicate-of-last quad rows),
    and so is the set-back before the other repeats.  ``zeta`` and
    ``lam_scale`` (which scales the plan's rho) are floats or per-sample (B,)
    values.  ``recover_known`` overwrites the observed pixels at the end
    (``main_ddpir.py:475-476``).  With ``progress_slots`` (length n_steps,
    slot index or -1) it returns ``(x01, frames)``: frames (n_slots, B, H,
    W, C) in [0, 1], the slot of the skipped final step holding the final
    state.
    """
    use_prox = generate_mode == "DiffPIR" and prox_fn is not None
    repaint = generate_mode == "repaint"
    dev = x_init.device
    tables = step_tables(den, plan, iter_num_U)
    coef = torch.from_numpy(tables.coef).to(dev)
    flags = torch.from_numpy(tables.flags).to(dev)
    ts = torch.from_numpy(tables.t).to(dev)
    if np.ndim(zeta):
        zeta_b = per_sample(zeta, x_init)
        sqrt_zeta, sqrt_1m_zeta = torch.sqrt(zeta_b), torch.sqrt(1.0 - zeta_b)
    else:
        z = np.float32(zeta)
        sqrt_zeta = torch.tensor(np.sqrt(z), device=dev)
        sqrt_1m_zeta = torch.tensor(np.sqrt(np.float32(1.0) - z), device=dev)
    lam_b = per_sample(lam_scale, x_init)
    y2 = None if y is None else (2.0 * y - 1.0).float()
    frames = None
    if progress_slots is not None:
        frames = torch.zeros((int(progress_slots.max()) + 1,) + tuple(x_init.shape),
                             dtype=torch.float32, device=dev)
    x = x_init.float()
    shape = tuple(x.shape)
    no_setback = torch.zeros(shape, dtype=torch.float32, device=dev) if iter_num_U > 1 else None
    for k in range(len(tables.t)):
        i, u = int(tables.step[k]), int(tables.repeat[k])
        rp = noise(i, u, "rp", shape) if repaint else None
        n1 = noise(i, u, "n1", shape)
        n2 = noise(i, u, "n2", shape)
        n3 = no_setback
        if tables.flags[k, 2]:
            n3 = noise(i, u, "n3", shape)
        with torch.no_grad():
            x = diffpir_step(den, prox_fn if use_prox else None, x, coef[k], flags[k], ts[k],
                             n1, n2, sqrt_zeta=sqrt_zeta, sqrt_1m_zeta=sqrt_1m_zeta,
                             lam_b=lam_b, rp=rp, n3=n3, y2=y2, mask=mask)
        if frames is not None and u == iter_num_U - 1 and progress_slots[i] >= 0:
            frames[int(progress_slots[i])] = x * 0.5 + 0.5
    if recover_known and mask is not None:
        x = mask * y2 + (1.0 - mask) * x
    x01 = x * 0.5 + 0.5
    if frames is None:
        return x01
    if progress_slots[plan.n_steps - 1] >= 0:
        frames[int(progress_slots[plan.n_steps - 1])] = x01
    return x01, frames


XPREV_COLUMNS = ("rho",)
XPREV_FLAGS = ("prox",)


def xprev_tables(plan: TrajectoryPlan) -> StepTables:
    """One row per step of ``xprev_sample`` (every step of the plan): rho
    (``XPREV_COLUMNS``) and whether the masked average follows the step
    (``XPREV_FLAGS``: ``plan.prox``, never at the last step)."""
    n = plan.n_steps
    return StepTables(
        coef=np.asarray(plan.rho, np.float32).reshape(n, 1),
        flags=np.asarray([bool(plan.prox[i]) and i < n - 1 for i in range(n)],
                         bool).reshape(n, 1),
        t=np.asarray(plan.t, np.int32), step=np.arange(n, dtype=np.int32),
        repeat=np.zeros(n, np.int32))


def xprev_step(diffusion, model: Callable, x: torch.Tensor, coef: torch.Tensor,
               flags: torch.Tensor, t: torch.Tensor, draw: torch.Tensor, *,
               ddim: bool, y2: Optional[torch.Tensor] = None,
               mask: Optional[torch.Tensor] = None,
               lam_b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One step of ``xprev_sample`` from a row of ``xprev_tables``: the
    ancestral (or DDIM) step at the 0-d timestep ``t`` with its draw, then,
    where ``mask`` is given and the row's flag holds, the masked average
    with tau = rho (times ``lam_b``); every per-step value a tensor, so one
    traced program serves every step (``export.py``)."""
    step = diffusion.ddim_sample if ddim else diffusion.p_sample
    x = step(model, x, t.expand(x.shape[0]), draw)["sample"]
    if mask is not None:
        (rho,) = coef.unbind(0)
        tau = rho if lam_b is None else rho * lam_b
        x = torch.where(flags[0], (mask * y2 + tau * x) / (mask + tau), x)
    return x


def xprev_sample(diffusion, model: Callable, plan: TrajectoryPlan,
                 x_init: torch.Tensor, *, noise: NoiseFn, ddim: bool = False,
                 y: Optional[torch.Tensor] = None,
                 mask: Optional[torch.Tensor] = None,
                 recover_known: bool = True, lam_scale=None) -> torch.Tensor:
    """``model_output_type='pred_x_prev'`` trajectories; returns [0, 1].

    Each step takes one ancestral (or DDIM) step of the base chain at t_i
    (``main_ddpir.py:365-366, 414-419``); for inpainting the masked-average
    prox is then applied to the sampled x on rows where ``plan.prox`` holds,
    except the last (``xprev_step``, one row of ``xprev_tables`` each).
    There is no DiffPIR renoise, and the final step's model call is used.
    Deblur and SR pass ``mask=None``: the reference applies no data term in
    this mode.  Build the plan with ``rho_mode='xprev'``.  ``model`` is
    ``model_fn(den)``.
    """
    y2 = None if y is None else (2.0 * y - 1.0).float()
    lam_b = per_sample(lam_scale, x_init)
    dev = x_init.device
    tables = xprev_tables(plan)
    coef = torch.from_numpy(tables.coef).to(dev)
    flags = torch.from_numpy(tables.flags).to(dev)
    ts = torch.from_numpy(tables.t).to(dev)
    x = x_init.float()
    with torch.no_grad():
        for i in range(plan.n_steps):
            x = xprev_step(diffusion, model, x, coef[i], flags[i], ts[i],
                           noise(i, 0, "xprev", tuple(x.shape)), ddim=ddim, y2=y2,
                           mask=mask, lam_b=lam_b)
    if recover_known and mask is not None:
        x = mask * y2 + (1.0 - mask) * x
    return x * 0.5 + 0.5
