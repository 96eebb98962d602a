"""Gradient-based guidance: DPS and the first-order data-fidelity prox.

Port of ``diffpir_tpu/guidance.py`` (reference ``main_ddpir.py:293-310,
420-445``, ``utils/utils_model.py:390-394``):

  * ``frobenius_residual``: the Frobenius norm of the residual over the
    WHOLE batch tensor, one scalar coupling all batch elements, as the
    reference's ``grad_and_value``;
  * ``make_grad_prox`` (``sub_1_analytic: false``): x0 <- x0 - grad * ||r|| /
    rho, the gradient taken with respect to x0 itself;
  * ``dps_sample``: DPS_y0 differentiates ||y - H(x0(x))|| THROUGH the
    denoiser with respect to x_t; DPS_yt differentiates ||y_t - H(x_prev)||
    with respect to x_prev for a freshly diffused y_t, with no gradient
    through the model.

Degradation operators H (``main_ddpir.py:293-310``): deblur blurs x/2+0.5
with ``ops.degrade.blur_reflect`` (compare with y in [0, 1]); SR is the
MATLAB-cubic 1/sf downscale in [-1, 1] (compare with 2y-1).  Gradients come
from ``torch.autograd``: each step builds its graph from a detached input
and drops it after ``torch.autograd.grad``, so no graph outlives its step.
The UNet's parameters do not require gradients (``models.zoo``), so the
graph holds activations only.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from diffpir_tpu_torch.diffusion import Diffusion
from diffpir_tpu_torch.ops.degrade import blur_reflect
from diffpir_tpu_torch.ops.resize import Resizer2D
from diffpir_tpu_torch.sampler import NoiseFn, StepTables, per_sample
from diffpir_tpu_torch.schedule import TrajectoryPlan

__all__ = ["make_degrade_op", "frobenius_residual", "make_grad_prox", "dps_tables",
           "dps_y0_step", "dps_yt_step", "dps_sample", "DPS_COLUMNS"]


def make_degrade_op(task: str, *, kernel: Optional[torch.Tensor] = None,
                    hr_hw: Optional[tuple[int, int]] = None,
                    sf: int = 1) -> Callable:
    """H for gradient guidance: deblur maps x in [-1, 1] to blur(x/2+0.5) in
    [0, 1]; sr is the cubic 1/sf downscale of x in [-1, 1]."""
    if task == "deblur":
        return lambda x: blur_reflect(x * 0.5 + 0.5, kernel)
    if task == "sr":
        return Resizer2D(hr_hw, 1.0 / sf)
    raise ValueError(f"no gradient degrade op for task {task!r} "
                     "(the reference has no first-order inpainting either)")


def frobenius_residual(operator: Callable, x_hat: torch.Tensor,
                       measurement: torch.Tensor) -> torch.Tensor:
    """||measurement - H(x_hat)||_F over the entire batch tensor, fp32."""
    diff = measurement - operator(x_hat)
    return torch.sqrt(torch.sum(diff.float() ** 2))


def _value_and_grad(fn: Callable, x: torch.Tensor):
    """(fn(x), d fn / d x) for a scalar ``fn``, both detached."""
    with torch.enable_grad():
        xv = x.detach().requires_grad_()
        val = fn(xv)
        (grad,) = torch.autograd.grad(val, xv)
    return val.detach(), grad


def make_grad_prox(operator: Callable, measurement: torch.Tensor) -> Callable:
    """First-order replacement for the analytic prox (sub_1_analytic=false);
    ``tau`` is a float or a (B, 1, 1, 1) tensor."""

    def prox(x0: torch.Tensor, tau) -> torch.Tensor:
        norm, grad = _value_and_grad(
            lambda v: frobenius_residual(operator, v, measurement), x0)
        return x0 - grad * norm / tau

    return prox


DPS_COLUMNS = ("sqrt_acp_t", "sqrt_1m_acp_t", "rho")


def dps_tables(plan: TrajectoryPlan) -> StepTables:
    """One row per kept step of ``dps_sample`` (all but the last of the
    plan): the y_t diffusion's coefficients and rho (``DPS_COLUMNS``); no
    flags."""
    n = plan.n_steps - 1
    coef = np.stack([np.asarray(getattr(plan, c)[:n], np.float32)
                     for c in DPS_COLUMNS], axis=-1).reshape(n, len(DPS_COLUMNS))
    return StepTables(coef=coef, flags=np.zeros((n, 0), bool),
                      t=np.asarray(plan.t[:n], np.int32), step=np.arange(n, dtype=np.int32),
                      repeat=np.zeros(n, np.int32))


def dps_y0_step(diffusion: Diffusion, model: Callable, operator: Callable,
                x: torch.Tensor, t: torch.Tensor, n_samp: torch.Tensor,
                measurement: torch.Tensor,
                batch_sum: Optional[Callable] = None) -> torch.Tensor:
    """One DPS_y0 step at the 0-d timestep ``t``: the ancestral step, then
    x_prev - d||measurement - H(x0_hat(x))|| / dx, differentiated through
    the denoiser.  ``batch_sum``, where the batch's rows are spread over
    ranks, sums a tensor over them: the norm is then the whole batch's."""
    with torch.enable_grad():
        xv = x.detach().requires_grad_()
        out = diffusion.p_sample(model, xv, t.expand(x.shape[0]), n_samp)
        norm = frobenius_residual(operator, out["pred_xstart"], measurement)
        (grad,) = torch.autograd.grad(norm, xv)
    if batch_sum is not None:
        # d||r|| / dx over the whole batch = d||r_rows|| / dx scaled by
        # ||r_rows|| / ||r||
        norm = norm.detach()
        grad = grad * (norm / torch.sqrt(batch_sum(norm * norm)))
    return out["sample"].detach() - grad * 1.0


def dps_yt_step(diffusion: Diffusion, model: Callable, operator: Callable,
                x: torch.Tensor, coef: torch.Tensor, t: torch.Tensor,
                n_samp: torch.Tensor, n_yt: torch.Tensor, y: torch.Tensor, *,
                task: str, lam_b) -> torch.Tensor:
    """One DPS_yt step from a row of ``dps_tables``: the ancestral step
    without a gradient, y diffused to t with the draw ``n_yt``, then x_prev
    - d||y_t - H(x_prev)|| / dx_prev * lambda * ||.|| / (rho lambda) * 0.35
    (``main_ddpir.py:420-445``); ``lam_b`` a float or a (B, 1, 1, 1) tensor
    (then rho is the plan's at lambda 1)."""
    sa_t, s1m_t, rho = coef.unbind(0)
    with torch.no_grad():
        xt = diffusion.p_sample(model, x, t.expand(x.shape[0]), n_samp)["sample"]
        y_t = sa_t * (2.0 * y - 1.0) + s1m_t * n_yt
    meas = y_t * 0.5 + 0.5 if task == "deblur" else y_t
    norm, grad = _value_and_grad(lambda v: frobenius_residual(operator, v, meas), xt)
    rho_eff = rho * lam_b if torch.is_tensor(lam_b) else rho
    return xt - grad * lam_b * norm / rho_eff * 0.35


def dps_sample(diffusion: Diffusion, model: Callable, operator: Callable,
               plan: TrajectoryPlan, x_init: torch.Tensor, *, noise: NoiseFn,
               mode: str, task: str, y: torch.Tensor, lambda_=1.0,
               batch_sum: Optional[Callable] = None) -> torch.Tensor:
    """The DPS trajectory; returns the restored image in [0, 1].

    Per kept step, one ancestral ``p_sample`` (x_prev, x0_hat) and then the
    mode's gradient correction (``dps_y0_step``, ``dps_yt_step``: one row of
    ``dps_tables`` each); the final step's model call is skipped as in
    DiffPIR mode (``main_ddpir.py:372, 384, 448``).  ``model`` is
    ``sampler.model_fn(den)``.  ``lambda_`` must be the value the plan's rho
    was built with, or a per-sample (B,) value with a plan built at lambda 1
    (the factor cancels in the DPS_yt step, ``main_ddpir.py:443``).
    ``batch_sum``, where the batch's rows are spread over ranks, sums a
    tensor over them: DPS_y0's norm is then the whole batch's.  (DPS_yt and
    the first-order prox use the gradient times the norm, which is the same
    on each rank's rows.)  Under a ``model`` or ``space`` axis the UNet's
    output is whole on every rank, and so is DPS_y0's norm.
    """
    if mode not in ("DPS_y0", "DPS_yt"):
        raise ValueError(f"unknown DPS mode {mode!r}")
    measurement = y if task == "deblur" else 2.0 * y - 1.0
    lam_b = per_sample(lambda_, x_init)
    dev = x_init.device
    tables = dps_tables(plan)
    coef = torch.from_numpy(tables.coef).to(dev)
    ts = torch.from_numpy(tables.t).to(dev)
    x = x_init.float()
    for i in range(len(tables.t)):
        n_samp = noise(i, 0, "samp", tuple(x.shape))
        if mode == "DPS_y0":
            x = dps_y0_step(diffusion, model, operator, x, ts[i], n_samp, measurement,
                            batch_sum)
        else:
            x = dps_yt_step(diffusion, model, operator, x, coef[i], ts[i], n_samp,
                            noise(i, 0, "yt", tuple(y.shape)), y, task=task, lam_b=lam_b)
    return x * 0.5 + 0.5
