"""Gaussian diffusion, the sampling half: q_sample, the posterior mean,
p_mean_variance, conditioning, and the ancestral and DDIM steps.

Port of ``diffpir_tpu/diffusion.py:36-206`` (reference
``guided_diffusion/gaussian_diffusion.py:188-206, 232-439, 537-585``).  The
tables come from the port's ``NoiseSchedule`` (float64 on the host) and are
gathered as fp32 tensors on the device of the step's input, made once per
device.  A step's random draw is an argument (``noise``, of x's shape), not
a key: the caller decides where it comes from.  Timesteps may differ per
batch element; ``table[t]`` is broadcast over the trailing dimensions.  The
training half (losses, the VLB terms, bits per dimension, the sample loops)
is not ported yet (ROADMAP.md queue A).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from diffpir_tpu_torch.schedule import NoiseSchedule

__all__ = ["Diffusion", "ModelMeanType", "ModelVarType"]


class ModelMeanType:
    PREVIOUS_X = "previous_x"
    START_X = "start_x"
    EPSILON = "epsilon"


class ModelVarType:
    LEARNED = "learned"
    FIXED_SMALL = "fixed_small"
    FIXED_LARGE = "fixed_large"
    LEARNED_RANGE = "learned_range"


_TABLES = ("sqrt_alphas_cumprod", "sqrt_one_minus_alphas_cumprod",
           "posterior_mean_coef1", "posterior_mean_coef2",
           "posterior_log_variance_clipped", "sqrt_recip_alphas_cumprod",
           "sqrt_recipm1_alphas_cumprod", "alphas_cumprod", "alphas_cumprod_prev")


@dataclasses.dataclass(frozen=True)
class Diffusion:
    """Schedule tables bound with model-output semantics.

    ``model_fn(x, t) -> (B, ..., C or 2C)``, the variance half (when learned)
    concatenated on the last axis.
    """

    schedule: NoiseSchedule
    model_mean_type: str = ModelMeanType.EPSILON
    model_var_type: str = ModelVarType.LEARNED_RANGE
    _cache: dict = dataclasses.field(default_factory=dict, repr=False, compare=False)

    def _tables(self, device: torch.device) -> dict:
        tabs = self._cache.get(device)
        if tabs is None:
            sch = self.schedule

            def f32(a):
                return torch.as_tensor(np.asarray(a, np.float32), device=device)

            tabs = {name: f32(getattr(sch, name)) for name in _TABLES}
            tabs["log_betas"] = torch.log(f32(sch.betas))
            tabs["log_fixed_large"] = f32(np.log(np.append(
                sch.posterior_variance[1], sch.betas[1:])))
            self._cache[device] = tabs
        return tabs

    def _bx(self, name: str, t: torch.Tensor, ndim: int) -> torch.Tensor:
        """``table[t]`` broadcast over the trailing dimensions."""
        tab = self._tables(t.device)[name]
        return tab[t.long()].reshape(tuple(t.shape) + (1,) * (ndim - 1))

    # -- forward process -----------------------------------------------------
    def q_sample(self, x0: torch.Tensor, t: torch.Tensor,
                 noise: torch.Tensor) -> torch.Tensor:
        nd = x0.ndim
        return (self._bx("sqrt_alphas_cumprod", t, nd) * x0
                + self._bx("sqrt_one_minus_alphas_cumprod", t, nd) * noise)

    def q_posterior_mean(self, x0: torch.Tensor, x_t: torch.Tensor,
                         t: torch.Tensor) -> torch.Tensor:
        nd = x_t.ndim
        return (self._bx("posterior_mean_coef1", t, nd) * x0
                + self._bx("posterior_mean_coef2", t, nd) * x_t)

    # -- reverse process -----------------------------------------------------
    def p_mean_variance(self, model_fn: Optional[Callable], x: torch.Tensor,
                        t: torch.Tensor, clip_denoised: bool = True,
                        model_output: Optional[torch.Tensor] = None) -> dict:
        nd = x.ndim
        c = x.shape[-1]
        out = model_fn(x, t) if model_output is None else model_output
        out = out.float()

        if self.model_var_type in (ModelVarType.LEARNED, ModelVarType.LEARNED_RANGE):
            out, var_values = out[..., :c], out[..., c:]
            if self.model_var_type == ModelVarType.LEARNED:
                log_variance = var_values
            else:
                min_log = self._bx("posterior_log_variance_clipped", t, nd)
                max_log = self._bx("log_betas", t, nd)
                frac = (var_values + 1.0) / 2.0
                log_variance = frac * max_log + (1.0 - frac) * min_log
        elif self.model_var_type == ModelVarType.FIXED_SMALL:
            log_variance = self._bx("posterior_log_variance_clipped", t, nd)
        else:  # FIXED_LARGE
            log_variance = self._bx("log_fixed_large", t, nd)

        def clip(v):
            return v.clamp(-1.0, 1.0) if clip_denoised else v

        if self.model_mean_type == ModelMeanType.PREVIOUS_X:
            c1 = self._bx("posterior_mean_coef1", t, nd)
            c2 = self._bx("posterior_mean_coef2", t, nd)
            pred_xstart = clip(out / c1 - (c2 / c1) * x)
            mean = out
        else:
            if self.model_mean_type == ModelMeanType.START_X:
                pred_xstart = clip(out)
            else:  # EPSILON
                pred_xstart = clip(self._bx("sqrt_recip_alphas_cumprod", t, nd) * x
                                   - self._bx("sqrt_recipm1_alphas_cumprod", t, nd) * out)
            mean = self.q_posterior_mean(pred_xstart, x, t)
        return {"mean": mean, "log_variance": log_variance,
                "pred_xstart": pred_xstart}

    def condition_mean(self, cond_fn: Callable, p_mean_var: dict, x: torch.Tensor,
                       t: torch.Tensor) -> torch.Tensor:
        """Classifier-guidance mean shift: mean + var * grad log p(y|x)
        (reference ``gaussian_diffusion.py:356-372``)."""
        gradient = cond_fn(x, t)
        return p_mean_var["mean"] + torch.exp(p_mean_var["log_variance"]) * gradient.float()

    def condition_score(self, cond_fn: Callable, p_mean_var: dict, x: torch.Tensor,
                        t: torch.Tensor) -> dict:
        """Score-based conditioning for DDIM (reference ``:374-393``):
        eps <- eps - sqrt(1-acp_t) * grad; x0 and the posterior mean anew."""
        nd = x.ndim
        ab = self._bx("alphas_cumprod", t, nd)
        eps = self._eps(x, t, p_mean_var["pred_xstart"])
        eps = eps - torch.sqrt(1 - ab) * cond_fn(x, t).float()
        pred_xstart = (self._bx("sqrt_recip_alphas_cumprod", t, nd) * x
                       - self._bx("sqrt_recipm1_alphas_cumprod", t, nd) * eps)
        out = dict(p_mean_var)
        out["pred_xstart"] = pred_xstart
        out["mean"] = self.q_posterior_mean(pred_xstart, x, t)
        return out

    def _eps(self, x: torch.Tensor, t: torch.Tensor,
             pred_xstart: torch.Tensor) -> torch.Tensor:
        nd = x.ndim
        return ((self._bx("sqrt_recip_alphas_cumprod", t, nd) * x - pred_xstart)
                / self._bx("sqrt_recipm1_alphas_cumprod", t, nd))

    @staticmethod
    def _nonzero(t: torch.Tensor, ndim: int) -> torch.Tensor:
        return (t != 0).float().reshape(tuple(t.shape) + (1,) * (ndim - 1))

    def p_sample(self, model_fn: Callable, x: torch.Tensor, t: torch.Tensor,
                 noise: torch.Tensor, clip_denoised: bool = True,
                 cond_fn: Optional[Callable] = None) -> dict:
        """One ancestral step x_t -> x_{t-1}; ``noise`` is its standard
        normal draw (no noise is added where t == 0)."""
        out = self.p_mean_variance(model_fn, x, t, clip_denoised)
        if cond_fn is not None:
            out["mean"] = self.condition_mean(cond_fn, out, x, t)
        sample = (out["mean"] + self._nonzero(t, x.ndim)
                  * torch.exp(0.5 * out["log_variance"]) * noise)
        return {"sample": sample, "pred_xstart": out["pred_xstart"]}

    def ddim_sample(self, model_fn: Callable, x: torch.Tensor, t: torch.Tensor,
                    noise: torch.Tensor, eta: float = 0.0, clip_denoised: bool = True,
                    cond_fn: Optional[Callable] = None) -> dict:
        """One DDIM step x_t -> x_{t-1} (``noise`` scaled by eta's sigma)."""
        nd = x.ndim
        out = self.p_mean_variance(model_fn, x, t, clip_denoised)
        if cond_fn is not None:
            out = self.condition_score(cond_fn, out, x, t)
        eps = self._eps(x, t, out["pred_xstart"])
        ab = self._bx("alphas_cumprod", t, nd)
        ab_prev = self._bx("alphas_cumprod_prev", t, nd)
        sigma = (eta * torch.sqrt((1 - ab_prev) / (1 - ab))
                 * torch.sqrt(1 - ab / ab_prev))
        mean_pred = (out["pred_xstart"] * torch.sqrt(ab_prev)
                     + torch.sqrt(1 - ab_prev - sigma**2) * eps)
        return {"sample": mean_pred + self._nonzero(t, nd) * sigma * noise,
                "pred_xstart": out["pred_xstart"]}
