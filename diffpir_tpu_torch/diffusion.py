"""Gaussian diffusion: sampling steps and loops, training losses, bits/dim.

Port of ``diffpir_tpu/diffusion.py`` (reference
``guided_diffusion/gaussian_diffusion.py`` and ``losses.py``):

  * ``q_sample``, ``p_mean_variance``, conditioning, ``p_sample`` and
    ``ddim_sample`` (``:188-206, 232-439, 537-585``);
  * ``ddim_reverse_sample`` and the loops ``p_sample_loop`` /
    ``ddim_sample_loop`` (``:587-633``), a Python loop over T;
  * ``vb_terms``, ``training_losses`` (MSE + the frozen-mean VLB term),
    ``prior_bpd`` and ``calc_bpd_loop`` (``:709-892``); ``normal_kl`` and
    ``discretized_gaussian_log_likelihood`` (``losses.py:12-77``).

The tables come from the port's ``NoiseSchedule`` (float64 on the host) and
are gathered as fp32 tensors on the device of the step's input, made once
per device.  Random draws are arguments, not keys: a step takes its
``noise``; a loop takes its initial noise and a ``step_noise(i)`` callable
for the draw of iteration ``i`` (by default ``torch.randn`` from a given
generator).  Timesteps may differ per batch element; ``table[t]`` is
broadcast over the trailing dimensions.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from diffpir_tpu_torch.schedule import NoiseSchedule

__all__ = ["Diffusion", "ModelMeanType", "ModelVarType", "normal_kl",
           "discretized_gaussian_log_likelihood"]


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
           "sqrt_recipm1_alphas_cumprod", "alphas_cumprod", "alphas_cumprod_prev",
           "alphas_cumprod_next")
_LOG2 = float(np.log(2.0))


def normal_kl(mean1, logvar1, mean2, logvar2):
    """KL(N(mean1, e^logvar1) || N(mean2, e^logvar2)), elementwise in nats."""
    return 0.5 * (-1.0 + logvar2 - logvar1 + torch.exp(logvar1 - logvar2)
                  + ((mean1 - mean2) ** 2) * torch.exp(-logvar2))


def _approx_std_normal_cdf(x):
    return 0.5 * (1.0 + torch.tanh(float(np.sqrt(2.0 / np.pi))
                                   * (x + 0.044715 * x**3)))


def discretized_gaussian_log_likelihood(x, *, means, log_scales):
    """Log-likelihood of images discretised to 256 bins (reference
    ``losses.py:50-77``)."""
    centered = x - means
    inv_stdv = torch.exp(-log_scales)
    cdf_plus = _approx_std_normal_cdf(inv_stdv * (centered + 1.0 / 255.0))
    cdf_min = _approx_std_normal_cdf(inv_stdv * (centered - 1.0 / 255.0))
    log_cdf_plus = torch.log(cdf_plus.clamp_min(1e-12))
    log_one_minus_cdf_min = torch.log((1.0 - cdf_min).clamp_min(1e-12))
    log_cdf_delta = torch.log((cdf_plus - cdf_min).clamp_min(1e-12))
    return torch.where(x < -0.999, log_cdf_plus,
                       torch.where(x > 0.999, log_one_minus_cdf_min, log_cdf_delta))


def _mean_flat(x: torch.Tensor) -> torch.Tensor:
    return x.mean(dim=tuple(range(1, x.ndim)))


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
            tabs["log_1m_alphas_cumprod"] = torch.log(1.0 - tabs["alphas_cumprod"])
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

    # -- loops ---------------------------------------------------------------
    def _full_t(self, x: torch.Tensor, step: int) -> torch.Tensor:
        return torch.full((x.shape[0],), step, dtype=torch.int32, device=x.device)

    def _sample_loop(self, sample_step, model_fn, shape, noise, step_noise, generator):
        if noise is None or step_noise is None:
            if generator is None:
                raise ValueError("pass a generator, or both noise and step_noise")

            def draw(_i=None):
                return torch.randn(shape, generator=generator, device=generator.device)

            noise = draw() if noise is None else noise
            step_noise = draw if step_noise is None else step_noise
        img = noise
        T = self.schedule.num_timesteps
        for i in range(T):
            t = self._full_t(img, T - 1 - i)
            img = sample_step(model_fn, img, t, step_noise(i))["sample"]
        return img

    def p_sample_loop(self, model_fn: Callable, shape, noise: Optional[torch.Tensor] = None,
                      step_noise: Optional[Callable[[int], torch.Tensor]] = None, *,
                      generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Unconditional ancestral sampling over the whole chain, from
        ``noise`` (x_T) with ``step_noise(i)`` the draw of iteration ``i``
        (either drawn from ``generator``, on its device, when not given)."""
        return self._sample_loop(self.p_sample, model_fn, shape, noise, step_noise,
                                 generator)

    def ddim_sample_loop(self, model_fn: Callable, shape,
                         noise: Optional[torch.Tensor] = None,
                         step_noise: Optional[Callable[[int], torch.Tensor]] = None, *,
                         eta: float = 0.0,
                         generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """DDIM sampling over the whole chain (see ``p_sample_loop``)."""
        def step(m, x, t, n):
            return self.ddim_sample(m, x, t, n, eta=eta)

        return self._sample_loop(step, model_fn, shape, noise, step_noise, generator)

    def ddim_reverse_sample(self, model_fn: Callable, x: torch.Tensor, t: torch.Tensor,
                            clip_denoised: bool = True) -> dict:
        """Deterministic reverse-ODE step x_t -> x_{t+1} (reference
        ``gaussian_diffusion.py:587-633``, eta 0)."""
        out = self.p_mean_variance(model_fn, x, t, clip_denoised)
        eps = self._eps(x, t, out["pred_xstart"])
        ab_next = self._bx("alphas_cumprod_next", t, x.ndim)
        mean_pred = (out["pred_xstart"] * torch.sqrt(ab_next)
                     + torch.sqrt(1 - ab_next) * eps)
        return {"sample": mean_pred, "pred_xstart": out["pred_xstart"]}

    # -- training ------------------------------------------------------------
    def vb_terms(self, model_fn: Optional[Callable], x0: torch.Tensor,
                 x_t: torch.Tensor, t: torch.Tensor, clip_denoised: bool = False,
                 model_output: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Per-example VLB term in bits/dim: KL to the posterior, or the
        decoder NLL where t == 0 (reference ``:709-742``)."""
        true_mean = self.q_posterior_mean(x0, x_t, t)
        true_logvar = self._bx("posterior_log_variance_clipped", t, x_t.ndim)
        out = self.p_mean_variance(model_fn, x_t, t, clip_denoised,
                                   model_output=model_output)
        kl = _mean_flat(normal_kl(true_mean, true_logvar,
                                  out["mean"], out["log_variance"])) / _LOG2
        nll = -_mean_flat(discretized_gaussian_log_likelihood(
            x0, means=out["mean"], log_scales=0.5 * out["log_variance"])) / _LOG2
        return torch.where(t == 0, nll, kl)

    def training_losses(self, model_fn: Callable, x0: torch.Tensor, t: torch.Tensor,
                        noise: torch.Tensor) -> dict:
        """Per-example ``mse``, ``vb`` (learned variance only) and ``loss``
        for the draw ``noise`` (reference ``:744-817``).  The VLB term sees
        the mean half detached: the variance learns through it, the mean
        does not."""
        x_t = self.q_sample(x0, t, noise)
        model_output = model_fn(x_t, t).float()
        terms = {}
        c = x0.shape[-1]
        if self.model_var_type in (ModelVarType.LEARNED, ModelVarType.LEARNED_RANGE):
            mean_out, var_values = model_output[..., :c], model_output[..., c:]
            frozen = torch.cat([mean_out.detach(), var_values], dim=-1)
            terms["vb"] = self.vb_terms(None, x0, x_t, t, model_output=frozen)
        else:
            mean_out = model_output
        if self.model_mean_type == ModelMeanType.PREVIOUS_X:
            target = self.q_posterior_mean(x0, x_t, t)
        elif self.model_mean_type == ModelMeanType.START_X:
            target = x0
        else:
            target = noise
        terms["mse"] = _mean_flat((target - mean_out) ** 2)
        terms["loss"] = terms["mse"] + terms["vb"] if "vb" in terms else terms["mse"]
        return terms

    def prior_bpd(self, x0: torch.Tensor) -> torch.Tensor:
        """KL(q(x_T|x_0) || N(0, I)) in bits/dim (reference ``:819-836``)."""
        t = self._full_t(x0, self.schedule.num_timesteps - 1)
        mean = self._bx("sqrt_alphas_cumprod", t, x0.ndim) * x0
        logvar = self._bx("log_1m_alphas_cumprod", t, x0.ndim).expand_as(mean)
        zeros = torch.zeros_like(mean)
        return _mean_flat(normal_kl(mean, logvar, zeros, zeros)) / _LOG2

    def calc_bpd_loop(self, model_fn: Callable, x0: torch.Tensor,
                      step_noise: Callable[[int], torch.Tensor]) -> dict:
        """Full-chain variational bits/dim (reference ``:838-892``);
        ``step_noise(i)`` is the draw of iteration ``i`` (t = T-1-i)."""
        T = self.schedule.num_timesteps
        vb, xstart_mse, mse = [], [], []
        for i in range(T):
            t = self._full_t(x0, T - 1 - i)
            noise = step_noise(i)
            x_t = self.q_sample(x0, t, noise)
            vb.append(self.vb_terms(model_fn, x0, x_t, t, clip_denoised=True))
            out = self.p_mean_variance(model_fn, x_t, t, clip_denoised=True)
            xstart_mse.append(_mean_flat((out["pred_xstart"] - x0) ** 2))
            mse.append(_mean_flat((self._eps(x_t, t, out["pred_xstart"]) - noise) ** 2))
        vb_t = torch.stack(vb, dim=1)
        prior = self.prior_bpd(x0)
        return {"total_bpd": vb_t.sum(dim=1) + prior, "prior_bpd": prior, "vb": vb_t,
                "xstart_mse": torch.stack(xstart_mse, dim=1),
                "mse": torch.stack(mse, dim=1)}
