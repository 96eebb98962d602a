"""The port's schedule tables equal the JAX package's, exactly."""

import dataclasses

import numpy as np
import pytest

from diffpir_tpu import schedule as jsched
from diffpir_tpu_torch import schedule as tsched


@pytest.mark.parametrize("skip_type", ["quad", "uniform"])
@pytest.mark.parametrize("iter_num", [5, 20, 50, 100])
@pytest.mark.parametrize("lambda_,eta,sigma_y,t_start,noise_model_t,rho_mode", [
    (1.0, 0.0, 0.001, None, 0, "xstart"),
    (7.0, 0.5, 0.05, 600, 0, "xstart"),
    (0.3, 0.85, 0.1, None, 995, "xprev"),
])
def test_build_plan_tables_equal(skip_type, iter_num, lambda_, eta, sigma_y,
                                 t_start, noise_model_t, rho_mode):
    kw = dict(iter_num=iter_num, skip_type=skip_type, lambda_=lambda_, eta=eta,
              sigma_y=sigma_y, t_start=t_start, noise_model_t=noise_model_t,
              rho_mode=rho_mode)
    ref = jsched.build_plan(jsched.NoiseSchedule.linear(1e-4, 0.02, 1000), **kw)
    got = tsched.build_plan(tsched.NoiseSchedule.linear(1e-4, 0.02, 1000), **kw)
    for f in dataclasses.fields(jsched.TrajectoryPlan):
        a, b = getattr(got, f.name), getattr(ref, f.name)
        assert a.dtype == b.dtype, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)
    assert got.n_steps == ref.n_steps


@pytest.mark.parametrize("name", ["linear", "cosine"])
def test_named_schedule_tables_equal(name):
    ref = jsched.NoiseSchedule.named(name, 1000)
    got = tsched.NoiseSchedule.named(name, 1000)
    for prop in ("betas", "alphas_cumprod", "sqrt_recip_alphas_cumprod",
                 "sqrt_recipm1_alphas_cumprod", "reduced_alpha_cumprod",
                 "posterior_variance", "posterior_log_variance_clipped"):
        np.testing.assert_array_equal(getattr(got, prop), getattr(ref, prop),
                                      err_msg=prop)
    for sigma in (0.0, 0.01, 0.1, 0.5):
        assert got.sigma_to_t(sigma) == ref.sigma_to_t(sigma)


@pytest.mark.parametrize("sections", ["ddim25", "10,5", [100], "50"])
def test_space_timesteps_and_respacing_equal(sections):
    keep = tsched.space_timesteps(1000, sections)
    assert keep == jsched.space_timesteps(1000, sections)
    got, tmap = tsched.NoiseSchedule.linear(1e-4, 0.02, 1000).respaced(sorted(keep))
    ref, rmap = jsched.NoiseSchedule.linear(1e-4, 0.02, 1000).respaced(sorted(keep))
    np.testing.assert_array_equal(got.betas, ref.betas)
    np.testing.assert_array_equal(tmap, rmap)


@pytest.mark.parametrize("skip_type", ["quad", "uniform"])
def test_make_seq_equal(skip_type):
    for n in (3, 20, 100, 600):
        assert tsched.make_seq(1000, n, skip_type) == jsched.make_seq(1000, n, skip_type)
