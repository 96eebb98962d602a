"""The port's ``Diffusion`` (sampling half) against the JAX package's: the
forward process, ``p_mean_variance`` for every mean and variance type,
conditioning, and the ancestral and DDIM steps fed JAX's draw.  fp32 in
both, atol 1e-5 (the tables are the same float64 values cast to fp32)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffpir_tpu import diffusion as jdiff
from diffpir_tpu import schedule as jsched
from diffpir_tpu_torch import diffusion as tdiff
from diffpir_tpu_torch import schedule as tsched

ATOL = 1e-5
MEANS = ("previous_x", "start_x", "epsilon")
VARS = ("learned", "fixed_small", "fixed_large", "learned_range")
B, H, C = 3, 8, 3


def _both(mean="epsilon", var="learned_range"):
    jd = jdiff.Diffusion(jsched.NoiseSchedule.linear(1e-4, 0.02, 1000), mean, var)
    td = tdiff.Diffusion(tsched.NoiseSchedule.linear(1e-4, 0.02, 1000), mean, var)
    return jd, td


def _inputs(seed, out_channels=2 * C):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, H, H, C)).astype(np.float32)
    out = rng.standard_normal((B, H, H, out_channels)).astype(np.float32)
    # the variance half of a learned-range model lies in [-1, 1]
    out[..., C:] = np.tanh(out[..., C:])
    t = np.array([999, 400, 0], np.int32)
    return x, out, t


def _close(got, ref, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=atol, rtol=0)


def test_q_sample_and_posterior_mean():
    jd, td = _both()
    x0, _, t = _inputs(0)
    noise = np.random.default_rng(1).standard_normal(x0.shape).astype(np.float32)
    xt = np.random.default_rng(2).standard_normal(x0.shape).astype(np.float32)
    T = torch.from_numpy
    _close(td.q_sample(T(x0), T(t), T(noise)),
           jd.q_sample(jnp.asarray(x0), jnp.asarray(t), jnp.asarray(noise)))
    _close(td.q_posterior_mean(T(x0), T(xt), T(t)),
           jd.q_posterior_mean(jnp.asarray(x0), jnp.asarray(xt), jnp.asarray(t)))


@pytest.mark.parametrize("var", VARS)
@pytest.mark.parametrize("mean", MEANS)
def test_p_mean_variance_every_type(mean, var):
    jd, td = _both(mean, var)
    learned = var in ("learned", "learned_range")
    x, out, t = _inputs(3, 2 * C if learned else C)
    ref = jd.p_mean_variance(None, jnp.asarray(x), jnp.asarray(t),
                             model_output=jnp.asarray(out))
    got = td.p_mean_variance(None, torch.from_numpy(x), torch.from_numpy(t),
                             model_output=torch.from_numpy(out))
    for k in ("mean", "log_variance", "pred_xstart"):
        assert tuple(got[k].shape) == ref[k].shape, k
        _close(got[k], ref[k])


def _cond(x, t):
    """A stand-in for grad log p(y|x), the same arithmetic in both packages."""
    return -0.1 * x + 0.01


@pytest.mark.parametrize("cond", [False, True], ids=["plain", "cond_fn"])
@pytest.mark.parametrize("step,eta", [("p_sample", None), ("ddim_sample", 0.0),
                                      ("ddim_sample", 0.7)])
def test_steps_with_jax_draw(step, eta, cond):
    jd, td = _both()
    x, out, t = _inputs(4)
    key = jax.random.PRNGKey(11)
    draw = np.array(jax.random.normal(key, x.shape, jnp.float32))
    kw = {} if eta is None else {"eta": eta}
    ref = getattr(jd, step)(lambda xv, tv: jnp.asarray(out), jnp.asarray(x),
                            jnp.asarray(t), key,
                            cond_fn=_cond if cond else None, **kw)
    got = getattr(td, step)(lambda xv, tv: torch.from_numpy(out), torch.from_numpy(x),
                            torch.from_numpy(t), torch.from_numpy(draw),
                            cond_fn=_cond if cond else None, **kw)
    for k in ("sample", "pred_xstart"):
        _close(got[k], ref[k])
    # t == 0 rows take no noise
    if step == "p_sample" and not cond:
        mean = td.p_mean_variance(None, torch.from_numpy(x), torch.from_numpy(t),
                                  model_output=torch.from_numpy(out))["mean"]
        torch.testing.assert_close(got["sample"][2], mean[2], rtol=0, atol=0)


def test_tables_follow_the_input_device_and_are_made_once():
    _, td = _both()
    x = torch.zeros((2, 4, 4, 3))
    t = torch.tensor([5, 6], dtype=torch.int32)
    td.q_sample(x, t, x)
    tabs = td._tables(torch.device("cpu"))
    td.q_sample(x, t, x)
    assert td._tables(torch.device("cpu")) is tabs
    assert all(v.dtype == torch.float32 for v in tabs.values())
