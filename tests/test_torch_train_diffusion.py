"""The training half of the port's ``Diffusion`` against the JAX package's:
``training_losses`` for every mean and variance type (with the same noise
handed to both), ``vb_terms``, ``normal_kl``, the discretised
log-likelihood, ``prior_bpd``, ``calc_bpd_loop`` with JAX's ``fold_in``
draws, the sample loops and ``ddim_reverse_sample``.  fp32 in both; 1e-5
relative (1e-6 absolute near 0) for closed-form arithmetic, 1e-4 through a
UNet."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffpir_tpu import diffusion as jdiff
from diffpir_tpu import schedule as jsched
from diffpir_tpu.models.unet import UNet as JUNet
from diffpir_tpu.models.unet import UNetConfig as JUNetConfig
from diffpir_tpu.models.zoo import _unflatten
from diffpir_tpu_torch import diffusion as tdiff
from diffpir_tpu_torch import schedule as tsched
from diffpir_tpu_torch.models import zoo as tzoo
from diffpir_tpu_torch.models.unet import UNet as TUNet
from diffpir_tpu_torch.models.unet import UNetConfig as TUNetConfig

MEANS = ("previous_x", "start_x", "epsilon")
VARS = ("learned", "fixed_small", "fixed_large", "learned_range")
B, H, C = 3, 8, 3
# dryrun_train_step's 16-px model (diffpir_tpu/train/loop.py:383-386)
UNET = dict(image_size=16, model_channels=32, out_channels=6, num_res_blocks=1,
            attention_resolutions=(2,), channel_mult=(1, 2), num_heads=4,
            num_head_channels=16, dropout=0.0)



@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Parallel test workers each start one PyTorch thread per core, which
    oversubscribes the cores; two threads for this module."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)

def _both(mean="epsilon", var="learned_range", T=1000):
    jd = jdiff.Diffusion(jsched.NoiseSchedule.linear(1e-4, 0.02, T), mean, var)
    td = tdiff.Diffusion(tsched.NoiseSchedule.linear(1e-4, 0.02, T), mean, var)
    return jd, td


def _close(got, ref, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=rtol, atol=atol)


def _stand_in(xp, learned):
    """A model_fn with the same arithmetic in both packages: a mean half
    and, for learned variances, a variance half in (-1, 1).  Its mean stays
    within a few of the decoder's standard deviations of x at t = 0: further
    out, the discretised likelihood is the difference of two CDF values
    near 1, and tanh's last bit (which differs between XLA and PyTorch)
    decides it in both packages."""
    cat = jnp.concatenate if xp is jnp else torch.cat

    def fn(x, t):
        tt = t.reshape((-1, 1, 1, 1)) / 1000.0
        mean = 0.99 * x - 0.005 + 0.1 * tt
        return cat([mean, xp.tanh(0.3 * x + tt)], -1) if learned else mean

    return fn


def _data(seed, shape=(B, H, H, C)):
    rng = np.random.default_rng(seed)
    x0 = np.clip(rng.standard_normal(shape) * 0.6, -1, 1).astype(np.float32)
    # pixels exactly at the edges take the decoder's edge branches
    x0[0, 0, 0] = -1.0
    x0[0, 0, 1] = 1.0
    noise = rng.standard_normal(shape).astype(np.float32)
    return x0, noise


@pytest.mark.parametrize("var", VARS)
@pytest.mark.parametrize("mean", MEANS)
def test_training_losses_every_type(mean, var):
    jd, td = _both(mean, var)
    learned = var in ("learned", "learned_range")
    x0, noise = _data(0)
    t = np.array([0, 1, 637], np.int32)
    ref = jd.training_losses(_stand_in(jnp, learned), jnp.asarray(x0), jnp.asarray(t),
                             None, noise=jnp.asarray(noise))
    got = td.training_losses(_stand_in(torch, learned), torch.from_numpy(x0),
                             torch.from_numpy(t), torch.from_numpy(noise))
    assert set(got) == set(ref) == ({"mse", "vb", "loss"} if learned else {"mse", "loss"})
    for k in ref:
        assert tuple(got[k].shape) == (B,)
        _close(got[k], ref[k])


def test_training_losses_freeze_the_mean_in_the_vb_term():
    """d vb / d mean-half is 0 in both; d vb / d variance-half agrees."""
    jd, td = _both()
    x0, noise = _data(1)
    t = np.array([3, 250, 999], np.int32)
    out = np.random.default_rng(2).standard_normal((B, H, H, 2 * C)).astype(np.float32)

    def jvb(o):
        return jd.training_losses(lambda x, tv: o, jnp.asarray(x0), jnp.asarray(t),
                                  None, noise=jnp.asarray(noise))["vb"].sum()

    ref = np.asarray(jax.grad(jvb)(jnp.asarray(out)))
    o = torch.from_numpy(out).requires_grad_()
    td.training_losses(lambda x, tv: o, torch.from_numpy(x0), torch.from_numpy(t),
                       torch.from_numpy(noise))["vb"].sum().backward()
    assert np.all(ref[..., :C] == 0) and torch.all(o.grad[..., :C] == 0)
    _close(o.grad, ref, atol=1e-7)


@pytest.mark.parametrize("var", VARS)
def test_vb_terms_and_prior_bpd(var):
    jd, td = _both("epsilon", var)
    learned = var in ("learned", "learned_range")
    x0, noise = _data(3)
    t = np.array([0, 500, 999], np.int32)
    sch = jsched.NoiseSchedule.linear(1e-4, 0.02, 1000)
    xt = (sch.sqrt_alphas_cumprod[t, None, None, None] * x0
          + sch.sqrt_one_minus_alphas_cumprod[t, None, None, None] * noise
          ).astype(np.float32)
    for clip in (False, True):
        ref = np.asarray(jd.vb_terms(_stand_in(jnp, learned), jnp.asarray(x0),
                                     jnp.asarray(xt), jnp.asarray(t), clip_denoised=clip))
        got = td.vb_terms(_stand_in(torch, learned), torch.from_numpy(x0),
                          torch.from_numpy(xt), torch.from_numpy(t),
                          clip_denoised=clip).numpy()
        # the KL terms at 1e-5; the decoder NLL of t = 0 at 1e-4: XLA's fp32
        # tanh is up to 2.5e-7 (4 ulps) from float64 (PyTorch's 3e-8), and
        # the NLL takes the log of a difference of two tanh-based CDFs
        _close(got[1:], ref[1:])
        _close(got[:1], ref[:1], rtol=1e-4)
    _close(td.prior_bpd(torch.from_numpy(x0)), jd.prior_bpd(jnp.asarray(x0)))


def test_normal_kl_and_discretized_log_likelihood():
    rng = np.random.default_rng(4)
    a, b, c, d = (rng.standard_normal((5, 7)).astype(np.float32) for _ in range(4))
    T = torch.from_numpy
    _close(tdiff.normal_kl(T(a), T(b), T(c), T(d)),
           jdiff.normal_kl(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c), jnp.asarray(d)))
    # means within a few scales of x (see _stand_in)
    x = np.clip(a, -1, 1)
    x[0, :3] = [-1.0, 1.0, 0.9995]
    log_scales = (-2.0 + 0.5 * np.tanh(c)).astype(np.float32)
    means = (x + np.exp(log_scales) * np.tanh(b)).astype(np.float32)
    _close(tdiff.discretized_gaussian_log_likelihood(T(x), means=T(means),
                                                     log_scales=T(log_scales)),
           jdiff.discretized_gaussian_log_likelihood(jnp.asarray(x), means=jnp.asarray(means),
                                                     log_scales=jnp.asarray(log_scales)))


def _fold_in_draws(key, shape, n):
    """JAX's per-iteration draws of calc_bpd_loop: normal(fold_in(key, i))."""
    return [np.array(jax.random.normal(jax.random.fold_in(key, i), shape, jnp.float32))
            for i in range(n)]


def test_calc_bpd_loop_with_jax_draws():
    jd, td = _both(T=8)
    x0, _ = _data(5)
    key = jax.random.PRNGKey(7)
    draws = _fold_in_draws(key, x0.shape, 8)
    ref = jd.calc_bpd_loop(_stand_in(jnp, True), jnp.asarray(x0), key)
    got = td.calc_bpd_loop(_stand_in(torch, True), torch.from_numpy(x0),
                           lambda i: torch.from_numpy(draws[i]))
    for k in ("total_bpd", "prior_bpd", "vb", "xstart_mse", "mse"):
        assert tuple(got[k].shape) == ref[k].shape, k
        _close(got[k], ref[k])


def _unet_pair(seed=0):
    """The 16-px UNet in both packages with the same non-zero weights."""
    tmodel = tzoo.init_random_(TUNet(TUNetConfig(**UNET)), seed)
    params = _unflatten(tzoo.torch_to_flax(tmodel.state_dict()))
    jmodel = JUNet(JUNetConfig(**UNET), dtype=jnp.float32)
    jfn = jax.jit(lambda x, t: jmodel.apply({"params": params}, x, t))
    return jfn, tmodel


@pytest.mark.parametrize("loop", ["ddim", "p_sample"])
def test_sample_loops_through_a_unet(loop):
    """The whole chain from the same x_T, with JAX's per-step draws handed
    in (eta 0 for DDIM: its draws are multiplied by 0)."""
    jd, td = _both(T=8)
    jfn, tmodel = _unet_pair()
    shape = (2, 16, 16, 3)
    key = jax.random.PRNGKey(9)
    _, k_loop = jax.random.split(key)
    x_T = np.random.default_rng(6).standard_normal(shape).astype(np.float32)
    draws = _fold_in_draws(k_loop, shape, 8)
    jloop = jd.ddim_sample_loop if loop == "ddim" else jd.p_sample_loop
    tloop = td.ddim_sample_loop if loop == "ddim" else td.p_sample_loop
    ref = jloop(jfn, shape, key, noise=jnp.asarray(x_T))
    with torch.no_grad():
        got = tloop(tmodel, shape, torch.from_numpy(x_T),
                    lambda i: torch.from_numpy(draws[i]))
    _close(got, ref, rtol=1e-4, atol=1e-4)


def test_sample_loop_draws_from_a_generator():
    _, td = _both(T=4)
    fn = _stand_in(torch, True)
    a = td.p_sample_loop(fn, (2, 4, 4, 3), generator=torch.Generator().manual_seed(1))
    b = td.p_sample_loop(fn, (2, 4, 4, 3), generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and torch.isfinite(a).all()
    with pytest.raises(ValueError, match="generator"):
        td.ddim_sample_loop(fn, (2, 4, 4, 3))


def test_ddim_reverse_sample_through_a_unet():
    jd, td = _both()
    jfn, tmodel = _unet_pair(1)
    x = np.random.default_rng(8).standard_normal((2, 16, 16, 3)).astype(np.float32)
    t = np.array([10, 700], np.int32)
    ref = jd.ddim_reverse_sample(jfn, jnp.asarray(x), jnp.asarray(t))
    with torch.no_grad():
        got = td.ddim_reverse_sample(tmodel, torch.from_numpy(x), torch.from_numpy(t))
    for k in ("sample", "pred_xstart"):
        _close(got[k], ref[k], rtol=1e-4, atol=1e-4)


def test_training_losses_through_a_unet():
    jd, td = _both()
    jfn, tmodel = _unet_pair(2)
    x0, noise = _data(9, (2, 16, 16, 3))
    t = np.array([0, 412], np.int32)
    ref = jd.training_losses(jfn, jnp.asarray(x0), jnp.asarray(t), None,
                             noise=jnp.asarray(noise))
    with torch.no_grad():
        got = td.training_losses(tmodel, torch.from_numpy(x0), torch.from_numpy(t),
                                 torch.from_numpy(noise))
    for k in ("mse", "vb", "loss"):
        _close(got[k], ref[k], rtol=1e-4, atol=1e-6)
