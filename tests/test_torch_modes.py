"""The port's other trajectory modes against the JAX package's, both fed the
same noise (the port's noise hook hands it JAX's draws): ``diffpir_sample``
in repaint and vanilla mode, with ``iter_num_U = 2``, with progress
snapshots and with per-sample (lambda, zeta); ``xprev_sample`` (inpainting
and the plain chain, ancestral and DDIM); ``denoise_output``; and per-sample
operating points against per-image scalar runs.  The tiny 32-px prior in
fp32 in both packages."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffpir_tpu import diffusion as jdiff
from diffpir_tpu import sampler as jsampler
from diffpir_tpu import schedule as jsched
from diffpir_tpu.models import zoo as jzoo
from diffpir_tpu.models.unet import UNet as JUNet
from diffpir_tpu_torch import diffusion as tdiff
from diffpir_tpu_torch import sampler as tsampler
from diffpir_tpu_torch import schedule as tsched
from diffpir_tpu_torch.models import zoo as tzoo
from diffpir_tpu_torch.models.unet import UNet as TUNet

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY32 = os.path.join(ROOT, "assets", "demo", "tiny_demo32.flax.npz")
# the trajectory bar of tests/test_torch_sampler.py: fp32, the UNet agrees to
# ~1e-5 per call, a few steps stay within 1e-4 on [0, 1] images
ATOL = 1e-4
PLAN = dict(iter_num=5, lambda_=1.0, eta=0.3, sigma_y=0.05)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def jax_draws(key, generate_mode: str = "DiffPIR"):
    """The port's noise hook, returning the draws the JAX package makes:
    ``diffpir_sample`` per (step, repeat) from ``fold_in(fold_in(key, i), u)``
    (repaint splits off its key first, ``diffpir_tpu/sampler.py:346, 363``),
    ``xprev_sample`` from ``fold_in(key, i)`` (``:257``) and ``dps_sample``
    from ``split(fold_in(key, i))`` (``diffpir_tpu/guidance.py:117``)."""

    def noise(i, u, which, shape):
        if which == "xprev":
            k = jax.random.fold_in(key, i)
        elif which in ("samp", "yt"):
            k = jax.random.split(jax.random.fold_in(key, i))[int(which == "yt")]
        else:
            k = jax.random.fold_in(jax.random.fold_in(key, i), u)
            if generate_mode == "repaint":
                k_rp, k = jax.random.split(k)
                if which == "rp":
                    k = k_rp
            if which != "rp":
                k = jax.random.split(k, 4)[("n1", "n2", "n3").index(which)]
        return torch.from_numpy(np.array(jax.random.normal(k, shape, jnp.float32)))

    return noise


@pytest.fixture(scope="module")
def models():
    flat = tzoo.load_params_npz(TINY32)
    jmodel = JUNet(jzoo.TINY_TEST_CONFIG, dtype=jnp.float32)
    jparams = jzoo._unflatten({k: jnp.asarray(v) for k, v in flat.items()})
    jsch = jsched.NoiseSchedule.linear(1e-4, 0.02, 1000)
    jden = jsampler.make_denoiser(lambda p, x, t: jmodel.apply({"params": p}, x, t),
                                  jparams, jsch)
    jfn = lambda x, t: jmodel.apply({"params": jparams}, x, t)
    tmodel = TUNet(tzoo.TINY_TEST_CONFIG)
    tmodel.load_state_dict(tzoo.flax_to_torch(flat))
    tmodel.eval().requires_grad_(False)
    tsch = tsched.NoiseSchedule.linear(1e-4, 0.02, 1000)
    tden = tsampler.make_denoiser(tmodel, tsch)
    return dict(jden=jden, jfn=jfn, jsch=jsch, tden=tden, tsch=tsch,
                jdiff=jdiff.Diffusion(jsch), tdiff=tdiff.Diffusion(tsch))


def _data(seed=4, b=2, h=32):
    rng = np.random.default_rng(seed)
    y = rng.uniform(size=(b, h, h, 3)).astype(np.float32)
    mask = np.repeat((rng.uniform(size=(b, h, h, 1)) > 0.5).astype(np.float32), 3, -1)
    x_init = rng.standard_normal((b, h, h, 3)).astype(np.float32)
    return y, mask, x_init


@pytest.mark.parametrize("mode,iter_num_U,progress,per_sample", [
    ("repaint", 1, False, False),
    ("vanilla", 1, False, False),
    ("DiffPIR", 2, False, False),
    ("repaint", 2, False, False),
    ("DiffPIR", 1, True, False),
    ("DiffPIR", 1, False, True),
], ids=["repaint", "vanilla", "iterU2", "repaint-iterU2", "progress", "per-sample"])
def test_diffpir_sample_modes_match_jax(models, mode, iter_num_U, progress, per_sample):
    y, mask, x_init = _data()
    key = jax.random.PRNGKey(7)
    zeta, lam = (np.array([0.3, 0.9], np.float32), np.array([0.5, 4.0], np.float32)) \
        if per_sample else (0.4, None)
    plan_kw = dict(PLAN, lambda_=1.0 if per_sample else 2.0)
    slots = tsched.make_progress_slots(PLAN["iter_num"]) if progress else None
    ref = jsampler.diffpir_sample(
        models["jden"], jsampler.make_inpaint_prox(jnp.asarray(y), jnp.asarray(mask)),
        jsched.build_plan(models["jsch"], **plan_kw), jnp.asarray(x_init), key,
        zeta=zeta, iter_num_U=iter_num_U, generate_mode=mode, y=jnp.asarray(y),
        mask=jnp.asarray(mask), recover_known=True, progress_slots=slots,
        lam_scale=None if lam is None else jnp.asarray(lam))
    ty, tmask = torch.from_numpy(y), torch.from_numpy(mask)
    got = tsampler.diffpir_sample(
        models["tden"], tsampler.make_inpaint_prox(ty, tmask),
        tsched.build_plan(models["tsch"], **plan_kw), torch.from_numpy(x_init),
        noise=jax_draws(key, mode), zeta=zeta, iter_num_U=iter_num_U,
        generate_mode=mode, y=ty, mask=tmask, recover_known=True,
        progress_slots=slots, lam_scale=lam)
    if progress:
        (got, frames), (ref, ref_frames) = got, ref
        assert frames.shape == ref_frames.shape == (int(slots.max()) + 1,) + y.shape
        np.testing.assert_allclose(frames.numpy(), np.asarray(ref_frames),
                                   atol=ATOL, rtol=0)
        # the skipped final step's slot holds the final state
        np.testing.assert_array_equal(frames[-1].numpy(), got.numpy())
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


@pytest.mark.parametrize("n_steps,max_snapshots", [(1, 10), (5, 10), (20, 10),
                                                   (49, 10), (100, 10), (7, 3)])
def test_progress_slots_match_jax(n_steps, max_snapshots):
    got = tsched.make_progress_slots(n_steps, max_snapshots)
    np.testing.assert_array_equal(got, jsched.make_progress_slots(n_steps, max_snapshots))
    assert got[-1] >= 0 and got.dtype == np.int32


@pytest.mark.parametrize("ddim", [False, True], ids=["ancestral", "ddim"])
@pytest.mark.parametrize("inpaint", [True, False], ids=["inpaint", "chain"])
def test_xprev_sample_matches_jax(models, inpaint, ddim):
    y, mask, x_init = _data(5)
    key = jax.random.PRNGKey(3)
    plan_kw = dict(PLAN, rho_mode="xprev")
    ref = jsampler.xprev_sample(
        models["jdiff"], models["jfn"], jsched.build_plan(models["jsch"], **plan_kw),
        jnp.asarray(x_init), key, y=jnp.asarray(y) if inpaint else None,
        mask=jnp.asarray(mask) if inpaint else None, ddim=ddim, recover_known=True)
    got = tsampler.xprev_sample(
        models["tdiff"], tsampler.model_fn(models["tden"]),
        tsched.build_plan(models["tsch"], **plan_kw), torch.from_numpy(x_init),
        noise=jax_draws(key), ddim=ddim,
        y=torch.from_numpy(y) if inpaint else None,
        mask=torch.from_numpy(mask) if inpaint else None, recover_known=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


@pytest.mark.parametrize("output_type", ["pred_xstart", "epsilon", "score"])
def test_denoise_output_matches_jax(models, output_type):
    _, _, x = _data(6)
    t = 600
    ref = jsampler.denoise_output(models["jden"], jnp.asarray(x), t, output_type)
    got = tsampler.denoise_output(models["tden"], torch.from_numpy(x), t, output_type)
    # one UNet call (~1e-5) through x0's coefficients at t = 600 (~2): the
    # trajectory bar, relative to the output's range for eps and score
    scale = max(1.0, float(np.abs(np.asarray(ref)).max()))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL * scale, rtol=0)


def _noise_of(seed):
    gen = torch.Generator().manual_seed(seed)
    draws = {}

    def noise(i, u, which, shape):
        if (i, u, which) not in draws:
            draws[(i, u, which)] = torch.randn(shape, generator=gen)
        return draws[(i, u, which)]

    return noise


@pytest.mark.parametrize("sampler", ["diffpir", "xprev"])
def test_per_sample_points_equal_per_image_scalar_runs(models, sampler):
    """Row j of a per-sample (lambda, zeta) run equals row j of the same
    batch run with (lambda_j, zeta_j) as scalars."""
    y, mask, x_init = _data(8)
    ty, tmask, tx = torch.from_numpy(y), torch.from_numpy(mask), torch.from_numpy(x_init)
    lams, zetas = [0.5, 3.0], [0.2, 0.8]
    rho_mode = "xstart" if sampler == "diffpir" else "xprev"

    def run(lam, zeta, lam_scale):
        plan = tsched.build_plan(models["tsch"], **dict(PLAN, lambda_=lam,
                                                        rho_mode=rho_mode))
        if sampler == "diffpir":
            return tsampler.diffpir_sample(
                models["tden"], tsampler.make_inpaint_prox(ty, tmask), plan, tx,
                noise=_noise_of(1), zeta=zeta, y=ty, mask=tmask, recover_known=True,
                lam_scale=lam_scale)
        return tsampler.xprev_sample(
            models["tdiff"], tsampler.model_fn(models["tden"]), plan, tx,
            noise=_noise_of(1), y=ty, mask=tmask, lam_scale=lam_scale)

    per = run(1.0, np.array(zetas, np.float32), np.array(lams, np.float32))
    for j in range(2):
        one = run(lams[j], zetas[j], None)
        np.testing.assert_allclose(per[j].numpy(), one[j].numpy(), atol=2e-6, rtol=0)
