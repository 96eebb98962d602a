"""The port's DiffPIR inpainting trajectory against the JAX package's, with
both fed the same noise: the port's noise hook hands it JAX's draws.

JAX draws, per step i and inner repeat u, from
``split(fold_in(fold_in(key, i), u), 4)`` (normals from the first two keys,
``diffpir_tpu/sampler.py:363-365, 392``); the Runner's initial noise comes
from the first half of ``split(PRNGKey(seed))`` (``runner.py:252``)."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffpir_tpu import config as jconfig
from diffpir_tpu import data as jdata
from diffpir_tpu import runner as jrunner
from diffpir_tpu import sampler as jsampler
from diffpir_tpu import schedule as jsched
from diffpir_tpu.models import zoo as jzoo
from diffpir_tpu.models.unet import UNet as JUNet
from diffpir_tpu_torch import config as tconfig
from diffpir_tpu_torch import data as tdata
from diffpir_tpu_torch import runner as trunner
from diffpir_tpu_torch import sampler as tsampler
from diffpir_tpu_torch import schedule as tsched
from diffpir_tpu_torch.models import zoo as tzoo
from diffpir_tpu_torch.models.unet import UNet as TUNet

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY32 = os.path.join(ROOT, "assets", "demo", "tiny_demo32.flax.npz")
# fp32 in both packages; the UNet agrees to ~1e-5 per call and the ten steps
# of prox and renoise do not amplify it beyond 1e-4 on [0, 1] images
ATOL = 1e-4


def jax_noise(key):
    """The port's noise hook, returning the JAX package's draws."""

    def noise(i, u, which, shape):
        k1, k2, _, _ = jax.random.split(
            jax.random.fold_in(jax.random.fold_in(key, i), u), 4)
        k = {"n1": k1, "n2": k2}[which]
        return torch.from_numpy(np.array(jax.random.normal(k, shape, jnp.float32)))

    return noise


@pytest.mark.parametrize("recover_known,zeta,eta", [(True, 1.0, 0.0), (False, 0.3, 0.5)])
def test_diffpir_sample_matches_jax(recover_known, zeta, eta):
    rng = np.random.default_rng(4)
    b, h = 2, 32
    y = rng.uniform(size=(b, h, h, 3)).astype(np.float32)
    mask = np.repeat((rng.uniform(size=(b, h, h, 1)) > 0.5).astype(np.float32), 3, -1)
    x_init = rng.standard_normal((b, h, h, 3)).astype(np.float32)
    plan_kw = dict(iter_num=10, lambda_=1.0, eta=eta, sigma_y=0.001)
    key = jax.random.PRNGKey(5)

    flat = tzoo.load_params_npz(TINY32)
    jmodel = JUNet(jzoo.TINY_TEST_CONFIG, dtype=jnp.float32)
    jsch = jsched.NoiseSchedule.linear(1e-4, 0.02, 1000)
    den = jsampler.make_denoiser(
        lambda p, x, t: jmodel.apply({"params": p}, x, t),
        jzoo._unflatten({k: jnp.asarray(v) for k, v in flat.items()}), jsch)
    ref = np.asarray(jsampler.diffpir_sample(
        den, jsampler.make_inpaint_prox(jnp.asarray(y), jnp.asarray(mask)),
        jsched.build_plan(jsch, **plan_kw), jnp.asarray(x_init), key,
        zeta=zeta, y=jnp.asarray(y), mask=jnp.asarray(mask),
        recover_known=recover_known))

    model = TUNet(tzoo.TINY_TEST_CONFIG)
    model.load_state_dict(tzoo.flax_to_torch(flat))
    tsch = tsched.NoiseSchedule.linear(1e-4, 0.02, 1000)
    ty, tmask = torch.from_numpy(y), torch.from_numpy(mask)
    got = tsampler.diffpir_sample(
        tsampler.make_denoiser(model.eval(), tsch),
        tsampler.make_inpaint_prox(ty, tmask), tsched.build_plan(tsch, **plan_kw),
        torch.from_numpy(x_init), noise=jax_noise(key), zeta=zeta, y=ty,
        mask=tmask, recover_known=recover_known).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
    if recover_known:
        # observed pixels are pasted back: y up to the rounding of (2y-1)/2+1/2
        np.testing.assert_allclose(got[mask > 0], y[mask > 0], atol=1e-7, rtol=0)


def test_runner_restore_matches_jax_runner():
    """The whole restore of one batch, Runner to Runner, demo32 config."""
    path = os.path.join(ROOT, "configs", "demo32_inpaint.yaml")
    over = dict(iter_num=8, cwd=ROOT, save_E=False, save_L=False)
    jcfg, tcfg = jconfig.load_config(path, over), tconfig.load_config(path, over)
    np.random.seed(jcfg.seed)
    batch = jdata.make_batches(jdata.prepare_images(jcfg), 2)[0]
    seed = 9
    ref = jrunner.Runner(jcfg, use_mesh=False).restore_batch(batch, seed=seed)

    k_init, k_samp = jax.random.split(jax.random.PRNGKey(seed))
    steps = jax_noise(k_samp)

    def noise(i, u, which, shape):
        if which == "init":
            return torch.from_numpy(np.array(
                jax.random.normal(k_init, shape, jnp.float32)))
        return steps(i, u, which, shape)

    runner = trunner.Runner(tcfg, device="cpu")
    got = runner.restore(torch.from_numpy(batch.img_L), torch.from_numpy(batch.mask),
                         tcfg.lambda_, tcfg.zeta, seed, noise=noise).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
    # without the hook the port draws from its own generator
    np.random.seed(tcfg.seed)
    tbatch = tdata.make_batches(tdata.prepare_images(tcfg), 2)[0]
    own = runner.restore_batch(tbatch, seed=seed)
    assert own.shape == ref.shape and np.isfinite(own).all()


def test_runner_refuses_unported_paths():
    """What the Runner still refuses: a restore without weights (an abstract
    Runner lowers only); DPS_y0 under a model or space axis, the device
    mesh, the trajectory modes, test_mode, save_LEH, LPIPS and FID it used to
    refuse now build."""
    path = os.path.join(ROOT, "configs", "demo32_inpaint.yaml")
    abstract = trunner.Runner(tconfig.load_config(path, dict(mesh_shape=[2, 2])),
                              abstract_params=True)
    with pytest.raises(RuntimeError, match="abstract_params"):
        abstract.restore_batch(None)
    deblur = os.path.join(ROOT, "configs", "demo64_deblur.yaml")
    for axes in (["data", "model"], ["data", "space"]):
        dps = trunner.Runner(tconfig.load_config(deblur, dict(
            mesh_shape=[1, 2], mesh_axes=axes, generate_mode="DPS_y0")),
            abstract_params=True)
        assert dps.mesh.shape == dict(zip(axes, [1, 2]))
    for over in (dict(calc_LPIPS=True), dict(calc_FID=True),
                 dict(generate_mode="repaint"), dict(iter_num_U=2),
                 dict(model_output_type="pred_x_prev"), dict(log_process=True),
                 dict(save_progressive_mask=True), dict(test_mode=1), dict(test_mode=4),
                 dict(save_LEH=True)):
        trunner.Runner(tconfig.load_config(path, over), device="cpu")
