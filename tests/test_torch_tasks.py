"""The port's deblurring and super-resolution paths against the JAX package:
degraded inputs and batches, the whole restore of a batch (both fed the same
noise through the port's noise hook), the reference sweep, the CLI, what the
port still refuses, and the CUDA attention's head widths for every config."""

import glob
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffpir_tpu import config as jconfig
from diffpir_tpu import data as jdata
from diffpir_tpu import runner as jrunner
from diffpir_tpu_torch import config as tconfig
from diffpir_tpu_torch import data as tdata
from diffpir_tpu_torch import runner as trunner
from diffpir_tpu_torch.kernels import attention as tattn
from diffpir_tpu_torch.main import main as tmain
from diffpir_tpu_torch.models import zoo as tzoo
from diffpir_tpu_torch.models.unet import AttentionBlock, UNet
from tests.test_torch_sampler import jax_noise

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "configs", "*.yaml")))
DEBLUR = os.path.join(ROOT, "configs", "demo64_deblur.yaml")
SISR = os.path.join(ROOT, "configs", "demo64_sisr.yaml")
# the tiny 32-px prior on the 32-px test images, few steps
TINY = dict(model_name="tiny_demo32", testset_name="demo32", iter_num=10,
            cwd=ROOT, save_E=False, save_L=False)
# fp32 in both packages: the UNet agrees to ~1e-5 per call, the FFT prox to
# a few 1e-7, and ten steps of prox and renoise stay within 1e-4 on [0, 1]
ATOL = 1e-4
# the SR observations and the classical init go through an fp32 resize
# (tests/test_torch_resize.py); everything else on the host is numpy/scipy
RESIZE_ATOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs several workers on the box's cores, and torch's default
    of one thread per core then oversubscribes them: a 32-px restore takes
    seconds instead of a third of one.  Two threads for this module."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _configs(path, **over):
    over = dict(dict(cwd=ROOT, save_E=False, save_L=False), **over)
    return jconfig.load_config(path, over), tconfig.load_config(path, over)


def _prepared(path, **over):
    jcfg, tcfg = _configs(path, **over)
    np.random.seed(jcfg.seed)
    ref = jdata.prepare_images(jcfg)
    np.random.seed(tcfg.seed)
    got = tdata.prepare_images(tcfg)
    return ref, got


@pytest.mark.parametrize("path,over", [
    (DEBLUR, {}),                                              # Levin09 k0
    (DEBLUR, dict(use_DIY_kernel=True, kernel_size=15, noise_level_img=12.75)),
    (SISR, dict(sr_mode="blur")),
    (SISR, dict(sr_mode="cubic", noise_level_img=12.75)),
    (SISR, dict(sr_mode="classical", sf=4, noise_level_img=12.75)),
], ids=["deblur-levin", "deblur-gaussian", "sr-blur", "sr-cubic", "sr-classical"])
def test_prepare_images_and_batches_match_jax(path, over):
    ref, got = _prepared(path, **over)
    assert len(got) == len(ref) == 4
    via_resize = path == SISR and over["sr_mode"] != "classical"
    for g, r in zip(got, ref):
        assert g["name"] == r["name"]
        for key in ("img_H", "kernel", "mask", "img_L"):
            assert g[key].dtype == r[key].dtype and g[key].shape == r[key].shape, key
            if key == "img_L" and via_resize:
                np.testing.assert_allclose(g[key], r[key], atol=RESIZE_ATOL, rtol=0)
            else:
                np.testing.assert_array_equal(g[key], r[key], err_msg=key)
        assert (g["init"] is None) == (r["init"] is None)
        if r["init"] is not None:
            np.testing.assert_allclose(g["init"], r["init"], atol=RESIZE_ATOL, rtol=0)
    tb, jb = tdata.make_batches(got, 3), jdata.make_batches(ref, 3)
    assert [b.names for b in tb] == [b.names for b in jb]
    for t, j in zip(tb, jb):
        np.testing.assert_array_equal(t.kernel, j.kernel)
        np.testing.assert_array_equal(t.mask, j.mask)
        np.testing.assert_allclose(t.img_L, j.img_L, atol=RESIZE_ATOL, rtol=0)
        assert (t.init is None) == (j.init is None)


def test_make_batches_pads_kernels_about_their_centre():
    rng = np.random.default_rng(0)
    items = [dict(img_H=np.zeros((4, 4, 3), np.uint8),
                  img_L=np.zeros((4, 4, 3), np.float32),
                  kernel=rng.random(shape).astype(np.float32),
                  mask=np.ones((4, 4, 3), np.float32), init=None, name=f"{i}.png")
             for i, shape in enumerate([(3, 3), (6, 4), (5, 7), (1, 1)])]
    got = tdata.make_batches(items, 4)[0]
    ref = jdata.make_batches(items, 4)[0]
    assert got.kernel.shape == ref.kernel.shape == (4, 6, 7)
    np.testing.assert_array_equal(got.kernel, ref.kernel)
    assert got.init is None and got.names == ref.names


def _restore_both(path, **over):
    jcfg, tcfg = _configs(path, **dict(TINY, **over))
    np.random.seed(jcfg.seed)
    batch = jdata.make_batches(jdata.prepare_images(jcfg), 2)[0]
    seed = 3
    ref = jrunner.Runner(jcfg, use_mesh=False).restore_batch(batch, seed=seed)

    k_init, k_samp = jax.random.split(jax.random.PRNGKey(seed))
    steps = jax_noise(k_samp)

    def noise(i, u, which, shape):
        if which == "init":
            return torch.from_numpy(np.array(
                jax.random.normal(k_init, shape, jnp.float32)))
        return steps(i, u, which, shape)

    runner = trunner.Runner(tcfg, device="cpu")

    def t(a):
        return None if a is None else torch.from_numpy(a)

    got = runner.restore(t(batch.img_L), t(batch.mask), tcfg.lambda_, tcfg.zeta, seed,
                         noise=noise, kernel=t(batch.kernel), init=t(batch.init))
    return got.numpy(), ref, runner, batch


@pytest.mark.parametrize("path,over", [
    (DEBLUR, dict(ty_init=True)),
    (DEBLUR, dict(ty_init=False, noise_level_img=12.75)),
    (DEBLUR, dict(ty_init=True, noise_level_img=12.75)),
    (SISR, dict(sr_mode="blur")),
    (SISR, dict(sr_mode="cubic")),
    (SISR, dict(sr_mode="classical", noise_level_img=12.75)),
], ids=["deblur-ty-s0", "deblur-s0.05", "deblur-ty-s0.05", "sr-blur", "sr-cubic",
        "sr-classical"])
def test_runner_restore_matches_jax_runner(path, over):
    got, ref, runner, batch = _restore_both(path, **over)
    assert got.shape == ref.shape == batch.img_H.shape
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
    if over.get("sr_mode") == "classical":
        # the port draws its own noise without the hook; shapes and range hold
        own = runner.restore_batch(tdata.Batch(**vars(batch)), seed=3)
        assert own.shape == ref.shape and np.isfinite(own).all()


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_reference_sweep_matches_jax(path):
    jcfg, tcfg = _configs(path)
    assert trunner.reference_sweep(tcfg) == jrunner.reference_sweep(jcfg)


def test_cli_deblur_sweep_is_one_point_at_7_lambda_3_zeta():
    # zeta 0.3: the sweep's 3 zeta must stay <= 1 (sqrt(1 - zeta) in the renoise)
    argv = ["--opt", DEBLUR, "--cpu", "--set", "model_name=tiny_demo32",
            "--set", "testset_name=demo32", "--set", "iter_num=3", "--set", "zeta=0.3",
            "--set", f"cwd={ROOT}", "--set", "save_E=false", "--set", "save_L=false"]
    (res,) = tmain(argv)
    assert res["lambda_"] == 7 * 150.0 and res["zeta"] == pytest.approx(0.9)
    assert res["n_images"] == 4 and res["weights"] == "demo"
    assert 10.0 < res["psnr"] < 60.0
    (one,) = tmain(argv + ["--no-sweep"])
    assert one["lambda_"] == 150.0 and one["zeta"] == 0.3


def test_unported_options_are_refused():
    """Nothing the deblur and SR paths refuse any more: DPS_y0 under a mesh
    with a model or space axis builds (its gradient runs through those
    axes' collectives), and so do the device mesh, the DIY motion PSF,
    LPIPS, FID, the first-order prox (sub_1_analytic=false), the DPS modes
    and attention heads wider than 256 channels (no longer a limit of the
    CUDA kernel)."""
    for path in (DEBLUR, SISR):
        for axes in (("data", "model"), ("data", "space")):
            _, tcfg = _configs(path, mesh_shape=[1, 2], mesh_axes=list(axes),
                               generate_mode="DPS_y0")
            assert trunner.Runner(tcfg, abstract_params=True).mesh.shape == dict(
                zip(axes, (1, 2)))
        _, tcfg = _configs(path, mesh_shape=[1, 2], generate_mode="DPS_yt")
        assert trunner.Runner(tcfg, abstract_params=True).mesh.shape == {"data": 1,
                                                                          "model": 2}
        for over in (dict(sub_1_analytic=False), dict(generate_mode="DPS_y0"),
                     dict(generate_mode="DPS_yt"), dict(calc_LPIPS=True),
                     dict(calc_FID=True), dict(use_DIY_kernel=True, blur_mode="motion")):
            _, tcfg = _configs(path, **over)
            trunner.Runner(tcfg, device="cpu")
    for ch in (257, 320):
        assert tattn.check_inputs(torch.zeros((1, 4, 3 * 2 * ch)), 2) == ch


def _model_names():
    names = set()
    for path in CONFIGS:
        names.add(tconfig.load_config(path, dict(cwd=ROOT)).model_name)
    return sorted(names)


@pytest.mark.parametrize("model_name", _model_names())
def test_cuda_attention_takes_every_config_head_width(model_name):
    """check_inputs (run on a CPU tensor of each shape) accepts the head
    width of every attention block of every model a config names."""
    with torch.device("meta"):
        model = UNet(tzoo.model_config_for(model_name))
    blocks = [m for m in model.modules() if isinstance(m, AttentionBlock)]
    assert blocks
    for m in blocks:
        ch = m.proj.in_features // m.num_heads
        qkv = torch.zeros((2, 16, 3 * m.num_heads * ch))
        assert tattn.check_inputs(qkv, m.num_heads) == ch
        assert ch in tattn.KERNEL_HEAD_CHANNELS
