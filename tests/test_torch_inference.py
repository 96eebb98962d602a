"""The port's ``inference.py`` (``test_mode`` 0-4: pad to modulo, recursive
split, x8 ensemble) against ``diffpir_tpu.inference``, each side through its
own tiny_demo32 UNet at a fixed timestep (weights carried over by
``flax_to_torch``); and the Runner with ``test_mode`` 1 and 3 against the
JAX Runner, both fed the JAX Runner's noise."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffpir_tpu import config as jconfig
from diffpir_tpu import data as jdata
from diffpir_tpu import inference as jinf
from diffpir_tpu import runner as jrunner
from diffpir_tpu.models import zoo as jzoo
from diffpir_tpu.models.unet import UNet as JUNet
from diffpir_tpu_torch import config as tconfig
from diffpir_tpu_torch import inference as tinf
from diffpir_tpu_torch import runner as trunner
from diffpir_tpu_torch.data import Batch
from diffpir_tpu_torch.models import zoo as tzoo
from diffpir_tpu_torch.models.unet import UNet as TUNet
from tests.test_torch_runner_modes import jax_runner_noise

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY32 = os.path.join(ROOT, "assets", "demo", "tiny_demo32.flax.npz")
INPAINT32 = os.path.join(ROOT, "configs", "demo32_inpaint.yaml")
# each side's UNet agrees to a few 1e-6 per call in fp32 (outputs of order
# 1-5); the modes only move, pad, crop and average its outputs
ATOL = 1e-5
# the Runner: four steps of prox and renoise around the UNet (as the
# inpainting trajectory test)
RUNNER_ATOL = 1e-4
T = 400


@pytest.fixture(scope="module")
def unets():
    flat = tzoo.load_params_npz(TINY32)
    params = jzoo._unflatten({k: jnp.asarray(v) for k, v in flat.items()})
    jmodel = JUNet(jzoo.TINY_TEST_CONFIG, dtype=jnp.float32)
    japply = jax.jit(lambda v: jmodel.apply(
        {"params": params}, v, jnp.full((v.shape[0],), T, jnp.int32)))
    tmodel = TUNet(tzoo.TINY_TEST_CONFIG)
    tmodel.load_state_dict(tzoo.flax_to_torch(flat))

    def tapply(v):
        with torch.no_grad():
            return tmodel(v, torch.full((v.shape[0],), T, dtype=torch.int32))

    return japply, tapply


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("mode,size", [(0, 32), (1, 28), (2, 48), (3, 32), (4, 48)])
def test_test_mode_matches_jax(unets, mode, size):
    """Mode 1 pads 28 px to 32; modes 2 and 4 split 48 px into four 32-px
    quadrants (min_size 32, refield 8); mode 4 splits each of the 8 stacked
    variants."""
    japply, tapply = unets
    x = _x((1, size, size, 3), mode)
    kw = dict(refield=8, min_size=32, modulo=8)
    ref = np.asarray(jinf.test_mode(japply, jnp.asarray(x), mode, **kw))
    got = tinf.test_mode(tapply, torch.from_numpy(x), mode, **kw).numpy()
    assert got.shape == ref.shape == (1, size, size, 6)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


def test_augment8_and_invert8_match_jax():
    x = _x((2, 6, 6, 3), 5)
    ref = np.asarray(jinf.augment8(jnp.asarray(x)))
    got = tinf.augment8(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), ref)  # data movement only
    np.testing.assert_allclose(tinf.invert8(got).numpy(),
                               np.asarray(jinf.invert8(jnp.asarray(ref))), atol=1e-6)
    np.testing.assert_allclose(tinf.invert8(got).numpy(), x, atol=1e-6)
    with pytest.raises(ValueError, match="unknown test mode"):
        tinf.test_mode(lambda v: v, torch.from_numpy(x), 5)


def test_x8_apply_on_a_non_square_input_matches_jax():
    """Two calls of four variants when H != W; a position-dependent function
    (a column ramp) so that a wrong inverse shows."""
    x = _x((1, 5, 7, 2), 6)
    ramp = np.arange(7, dtype=np.float32)

    def jfn(v):
        return v * v + jnp.arange(v.shape[2], dtype=jnp.float32)[None, None, :, None]

    def tfn(v):
        return v * v + torch.arange(v.shape[2], dtype=torch.float32)[None, None, :, None]

    ref = np.asarray(jinf.x8_apply(jfn, jnp.asarray(x)))
    got = tinf.x8_apply(tfn, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6)
    assert not np.allclose(got, x * x + ramp[None, None, :, None])


def test_split_and_pad_modulo_apply_match_jax(unets):
    """A non-square 70x52 input splits twice (40x32, then 24x24 quadrants);
    pad_modulo_apply alone pads 30x37 to 32x40."""
    japply, tapply = unets
    x = _x((1, 70, 52, 3), 7)
    kw = dict(refield=8, min_size=32, modulo=8)
    ref = np.asarray(jinf.split_apply(japply, jnp.asarray(x), **kw))
    got = tinf.split_apply(tapply, torch.from_numpy(x), **kw).numpy()
    assert got.shape == ref.shape == (1, 70, 52, 6)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)

    x = _x((1, 30, 37, 3), 8)
    seen = []
    ref = np.asarray(jinf.pad_modulo_apply(japply, jnp.asarray(x), 8))
    got = tinf.pad_modulo_apply(lambda v: seen.append(v.shape) or tapply(v),
                                torch.from_numpy(x), 8).numpy()
    assert seen == [(1, 32, 40, 3)]
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("test_mode", [1, 3])
def test_runner_test_mode_matches_jax_runner(monkeypatch, test_mode):
    """Two inpainting observations of demo32, four steps: test_mode 1 on
    images cropped to 28 px pads each UNet call to 32 px; test_mode 3 runs
    each call on the 32-px images as the x8 ensemble."""
    size = 28 if test_mode == 1 else 32
    over = dict(model_name="tiny_demo32", testset_name="demo32", cwd=ROOT,
                iter_num=4, test_mode=test_mode, save_E=False, save_L=False)
    jcfg, tcfg = jconfig.load_config(INPAINT32, over), tconfig.load_config(INPAINT32, over)
    np.random.seed(jcfg.seed)
    full = jdata.make_batches(jdata.prepare_images(jcfg), 2)[0]
    crop = lambda a: np.ascontiguousarray(a[:, :size, :size])
    batch = Batch(img_H=crop(full.img_H), img_L=crop(full.img_L),
                  kernel=full.kernel, mask=crop(full.mask), names=full.names)
    ref = jrunner.Runner(jcfg, use_mesh=False).restore_batch(batch, seed=3)
    monkeypatch.setattr(trunner, "generator_noise", jax_runner_noise("DiffPIR"))
    calls = []
    runner = trunner.Runner(tcfg, device="cpu")
    model = runner.model
    runner.model.forward = lambda x, t, y=None: (calls.append(tuple(x.shape))
                                                 or TUNet.forward(model, x, t, y))
    got = runner.restore_batch(batch, seed=3)
    assert got.shape == ref.shape == (2, size, size, 3)
    np.testing.assert_allclose(got, ref, atol=RUNNER_ATOL, rtol=0)
    assert set(calls) == {(2, 32, 32, 3) if test_mode == 1 else (16, 32, 32, 3)}
