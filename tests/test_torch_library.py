"""The rest of the port's library surface against the JAX package: the
kernel factories, the DPIR schedule, Shepard initialisation, trajectory
PSFs, the circular blur and AWGN (``ops/degrade.py``), the dihedral
augmentations and YCbCr conversions (``utils/image.py``), and the zoo's
``weights_path`` and ``create_model_and_diffusion``.  Host functions are
bit-equal to JAX's on the same seed; the device blur is within 1e-5 in
fp32.  Mirrors tests/test_boundary_and_degrade.py,
test_inference_utils.py and test_fft_prox.py."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

from diffpir_tpu.models import zoo as jzoo
from diffpir_tpu.ops import degrade as jdeg
from diffpir_tpu.utils import image as jim
from diffpir_tpu_torch.models import zoo as tzoo
from diffpir_tpu_torch.ops import degrade as tdeg
from diffpir_tpu_torch.utils import image as tim

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("args", [("gaussian", 7, 1.5), ("laplacian", 0.2),
                                  ("laplacian", 1.7), ("average", 5), ("prewitt",),
                                  ("sobel",)])
def test_fspecial_equals_jax(args):
    got, ref = tdeg.fspecial(*args), jdeg.fspecial(*args)
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)


def test_fspecial_closed_forms():
    np.testing.assert_allclose(tdeg.fspecial_average(5), np.full((5, 5), 1 / 25))
    lap = tdeg.fspecial_laplacian(0.2)
    np.testing.assert_allclose(lap.sum(), 0.0, atol=1e-12)
    np.testing.assert_array_equal(tdeg.fspecial_sobel()[0], [1, 2, 1])
    np.testing.assert_array_equal(tdeg.fspecial_prewitt()[2], [-1, -1, -1])


@pytest.mark.parametrize("args", [(), (0.01, 20, 2.55), (12.75 / 255, 8, 10.0)])
def test_get_rho_sigma_equals_jax(args):
    (r1, s1), (r2, s2) = tdeg.get_rho_sigma(*args), jdeg.get_rho_sigma(*args)
    np.testing.assert_array_equal(np.asarray(r1), np.asarray(r2))
    np.testing.assert_array_equal(s1, s2)


@pytest.mark.parametrize("window,channels", [(5, 3), (9, 3), (5, 0)])
def test_shepard_initialize_equals_jax_and_fills_holes(window, channels):
    rng = np.random.default_rng(window + channels)
    shape = (24, 20, channels) if channels else (24, 20)
    img = rng.uniform(size=shape)
    mask = (rng.uniform(size=(24, 20)) > 0.6).astype(np.float64)
    obs = img * (mask[:, :, None] if channels else mask)
    got = tdeg.shepard_initialize(obs, mask, window=window)
    np.testing.assert_array_equal(got, jdeg.shepard_initialize(obs, mask, window=window))
    assert got.shape == shape
    keep = mask > 0
    np.testing.assert_array_equal(got[keep], obs[keep])


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("h", [25, 37])
def test_trajectory_psf_equals_jax_on_the_same_seed(seed, h):
    got = tdeg.trajectory_psf(h, np.random.default_rng(seed))
    ref = jdeg.trajectory_psf(h, np.random.default_rng(seed))
    np.testing.assert_array_equal(got, ref)
    assert got.shape == (h, h) and abs(got.sum() - 1.0) < 1e-12 and (got >= 0).all()


@pytest.mark.parametrize("hw,ks,batch", [((32, 32), 7, 2), ((24, 40), 5, 1)])
def test_blur_circular_equals_jax_and_scipy_wrap(hw, ks, batch):
    rng = np.random.default_rng(ks)
    x = rng.uniform(size=(batch,) + hw + (3,)).astype(np.float32)
    k = rng.uniform(size=(batch, ks, ks)).astype(np.float32)
    k /= k.sum(axis=(1, 2), keepdims=True)
    got = tdeg.blur_circular(torch.from_numpy(x), torch.from_numpy(k)).numpy()
    ref = np.asarray(jdeg.blur_circular(jnp.asarray(x), jnp.asarray(k)))
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    wrap = ndimage.convolve(x[0].astype(np.float64), k[0][:, :, None].astype(np.float64),
                            mode="wrap")
    np.testing.assert_allclose(got[0], wrap, atol=1e-5, rtol=0)


@pytest.mark.parametrize("legacy", [None, 7])
def test_add_awgn_equals_jax(legacy):
    img = np.random.default_rng(1).uniform(size=(8, 6, 3))
    got = tdeg.add_awgn(img, 0.05, np.random.default_rng(3), legacy_seed=legacy)
    ref = jdeg.add_awgn(img, 0.05, np.random.default_rng(3), legacy_seed=legacy)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("mode", range(8))
def test_augment_and_inverse_equal_jax(mode):
    x = np.arange(5 * 7 * 3).reshape(5, 7, 3)
    got = tim.augment(x, mode)
    np.testing.assert_array_equal(got, jim.augment(x, mode))
    np.testing.assert_array_equal(tim.augment_inverse(got, mode), x)
    np.testing.assert_array_equal(tim.augment_inverse(got, mode),
                                  jim.augment_inverse(jim.augment(x, mode), mode))


def test_ycbcr_equals_jax_and_leaves_input_alone():
    rng = np.random.default_rng(0)
    u8 = rng.integers(0, 256, (8, 9, 3)).astype(np.uint8)
    f32 = u8.astype(np.float32) / 255.0
    keep = f32.copy()
    for a in (u8, f32):
        np.testing.assert_array_equal(tim.rgb_to_ycbcr(a, only_y=False),
                                      jim.rgb_to_ycbcr(a, only_y=False))
        np.testing.assert_array_equal(tim.rgb_to_ycbcr(a), jim.rgb_to_ycbcr(a))
        ycc = tim.rgb_to_ycbcr(a, only_y=False)
        np.testing.assert_array_equal(tim.ycbcr_to_rgb(ycc), jim.ycbcr_to_rgb(ycc))
    np.testing.assert_array_equal(f32, keep)
    back = tim.ycbcr_to_rgb(tim.rgb_to_ycbcr(f32, only_y=False))
    np.testing.assert_allclose(back, f32, atol=1.5 / 255)


def test_weights_path_follows_jax_resolution(tmp_path):
    zoo = str(tmp_path)
    for name in ("tiny_demo32", "no_such_model"):
        assert tzoo.weights_path(name, zoo) == jzoo.weights_path(name, zoo)
    assert tzoo.weights_path("no_such_model", zoo) is None
    assert tzoo.weights_path("tiny_demo32", zoo).endswith(
        os.path.join("assets", "demo", "tiny_demo32.flax.npz"))
    npz = tmp_path / "tiny_demo32.flax.npz"
    npz.write_bytes(b"")
    assert tzoo.weights_path("tiny_demo32", zoo) == jzoo.weights_path("tiny_demo32", zoo) \
        == str(npz)
    pt = tmp_path / "tiny_demo32.pt"
    pt.write_bytes(b"")
    os.utime(npz, (1, 1))  # the checkpoint is newer than the cache
    assert tzoo.weights_path("tiny_demo32", zoo) == jzoo.weights_path("tiny_demo32", zoo) \
        == str(pt)


@pytest.mark.parametrize("respacing", [None, "ddim25", "10,5"])
def test_create_model_and_diffusion_matches_jax(respacing):
    zoo_dir = os.path.join(ROOT, "model_zoo")
    model, diff, tmap = tzoo.create_model_and_diffusion(
        "tiny_demo32", zoo_dir, timestep_respacing=respacing, device="cpu")
    _, _, jdiff, jmap = jzoo.create_model_and_diffusion(
        "tiny_demo32", zoo_dir, timestep_respacing=respacing)
    assert model.cfg == tzoo.TINY_TEST_CONFIG
    assert (tmap is None) == (jmap is None)
    if tmap is not None:
        np.testing.assert_array_equal(np.asarray(tmap), np.asarray(jmap))
    np.testing.assert_array_equal(np.asarray(diff.schedule.betas, np.float64),
                                  np.asarray(jdiff.schedule.betas, np.float64))
