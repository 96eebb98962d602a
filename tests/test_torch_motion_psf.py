"""The port's motion PSF (``diffpir_tpu_torch/ops/degrade.py::motion_psf``)
against the JAX package's, which rasterises with Pillow; the numpy copies of
Pillow's line, Gaussian blur and LANCZOS resize (``utils/raster.py``,
``utils/resample.py``) against Pillow; and the ``use_DIY_kernel`` +
``blur_mode: motion`` data path against ``diffpir_tpu.data``'s.  Every
comparison is bit for bit."""

import os

import numpy as np
import pytest
from PIL import Image, ImageDraw, ImageFilter

from diffpir_tpu import config as jconfig
from diffpir_tpu import data as jdata
from diffpir_tpu.ops.degrade import motion_psf as jax_motion_psf
from diffpir_tpu_torch import config as tconfig
from diffpir_tpu_torch import data as tdata
from diffpir_tpu_torch.ops.degrade import motion_psf
from diffpir_tpu_torch.utils import raster, resample

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEBLUR64 = os.path.join(ROOT, "configs", "demo64_deblur.yaml")
SEEDS = range(50)


@pytest.mark.parametrize("width", [0, 1, 2, 3, 5])
def test_draw_line_is_pillows(width):
    rng = np.random.default_rng(width)
    for _ in range(60):
        size = int(rng.integers(20, 120))
        pts = [tuple(p) for p in rng.uniform(-10, size + 10, (int(rng.integers(1, 12)), 2))]
        img = Image.new("L", (size, size))
        ImageDraw.Draw(img).line(pts, fill=255, width=width)
        canvas = np.zeros((size, size), np.uint8)
        raster.draw_line(canvas, pts, width)
        np.testing.assert_array_equal(canvas, np.asarray(img))


@pytest.mark.parametrize("radius", [0, 1, 1.5, 2, 3, 4, 7, 10])
def test_gaussian_blur_is_pillows(radius):
    rng = np.random.default_rng(int(radius * 10))
    for _ in range(12):
        h, w = rng.integers(5, 60, 2)
        img = rng.integers(0, 256, (h, w)).astype(np.uint8)
        want = np.asarray(Image.fromarray(img).filter(ImageFilter.GaussianBlur(radius)))
        np.testing.assert_array_equal(raster.gaussian_blur(img, radius), want)


@pytest.mark.parametrize("mode,pil", [(resample.LANCZOS, Image.LANCZOS),
                                      (resample.BICUBIC, Image.BICUBIC),
                                      (resample.BOX, Image.BOX)])
def test_resize_is_pillows(mode, pil):
    rng = np.random.default_rng(7)
    for i in range(20):
        h, w = rng.integers(4, 240, 2)
        oh, ow = (int(v) for v in rng.integers(2, 130, 2))
        img = rng.integers(0, 256, (h, w, 3) if i % 2 else (h, w)).astype(np.uint8)
        want = np.asarray(Image.fromarray(img).resize((ow, oh), resample=pil))
        np.testing.assert_array_equal(resample.resize(img, (ow, oh), mode), want)


@pytest.mark.parametrize("kernel_size", [21, 31, 61, 111])
@pytest.mark.parametrize("intensity", [0.0, 0.5, 1.0])
def test_motion_psf_is_the_jax_packages(kernel_size, intensity):
    """Line widths 0 (21, 31), 1 (61) and 2 (111: Pillow's polygon), blur
    radii 0, 1 and 3: the PSF equals JAX's bit for bit on every seed."""
    for seed in SEEDS:
        want = jax_motion_psf(kernel_size, intensity, np.random.default_rng(seed))
        got = motion_psf(kernel_size, intensity, np.random.default_rng(seed))
        assert got.dtype == want.dtype and got.shape == (kernel_size, kernel_size)
        np.testing.assert_array_equal(got, want, err_msg=f"seed {seed}")


def test_motion_deblur_data_path_is_the_jax_packages():
    over = dict(use_DIY_kernel=True, blur_mode="motion", cwd=ROOT)
    jcfg, tcfg = jconfig.load_config(DEBLUR64, over), tconfig.load_config(DEBLUR64, over)
    np.random.seed(jcfg.seed)
    want = jdata.prepare_images(jcfg)
    np.random.seed(tcfg.seed)
    got = tdata.prepare_images(tcfg)
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            if isinstance(w[k], np.ndarray):
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    assert not np.array_equal(got[0]["kernel"], got[1]["kernel"])  # a PSF per image


def test_motion_deblur_restore_matches_the_jax_runner(monkeypatch):
    """The motion-deblur restore on the tiny prior (4 NFE), the port fed the
    JAX Runner's draws: the same images, and PSNR within 0.05 dB."""
    import torch

    from diffpir_tpu import runner as jrunner
    from diffpir_tpu.utils import image as jim
    from diffpir_tpu_torch import runner as trunner
    from tests.test_torch_runner_modes import jax_runner_noise

    over = dict(use_DIY_kernel=True, blur_mode="motion", model_name="tiny_demo32",
                testset_name="demo32", iter_num=4, cwd=ROOT, save_E=False, save_L=False)
    jcfg, tcfg = jconfig.load_config(DEBLUR64, over), tconfig.load_config(DEBLUR64, over)
    np.random.seed(jcfg.seed)
    batch = jdata.make_batches(jdata.prepare_images(jcfg), 4)[0]
    ref = jrunner.Runner(jcfg, use_mesh=False).restore_batch(batch, seed=jcfg.seed)
    monkeypatch.setattr(trunner, "generator_noise", jax_runner_noise("DiffPIR"))
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    try:
        got = trunner.Runner(tcfg, device="cpu").restore_batch(batch, seed=tcfg.seed)
    finally:
        torch.set_num_threads(n)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)
    gt = batch.img_H.astype(np.float32) / 255.0
    assert abs(jim.psnr_batch(got * 2 - 1, gt * 2 - 1)
               - jim.psnr_batch(ref * 2 - 1, gt * 2 - 1)) <= 0.05
