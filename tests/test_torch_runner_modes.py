"""The port's Runner and CLI in the other trajectory modes against the JAX
package's Runner: DPS_y0 deblurring and --tune's per-sample grid, both fed
JAX's draws (the port's generator noise is replaced by the draws the JAX
Runner makes from the same seed); the hole metrics; and what the port
saves for log_process and save_progressive_mask."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffpir_tpu import config as jconfig
from diffpir_tpu import data as jdata
from diffpir_tpu import runner as jrunner
from diffpir_tpu.utils import image as jim
from diffpir_tpu_torch import config as tconfig
from diffpir_tpu_torch import data as tdata
from diffpir_tpu_torch import runner as trunner
from diffpir_tpu_torch.main import main as tmain
from diffpir_tpu_torch.schedule import make_progress_slots
from diffpir_tpu_torch.utils import image as tim
from diffpir_tpu_torch.utils.png import read_png
from tests.test_torch_modes import jax_draws

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEBLUR = os.path.join(ROOT, "configs", "demo64_deblur.yaml")
INPAINT32 = os.path.join(ROOT, "configs", "demo32_inpaint.yaml")
TINY = dict(model_name="tiny_demo32", testset_name="demo32", cwd=ROOT, save_E=False,
            save_L=False)
ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def jax_runner_noise(generate_mode):
    """A stand-in for ``runner.generator_noise`` that returns the JAX
    Runner's draws for the generator's seed: the initial noise from the
    first half of ``split(PRNGKey(seed))``, the trajectory's from the second
    (``diffpir_tpu/runner.py:252``)."""

    def make(gen, device):
        k_init, k_samp = jax.random.split(jax.random.PRNGKey(gen.initial_seed()))
        steps = jax_draws(k_samp, generate_mode)

        def noise(i, u, which, shape):
            if which == "init":
                return torch.from_numpy(np.array(
                    jax.random.normal(k_init, shape, jnp.float32)))
            return steps(i, u, which, shape)

        return noise

    return make


def test_dps_y0_deblur_runner_matches_jax_runner(monkeypatch):
    """DPS_y0 from t = 999 on the tiny prior, three steps; the observation is
    noisy, so the trajectory does not start from a clean blur."""
    over = dict(TINY, generate_mode="DPS_y0", iter_num=4, noise_level_img=12.75)
    jcfg, tcfg = jconfig.load_config(DEBLUR, over), tconfig.load_config(DEBLUR, over)
    np.random.seed(jcfg.seed)
    batch = jdata.make_batches(jdata.prepare_images(jcfg), 2)[0]
    ref = jrunner.Runner(jcfg, use_mesh=False).restore_batch(batch, seed=5)
    monkeypatch.setattr(trunner, "generator_noise", jax_runner_noise("DPS_y0"))
    got = trunner.Runner(tcfg, device="cpu").restore_batch(batch, seed=5)
    assert got.shape == ref.shape == batch.img_H.shape
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


def test_cli_tune_ranks_like_the_jax_runner(monkeypatch, capsys):
    """--tune on two images: the same per-candidate PSNRs and the same best
    (lambda, zeta) as the JAX Runner's tune_operating_point."""
    grid = "0.3,1,4:0.5"
    pts = [(0.3, None), (1.0, None), (4.0, 0.5)]
    over = dict(iter_num=5, cwd=ROOT, save_E=False, save_L=False)
    jcfg = jconfig.load_config(INPAINT32, over)
    ref = jrunner.Runner(jcfg, use_mesh=False).tune_operating_point(
        pts, indices=range(0, 2))
    monkeypatch.setattr(trunner, "generator_noise", jax_runner_noise("DiffPIR"))
    argv = ["--opt", INPAINT32, "--cpu", "--tune", grid, "--tune-images", "2"]
    for k, v in over.items():
        argv += ["--set", f"{k}={str(v).lower() if isinstance(v, bool) else v}"]
    rows = tmain(argv)
    printed = capsys.readouterr().out
    assert [(r["lambda_"], r["zeta"]) for r in rows] == \
        [(r["lambda_"], r["zeta"]) for r in ref["results"]]
    np.testing.assert_allclose([r["psnr"] for r in rows],
                               [r["psnr"] for r in ref["results"]], atol=1e-2, rtol=0)
    np.testing.assert_allclose([r["ssim"] for r in rows],
                               [r["ssim"] for r in ref["results"]], atol=1e-3, rtol=0)
    best = max(rows, key=lambda r: r["psnr"])
    assert (best["lambda_"], best["zeta"]) == \
        (ref["best"]["lambda_"], ref["best"]["zeta"])
    assert f"best: lambda={best['lambda_']:g} zeta={best['zeta']:g}" in printed


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hole_metrics_match_jax(seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(-1, 1, size=(40, 36, 3)).astype(np.float32)
    b = np.clip(a + 0.05 * rng.standard_normal(a.shape), -1, 1).astype(np.float32)
    hole = np.zeros((40, 36), np.float32)
    hole[8:30, 5:25] = 1.0
    assert tim.psnr_region(a, b, hole[:, :, None]) == \
        jim.psnr_region(a, b, hole[:, :, None])
    ua, ub = tim.single2uint(a * 0.5 + 0.5), tim.single2uint(b * 0.5 + 0.5)
    assert tim.ssim(ua, ub, region=hole) == pytest.approx(
        jim.ssim(ua, ub, region=hole), abs=1e-12)
    assert np.isnan(tim.psnr_region(a, b, np.zeros((40, 36, 1))))


def test_evaluate_saves_progress_strips_and_the_mask(tmp_path):
    """log_process returns the frames and save writes them as one strip per
    image; save_progressive_mask writes the first batch's masks; the hole
    metrics are reported."""
    cfg = tconfig.load_config(INPAINT32, dict(iter_num=4, cwd=ROOT, log_process=True,
                                              save_progressive_mask=True,
                                              save_L=False))
    cfg.E_path = str(tmp_path)
    runner = trunner.Runner(cfg, device="cpu")
    res = runner.evaluate(save=True, hole_metrics=True)
    assert np.isfinite(res["psnr_hole"]) and 0.0 < res["ssim_hole"] <= 1.0
    assert res["psnr_hole"] < res["psnr"]  # recover_known pastes the rest
    saved = sorted(os.listdir(tmp_path))
    strips = [p for p in saved if p.startswith("progress_")]
    masks = [p for p in saved if p.startswith("mask_")]
    assert len(strips) == len(masks) == 4
    n_frames = int(make_progress_slots(4).max()) + 1
    assert read_png(str(tmp_path / strips[0])).shape == (32, 32 * n_frames, 3)


@pytest.mark.parametrize("opt", ["demo64_sisr.yaml", "demo64_deblur.yaml"])
def test_save_leh_montage_matches_jax(tmp_path, monkeypatch, opt):
    """save_LEH writes the JAX package's L|E|H montage (the observation
    upscaled with itself and the PSF inset, the restoration, the ground
    truth) for the same batches and outputs: the JAX Runner is handed the
    port's degraded images (the two resizers differ in the last float bit,
    which can move a saved pixel by one level) and each Runner's
    restore_batch is replaced by the same function of the batch."""
    path = os.path.join(ROOT, "configs", opt)
    over = dict(model_name="tiny_demo64", cwd=ROOT, save_LEH=True, save_E=False,
                save_L=False, iter_num=3, batch_size=2)
    images = sorted(os.path.join(ROOT, "testsets", "demo64", f)
                    for f in os.listdir(os.path.join(ROOT, "testsets", "demo64")))[:3]
    np.random.seed(0)
    items = tdata.prepare_images(tconfig.load_config(path, over), images)
    monkeypatch.setattr(jrunner, "prepare_images", lambda cfg, paths=None: items)
    saved = {}
    for side, config, runner_mod in (("jax", jconfig, jrunner), ("torch", tconfig, trunner)):
        cfg = config.load_config(path, over)
        cfg.E_path = str(tmp_path / side)
        sf = cfg.sf if cfg.task == "sr" else 1
        runner = (runner_mod.Runner(cfg, use_mesh=False) if side == "jax"
                  else runner_mod.Runner(cfg, device="cpu"))

        def restore_batch(batch, lambda_=None, zeta=None, seed=0, fetch=True, side=side,
                          sf=sf):
            up = np.repeat(np.repeat(batch.img_L, sf, axis=1), sf, axis=2)
            out = np.clip(0.8 * up + 0.1 + 0.01 * seed, 0.0, 1.0).astype(np.float32)
            return out if side == "jax" else torch.from_numpy(out)

        monkeypatch.setattr(runner, "restore_batch", restore_batch)
        runner.evaluate(paths=images, save=True)
        saved[side] = sorted(f for f in os.listdir(cfg.E_path)
                             if f.startswith(("LEH_", "motion_kernel_")))
        for name in saved[side]:  # 64-px outputs, three panels
            if name.startswith("LEH_"):
                assert read_png(os.path.join(cfg.E_path, name)).shape == (64, 192, 3)
    # deblur also writes each PSF, as the JAX package does
    assert saved["torch"] == saved["jax"]
    assert len(saved["jax"]) == (6 if "deblur" in opt else 3)
    for name in saved["jax"]:
        np.testing.assert_array_equal(read_png(str(tmp_path / "torch" / name)),
                                      read_png(str(tmp_path / "jax" / name)))
