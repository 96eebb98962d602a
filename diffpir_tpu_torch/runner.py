"""Evaluation runner: dataset -> degrade -> restore -> metrics -> artifacts.

Port of the DiffPIR-mode path of ``diffpir_tpu/runner.py`` for deblurring,
super-resolution (blur, cubic and classical) and inpainting
(``reference_sweep``, ``Runner.__init__``, ``_plan``, the restore function
at ``:226-313``, ``restore_batch``, ``evaluate`` and ``evaluate_sweep``;
reference ``main_ddpir.py:172-595``).  Metrics: batched PSNR on [-1,1] with
max_pixel=2, the reference's PSNR-Y composition and SSIM.  Restored and
degraded images are written as PNGs under ``results/<result_name>/`` when
``save_E``/``save_L`` are set.  The device mesh, AOT export, guidance and the
other trajectory modes are not ported yet.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Optional

import numpy as np
import torch

from diffpir_tpu_torch import resolve_device
from diffpir_tpu_torch.config import TaskConfig
from diffpir_tpu_torch.data import Batch, make_batches, prepare_images
from diffpir_tpu_torch.models.zoo import resolve_model
from diffpir_tpu_torch.ops.fft_prox import precompute
from diffpir_tpu_torch.sampler import (diffpir_sample, generator_noise, init_x,
                                       make_cubic_sr_prox, make_denoiser,
                                       make_fft_prox, make_inpaint_prox)
from diffpir_tpu_torch.schedule import NoiseSchedule, build_plan
from diffpir_tpu_torch.utils import image as im

__all__ = ["Runner", "reference_sweep", "setup_logger"]


def setup_logger(name: str, log_path: Optional[str] = None) -> logging.Logger:
    """File+stream logger (reference ``utils/utils_logger.py:26-45``)."""
    lg = logging.getLogger(name)
    fmt = logging.Formatter("%(asctime)s.%(msecs)03d : %(message)s", "%y-%m-%d %H:%M:%S")
    if log_path:
        have = {getattr(h, "baseFilename", None) for h in lg.handlers}
        if os.path.abspath(log_path) not in have:
            os.makedirs(os.path.dirname(log_path), exist_ok=True)
            fh = logging.FileHandler(log_path, "a")
            fh.setFormatter(fmt)
            lg.addHandler(fh)
    if any(type(h) is logging.StreamHandler for h in lg.handlers):
        return lg
    lg.setLevel(logging.INFO)
    lg.propagate = False
    sh = logging.StreamHandler()
    sh.setFormatter(fmt)
    lg.addHandler(sh)
    return lg


def reference_sweep(cfg: TaskConfig) -> list[tuple[float, float]]:
    """(lambda, zeta) settings the reference's main() runs
    (``main_ddpir.py:548-580``): SR sweeps lambda over {2..12}*lambda,
    deblur runs at (7*lambda, 3*zeta), inpaint at (lambda, zeta)."""
    if cfg.task == "sr":
        return [(cfg.lambda_ * i, cfg.zeta) for i in range(2, 13)]
    if cfg.task == "deblur":
        return [(cfg.lambda_ * 7, cfg.zeta * 3)]
    return [(cfg.lambda_, cfg.zeta)]


def _check_supported(cfg: TaskConfig) -> None:
    unported = []
    if cfg.task in ("deblur", "sr") and not cfg.sub_1_analytic:
        unported.append("sub_1_analytic=False (guidance)")
    if cfg.task == "deblur" and cfg.use_DIY_kernel and cfg.blur_mode != "Gaussian":
        unported.append(f"use_DIY_kernel with blur_mode={cfg.blur_mode!r}")
    if cfg.generate_mode != "DiffPIR":
        unported.append(f"generate_mode={cfg.generate_mode!r}")
    if cfg.model_output_type != "pred_xstart":
        unported.append(f"model_output_type={cfg.model_output_type!r}")
    if cfg.iter_num_U != 1:
        unported.append(f"iter_num_U={cfg.iter_num_U}")
    if cfg.test_mode:
        unported.append(f"test_mode={cfg.test_mode}")
    if cfg.log_process:
        unported.append("log_process")
    if cfg.mesh_shape is not None:
        unported.append("mesh_shape")
    for flag in ("calc_LPIPS", "calc_FID", "save_LEH", "save_progressive_mask"):
        if getattr(cfg, flag):
            unported.append(flag)
    if unported:
        raise NotImplementedError(
            "not ported to diffpir_tpu_torch yet (ROADMAP.md queue A): "
            + ", ".join(unported))


class Runner:
    """Bind config + model once; restore batches / run full evaluations.

    ``device`` defaults to the card (raising when there is none); pass
    ``device="cpu"`` to run on the CPU.  ``kernels="plain"`` runs the UNet's
    GroupNorm and attention through their plain PyTorch versions, to compare
    them with the CUDA kernels.
    """

    def __init__(self, cfg: TaskConfig, *, device: Optional[torch.device | str] = None,
                 kernels: str = "cuda"):
        _check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(cpu=False) if device is None else torch.device(device)
        self.schedule = NoiseSchedule.linear(
            cfg.beta_start, cfg.beta_end, cfg.num_train_timesteps)
        sigma_start = cfg.t_start_sigma
        self.t_start = (cfg.num_train_timesteps - 1 if sigma_start is None
                        else self.schedule.sigma_to_t(sigma_start))
        self.noise_model_t = (
            self.schedule.sigma_to_t(2 * cfg.noise_level_model)
            if cfg.skip_noise_model_t else 0)
        # deblur t_y init: y is taken as already noised to t_y
        # (main_ddpir_deblur.py:227-231; see sampler.init_x)
        self.ty_scale = None
        if cfg.task == "deblur" and cfg.ty_init:
            t_y = self.schedule.sigma_to_t(2 * cfg.noise_level_img)
            self.ty_scale = (
                float(self.schedule.sqrt_alphas_cumprod[t_y]),
                float(np.sqrt(1 - self.schedule.alphas_cumprod[t_y])))

        self.dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
        if self.device.type == "cuda" and self.dtype == torch.float32:
            # fp32 means fp32, as the JAX package's Precision.HIGHEST: cuDNN
            # would otherwise run fp32 convolutions in TF32
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        self.model, self.weights_provenance = resolve_model(
            cfg.model_name, cfg.model_zoo, dtype=self.dtype, device=self.device,
            kernels=kernels)
        self.den = make_denoiser(self.model, self.schedule, compute_dtype=self.dtype)

    def _plan(self, lambda_: float):
        return build_plan(
            self.schedule, iter_num=self.cfg.iter_num, skip_type=self.cfg.skip_type,
            lambda_=lambda_, eta=self.cfg.eta, sigma_y=self.cfg.sigma,
            t_start=self.t_start, noise_model_t=self.noise_model_t,
            rho_mode="xstart")

    def make_prox(self, y: torch.Tensor, kernel: Optional[torch.Tensor],
                  mask: torch.Tensor):
        """The task's data prox ``prox(x0, tau)`` for the observations ``y``:
        the masked average (inpaint), the FFT solve (deblur, sr blur and
        classical) or cubic back-projection (sr cubic)."""
        cfg = self.cfg
        if cfg.task == "inpaint":
            return make_inpaint_prox(y, mask, cfg.guidance_scale)
        if cfg.task == "deblur" or cfg.sr_mode in ("blur", "classical"):
            return make_fft_prox(precompute(y, kernel, cfg.sf), cfg.guidance_scale)
        hr_hw = (y.shape[1] * cfg.sf, y.shape[2] * cfg.sf)
        return make_cubic_sr_prox(y, cfg.sf, gamma=cfg.gamma, in_iter=cfg.inIter,
                                  hr_hw=hr_hw)

    def restore(self, y: torch.Tensor, mask: torch.Tensor, lambda_: float,
                zeta: float, seed: int, noise=None,
                kernel: Optional[torch.Tensor] = None,
                init: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Restore (B,h,w,C) observations ``y`` in [0,1] on the runner's
        device; returns (B,H,W,C) fp32 in [0,1] (H = h*sf).  ``kernel`` is the
        (B,kh,kw) blur of deblur and sr blur/classical; ``init``, where given,
        replaces the task's x init in [0,1] before it is diffused to t_start
        (the shifted upscale of sr classical, ``main_ddpir_sisr.py:243-248``).
        Noise comes from a ``torch.Generator`` seeded with ``seed`` unless
        ``noise`` is given (``sampler.diffpir_sample``; its initial draw is
        ``which="init"``)."""
        cfg = self.cfg
        plan = self._plan(lambda_)
        if noise is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            noise = generator_noise(gen, self.device)
        sa0 = float(self.schedule.sqrt_alphas_cumprod[self.t_start])
        s1m0 = float(np.sqrt(1 - self.schedule.alphas_cumprod[self.t_start]))
        b, h, w, c = y.shape
        up = cfg.sf if cfg.task == "sr" else 1
        n0 = noise(-1, 0, "init", (b, h * up, w * up, c))
        if init is not None:
            x = sa0 * (2.0 * init.float() - 1.0) + s1m0 * n0
        else:
            x = init_x(cfg.task, y, mask, cfg.sf, n0, sqrt_acp_start=sa0,
                       sqrt_1m_acp_start=s1m0, ty=self.ty_scale)
        inpaint = cfg.task == "inpaint"
        return diffpir_sample(self.den, self.make_prox(y, kernel, mask), plan, x,
                              noise=noise, zeta=zeta, y=y, mask=mask,
                              recover_known=inpaint and cfg.recover_known)

    def restore_batch(self, batch: Batch, lambda_: Optional[float] = None,
                      zeta: Optional[float] = None, seed: int = 0) -> np.ndarray:
        """Restore one batch; returns float [0,1] (B,H,W,C) numpy."""
        lambda_ = self.cfg.lambda_ if lambda_ is None else lambda_
        zeta = self.cfg.zeta if zeta is None else zeta

        def dev(a):
            return None if a is None else torch.from_numpy(a).to(self.device)

        out = self.restore(dev(batch.img_L), dev(batch.mask), lambda_, zeta, seed,
                           kernel=dev(batch.kernel), init=dev(batch.init))
        return out.cpu().numpy()

    def evaluate(self, lambda_: Optional[float] = None,
                 zeta: Optional[float] = None,
                 paths: Optional[list[str]] = None,
                 save: Optional[bool] = None) -> dict:
        """Test-set evaluation with the JAX package's metrics and logging.

        Batch ``bi`` draws its noise from seed ``cfg.seed + bi``."""
        cfg = self.cfg
        lambda_ = cfg.lambda_ if lambda_ is None else lambda_
        zeta = cfg.zeta if zeta is None else zeta
        save = (cfg.save_E or cfg.save_L) if save is None else save
        lg = setup_logger(cfg.result_name,
                          os.path.join(cfg.E_path, cfg.result_name + ".log")
                          if save else None)
        lg.info(f"eta:{cfg.eta}, zeta:{zeta}, lambda:{lambda_}, "
                f"guidance_scale:{cfg.guidance_scale}, device:{self.device}")

        np.random.seed(cfg.seed)
        items = prepare_images(cfg, paths)
        if not items:
            raise FileNotFoundError(
                f"no images found under {cfg.L_path!r} (testset_name="
                f"{cfg.testset_name!r})")
        batches = make_batches(items, cfg.batch_size)

        psnrs, psnrs_y, ssims, n_imgs = [], [], [], 0
        t_wall0 = time.perf_counter()
        for bi, batch in enumerate(batches):
            t0 = time.perf_counter()
            x0 = self.restore_batch(batch, lambda_, zeta, seed=cfg.seed + bi)
            dt = time.perf_counter() - t0
            nb = len(batch.names)
            gt = batch.img_H.astype(np.float32) / 255.0
            psnr = im.psnr_batch(x0 * 2 - 1, gt * 2 - 1)
            psnrs.append(psnr * nb)
            E_uint = im.single2uint(x0)
            if cfg.n_channels == 3:
                if cfg.psnr_y_mode == "true":
                    psnr_y = float(np.mean([
                        im.psnr(im.rgb_to_y(E_uint[j]), im.rgb_to_y(batch.img_H[j]))
                        for j in range(nb)]))
                else:
                    # the reference's PSNR-Y: a 3-channel tensor whose Cb/Cr
                    # are zeros (utils_image.py:482-484)
                    def y3(v):
                        yc = im.rgb_to_y_batch(v)
                        return np.concatenate([yc, np.zeros_like(yc),
                                               np.zeros_like(yc)], axis=-1)

                    psnr_y = im.psnr_batch(y3(x0 * 2 - 1), y3(gt * 2 - 1))
                psnrs_y.append(psnr_y * nb)
            msg = f"batch{bi + 1:->4d}--> PSNR: {psnr:.4f}dB"
            if cfg.calc_SSIM:
                sv = float(np.mean([im.ssim(E_uint[j], batch.img_H[j])
                                    for j in range(nb)]))
                ssims.append(sv * nb)
                msg += f"; SSIM: {sv:.4f}"
            n_imgs += nb
            lg.info(msg + f" ({nb} imgs, {dt:.2f}s)")
            if save and cfg.save_E:
                im.imsave_batch(
                    x0, batch.names, cfg.E_path,
                    f"{cfg.model_name}_x{cfg.sf}_lambda{lambda_:.4f}_zeta{zeta:.4f}_")
            if save and cfg.save_L:
                im.imsave_batch(batch.img_L, batch.names, cfg.E_path,
                                f"LR_x{cfg.sf}_")
        wall = time.perf_counter() - t_wall0

        results = {
            "psnr": sum(psnrs) / n_imgs,
            "psnr_y": sum(psnrs_y) / n_imgs if psnrs_y else None,
            "ssim": sum(ssims) / n_imgs if ssims else None,
            "n_images": n_imgs,
            "images_per_sec": n_imgs / wall if wall > 0 else 0.0,
            "lambda_": lambda_, "zeta": zeta,
            "device": str(self.device),
            "weights": self.weights_provenance,
        }
        msg = (f"-----------> Average PSNR(RGB) of ({cfg.testset_name}): "
               f"{results['psnr']:.4f} dB")
        if results["ssim"] is not None:
            msg += f" | SSIM: {results['ssim']:.4f}"
        lg.info(msg + f" | {results['images_per_sec']:.3f} img/s")
        return results

    def evaluate_sweep(self, **kw) -> list[dict]:
        """``evaluate`` at each point of ``reference_sweep``."""
        return [self.evaluate(lambda_=l, zeta=z, **kw)
                for l, z in reference_sweep(self.cfg)]
