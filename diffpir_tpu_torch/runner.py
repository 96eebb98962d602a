"""Evaluation runner: dataset -> degrade -> restore -> metrics -> artifacts.

Port of ``diffpir_tpu/runner.py`` for deblurring, super-resolution (blur,
cubic and classical) and inpainting in every trajectory mode
(``reference_sweep``, ``Runner.__init__``, ``_plan``, the restore function
at ``:226-313``, ``restore_batch``, ``evaluate``, ``evaluate_sweep`` and
``tune_operating_point``; reference ``main_ddpir.py:172-595``): DiffPIR,
repaint and vanilla with ``iter_num_U`` inner repeats and progress
snapshots, ``pred_x_prev`` (ancestral or DDIM), DPS_y0 and DPS_yt, and the
first-order prox of ``sub_1_analytic=false``.  ``lambda_`` and ``zeta`` may
be per-sample.  ``test_mode`` 1-4 wraps the UNet in ``inference.test_mode``
(pad, recursive split, x8 ensemble).  Metrics: batched PSNR on [-1,1] with
max_pixel=2, the reference's PSNR-Y composition, SSIM, and PSNR/SSIM over
inpainting holes.  Restored and degraded images, progress strips, the
inpainting mask, each deblurring PSF and the L|E|H montage of ``save_LEH``
are written as PNGs under ``results/<result_name>/`` when saving.
``calc_LPIPS`` and ``calc_FID`` score each batch with ``metrics.make_lpips``
and ``metrics.FidScorer`` on the runner's device (``lpips_weights``,
``fid_weights``).  ``evaluate`` dispatches batch i+1 before it fetches batch
i (``overlap_dispatch``).

The device mesh (``diffpir_tpu/runner.py:134-180, 388-431``): under a
``torch.distributed`` group of more than one rank, ``mesh_shape`` and
``mesh_axes`` build a mesh (``parallel/mesh.py``) of ``data`` (each data rank
restores its rows of the global batch, with its per-sample lambda and zeta;
the outputs are gathered), ``model`` (Megatron tensor parallelism,
``parallel/tp.py``) and ``space`` (the UNet splits the image height; the
trajectory state, proxes and resizers stay whole).  Every noise draw has the
global batch's shape from the same generator and is sliced to the rank's
rows, so a sharded trajectory sees the unsharded one's noise.
``lower_restore`` traces a restore on the ``meta`` device and reports this
rank's parameter bytes, activation peaks and collectives; ``dryrun_restore``
runs the JAX package's mesh dry run, its mesh-bundle stage included.
``prox_state``/``prox_from_state``, ``initial_x`` and ``wrap_test_mode``
are the pieces of a restore that ``export.py`` traces into a bundle's
programs.  DPS_y0 differentiates through the UNet under every mesh: the
collectives of the ``model`` and ``space`` axes carry gradients.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from diffpir_tpu_torch import inference, resolve_device
from diffpir_tpu_torch.config import TaskConfig
from diffpir_tpu_torch.data import Batch, make_batches, prepare_images
from diffpir_tpu_torch.diffusion import Diffusion, ModelMeanType, ModelVarType
from diffpir_tpu_torch.guidance import dps_sample, make_degrade_op, make_grad_prox
from diffpir_tpu_torch.models.zoo import model_config_for, resolve_model
from diffpir_tpu_torch.models.unet import UNet
from diffpir_tpu_torch.ops.fft_prox import ProxOperator, precompute
from diffpir_tpu_torch.parallel import collectives as coll
from diffpir_tpu_torch.parallel.mesh import abstract_mesh, make_mesh, shard_batch
from diffpir_tpu_torch.sampler import (diffpir_sample, generator_noise, init_x,
                                       make_cubic_sr_prox, make_denoiser,
                                       make_fft_prox, make_inpaint_prox, model_fn,
                                       xprev_sample)
from diffpir_tpu_torch.schedule import NoiseSchedule, build_plan, make_progress_slots
from diffpir_tpu_torch.utils import image as im

__all__ = ["Runner", "reference_sweep", "setup_logger", "overlap_dispatch",
           "dryrun_restore"]


def overlap_dispatch(items, dispatch, consume) -> None:
    """Dispatch item i+1 before consuming item i (``diffpir_tpu/runner.py:47-68``).

    ``dispatch(i, item) -> out`` must not wait for the device;
    ``consume(i, item, out, t_dispatch)`` fetches and post-processes, so the
    host's work on one batch overlaps the card's on the next."""
    pending = None
    for i, item in enumerate(items):
        t0 = time.perf_counter()
        out = dispatch(i, item)
        if pending is not None:
            consume(*pending)
        pending = (i, item, out, t0)
    if pending is not None:
        consume(*pending)


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


def leh_montage(batch: Batch, x0: np.ndarray, sf: int) -> np.ndarray:
    """The L|E|H montage of ``save_LEH`` (``diffpir_tpu/runner.py:572-589``;
    reference ``main_ddpir_sisr.py:440-451``): the observation upscaled by
    nearest neighbour to the output size, with the original observation in
    its top-left corner and the PSF (scaled to its maximum, 3x nearest) in
    its top-right corner, then the restoration and the ground truth."""
    nb = len(batch.names)
    L_up = np.repeat(np.repeat(batch.img_L[:nb], sf, axis=1), sf, axis=2).copy()
    hl, wl = batch.img_L.shape[1:3]
    for j in range(nb):
        k = batch.kernel[j]
        if k.size > 1:
            kv = np.repeat(np.repeat(k / max(k.max(), 1e-12), 3, axis=0), 3, axis=1)
            kh = min(kv.shape[0], L_up.shape[1])
            kw = min(kv.shape[1], L_up.shape[2])
            L_up[j, :kh, -kw:, :] = kv[:kh, :kw, None]
        L_up[j, :hl, :wl] = batch.img_L[j]
    gt = batch.img_H[:nb].astype(np.float32) / 255.0
    return np.concatenate([L_up, x0[:nb], gt], axis=2)


def _mesh_axes(cfg: TaskConfig) -> tuple:
    shape = None if cfg.mesh_shape is None else tuple(cfg.mesh_shape)
    if cfg.mesh_axes is not None:
        return tuple(cfg.mesh_axes)
    # 1-D = data parallelism, 2-D [D, M] = data x Megatron tensor parallelism
    return ("data",) if shape is None or len(shape) == 1 else ("data", "model")


class Runner:
    """Bind config + model once; restore batches / run full evaluations.

    ``device`` defaults to the card (raising when there is none); pass
    ``device="cpu"`` to run on the CPU.  ``kernels="plain"`` runs the UNet's
    GroupNorm and attention through their plain PyTorch versions, to compare
    them with the CUDA kernels.

    ``use_mesh``: under a process group of more than one rank, build the
    config's mesh (by default 1-D data parallelism over every rank); with no
    group, or a group of one, there is no mesh.  ``abstract_params=True``
    builds the model on the ``meta`` device, sharded under the config's mesh
    as rank 0 of it (no process group needed): nothing is allocated, and
    only ``lower_restore`` runs.
    """

    def __init__(self, cfg: TaskConfig, *, device: Optional[torch.device | str] = None,
                 kernels: str = "cuda", use_mesh: bool = True,
                 abstract_params: bool = False):
        self.cfg = cfg
        if abstract_params:
            self.device = torch.device("meta")
        else:
            self.device = (resolve_device(cpu=False) if device is None
                           else torch.device(device))
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
        self.mesh = None
        self.mesh_axes: tuple = ()
        world = dist.get_world_size() if dist.is_initialized() else 1
        if use_mesh and (world > 1 or (abstract_params and cfg.mesh_shape is not None)):
            axes = _mesh_axes(cfg)
            shape = None if cfg.mesh_shape is None else tuple(cfg.mesh_shape)
            self.mesh = (abstract_mesh(shape, axes) if abstract_params
                         else make_mesh(shape, axes))
            self.mesh_axes = axes
        if abstract_params:
            # the wrappers take no meta tensor: the plain versions give the
            # shapes
            with torch.device("meta"):
                self.model = UNet(model_config_for(cfg.model_name), dtype=self.dtype,
                                  kernels="plain")
            self.weights_provenance = "abstract"
        else:
            self.model, self.weights_provenance = resolve_model(
                cfg.model_name, cfg.model_zoo, dtype=self.dtype, device=self.device,
                kernels=kernels)
        if self.mesh is not None:
            if self.mesh.axis_size("model") > 1:
                # Megatron-style parameter sharding: the 553M flagship no
                # longer has to fit one card
                from diffpir_tpu_torch.parallel.tp import shard_unet_params

                shard_unet_params(self.model, self.mesh)
            self.model.set_mesh(self.mesh)
        self.den = make_denoiser(self.wrap_test_mode(self.model), self.schedule,
                                 compute_dtype=self.dtype)
        self.diffusion = Diffusion(self.schedule, ModelMeanType.EPSILON,
                                   ModelVarType.LEARNED_RANGE)

    def wrap_test_mode(self, model):
        """``model`` (the UNet, or a call of it on other parameters),
        wrapped in the reference's evaluation modes when ``test_mode`` asks
        (``diffpir_tpu/runner.py:184-201``): every call of a wrapped model
        runs at the first sample's timestep."""
        if not self.cfg.test_mode:
            return model
        mcfg = self.model.cfg
        depth_mod = 2 ** (len(mcfg.channel_mult) - 1)

        def wrapped(x, t):
            return inference.test_mode(
                lambda v: model(v, t[:1].expand(v.shape[0])), x, mode=self.cfg.test_mode,
                refield=32, min_size=mcfg.image_size, modulo=depth_mod)

        return wrapped

    def _plan(self, lambda_: float):
        # the cumulative sigma-bar weights rho only for pred_xstart with
        # DiffPIR; every other mode uses sigma_k = sqrt(beta/alpha)
        # (main_ddpir.py:279-284)
        cfg = self.cfg
        xstart = cfg.model_output_type == "pred_xstart" and cfg.generate_mode == "DiffPIR"
        return build_plan(
            self.schedule, iter_num=cfg.iter_num, skip_type=cfg.skip_type,
            lambda_=lambda_, eta=cfg.eta, sigma_y=cfg.sigma,
            t_start=self.t_start, noise_model_t=self.noise_model_t,
            rho_mode="xstart" if xstart else "xprev")

    def uses_fft_prox(self) -> bool:
        """Whether the task's prox is the FFT solve (deblur, sr blur and
        classical, with the analytic prox)."""
        cfg = self.cfg
        return (cfg.sub_1_analytic and cfg.task != "inpaint"
                and (cfg.task == "deblur" or cfg.sr_mode in ("blur", "classical")))

    def prox_state(self, y: torch.Tensor, kernel: Optional[torch.Tensor],
                   mask: torch.Tensor) -> tuple:
        """The tensors the task's data prox is built from
        (``prox_from_state``): the FFT solve's spectra (FB, FBC, F2B, FBFy),
        else the observations it reads: (y, mask) for the masked average,
        (y, kernel) for the first-order gradient step, (y,) for cubic
        back-projection."""
        cfg = self.cfg
        if cfg.task in ("deblur", "sr") and not cfg.sub_1_analytic:
            return (y, kernel)
        if cfg.task == "inpaint":
            return (y, mask)
        if self.uses_fft_prox():
            return tuple(precompute(y, kernel, cfg.sf)[:4])
        return (y,)

    def prox_from_state(self, state: tuple):
        """The task's data prox ``prox(x0, tau)`` from ``prox_state``'s
        tensors: the first-order gradient step (deblur and sr with
        ``sub_1_analytic=false``), the masked average (inpaint), the FFT
        solve (deblur, sr blur and classical) or cubic back-projection (sr
        cubic)."""
        cfg = self.cfg
        if cfg.task in ("deblur", "sr") and not cfg.sub_1_analytic:
            y, kernel = state
            hr_hw = (y.shape[1] * cfg.sf, y.shape[2] * cfg.sf)
            op = make_degrade_op(cfg.task, kernel=kernel, hr_hw=hr_hw, sf=cfg.sf)
            return make_grad_prox(op, y if cfg.task == "deblur" else 2.0 * y - 1.0)
        if cfg.task == "inpaint":
            return make_inpaint_prox(*state, cfg.guidance_scale)
        if self.uses_fft_prox():
            return make_fft_prox(ProxOperator(*state, sf=cfg.sf), cfg.guidance_scale)
        (y,) = state
        hr_hw = (y.shape[1] * cfg.sf, y.shape[2] * cfg.sf)
        return make_cubic_sr_prox(y, cfg.sf, gamma=cfg.gamma, in_iter=cfg.inIter,
                                  hr_hw=hr_hw)

    def make_prox(self, y: torch.Tensor, kernel: Optional[torch.Tensor],
                  mask: torch.Tensor):
        """The task's data prox ``prox(x0, tau)`` for the observations ``y``
        (``prox_from_state(prox_state(y, kernel, mask))``)."""
        return self.prox_from_state(self.prox_state(y, kernel, mask))

    def initial_x(self, y: torch.Tensor, mask: Optional[torch.Tensor], n0: torch.Tensor,
                  init: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x_{t_start} from the observations and the initial draw ``n0``
        (``sampler.init_x``); ``init``, where given, replaces the task's x
        init in [0,1] before it is diffused."""
        sa0 = float(self.schedule.sqrt_alphas_cumprod[self.t_start])
        s1m0 = float(np.sqrt(1 - self.schedule.alphas_cumprod[self.t_start]))
        if init is not None:
            return sa0 * (2.0 * init.float() - 1.0) + s1m0 * n0
        return init_x(self.cfg.task, y, mask, self.cfg.sf, n0, sqrt_acp_start=sa0,
                      sqrt_1m_acp_start=s1m0, ty=self.ty_scale)

    def restore(self, y: torch.Tensor, mask: torch.Tensor, lambda_, zeta,
                seed: int, noise=None, kernel: Optional[torch.Tensor] = None,
                init: Optional[torch.Tensor] = None):
        """Restore (B,h,w,C) observations ``y`` in [0,1] on the runner's
        device; returns (B,H,W,C) fp32 in [0,1] (H = h*sf), or ``(x, frames)``
        with ``log_process``.  ``lambda_`` and ``zeta`` are floats or
        per-sample (B,) values; with either per-sample, the plan is built at
        lambda 1 and rho scaled per sample, as in the JAX package.
        ``kernel`` is the (B,kh,kw) blur of deblur and sr blur/classical;
        ``init``, where given, replaces the task's x init in [0,1] before it
        is diffused to t_start (the shifted upscale of sr classical,
        ``main_ddpir_sisr.py:243-248``).  Noise comes from a
        ``torch.Generator`` seeded with ``seed`` unless ``noise`` is given
        (``sampler``; the initial draw is ``which="init"``).

        Under a mesh with a ``data`` axis, ``y`` (and every per-sample input)
        is the global batch: this rank restores its rows, with the global
        draws of ``noise`` sliced to them, and the result is gathered, so
        every rank returns the whole batch."""
        b = y.shape[0]
        if np.ndim(lambda_) == 1 or np.ndim(zeta) == 1:
            lambda_ = np.broadcast_to(np.asarray(lambda_, np.float32), (b,)).copy()
            zeta = np.broadcast_to(np.asarray(zeta, np.float32), (b,)).copy()
        if noise is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            noise = generator_noise(gen, self.device)
        mesh = self.mesh
        n_data = 1 if mesh is None else mesh.axis_size("data")
        if n_data == 1:
            return self._restore_rows(y, mask, lambda_, zeta, noise, kernel, init)
        if b % n_data:
            raise ValueError(f"a batch of {b} does not split over {n_data} data ranks; "
                             "pad it (data.make_batches(..., pad_to_batch=True))")
        global_noise = noise
        r, per = mesh.axis_index("data"), b // n_data

        def noise(i, u, which, shape):
            # the global batch's draw, this rank's rows of it
            return global_noise(i, u, which, (b,) + tuple(shape[1:]))[r * per:(r + 1) * per]

        rows = lambda a: None if a is None else shard_batch(a, mesh, "data")  # noqa: E731
        out = self._restore_rows(rows(y), rows(mask), rows(lambda_) if np.ndim(lambda_) else
                                 lambda_, rows(zeta) if np.ndim(zeta) else zeta, noise,
                                 rows(kernel), rows(init))
        if isinstance(out, tuple):  # (x, frames (slots, B, ...))
            return (coll.all_gather(out[0], mesh, "data", 0),
                    coll.all_gather(out[1], mesh, "data", 1))
        return coll.all_gather(out, mesh, "data", 0)

    def _restore_rows(self, y, mask, lambda_, zeta, noise, kernel, init):
        """``restore`` of the rows this rank holds (all of them without a
        ``data`` axis)."""
        cfg = self.cfg
        b, h, w, c = y.shape
        lam_scale = None
        if np.ndim(lambda_) == 1 or np.ndim(zeta) == 1:
            lam_scale = lambda_
            plan = self._plan(1.0)
        else:
            plan = self._plan(lambda_)
        up = cfg.sf if cfg.task == "sr" else 1
        n0 = noise(-1, 0, "init", (b, h * up, w * up, c))
        x = self.initial_x(y, mask, n0, init)
        inpaint = cfg.task == "inpaint"
        if cfg.model_output_type == "pred_x_prev":
            # inpaint: the masked average on the sampled x; deblur and sr: no
            # data term in this mode (main_ddpir.py:414)
            return xprev_sample(
                self.diffusion, model_fn(self.den), plan, x, noise=noise,
                ddim=cfg.ddim_sample, y=y if inpaint else None,
                mask=mask if inpaint else None, recover_known=cfg.recover_known,
                lam_scale=lam_scale)
        if cfg.generate_mode in ("DPS_y0", "DPS_yt"):
            op = make_degrade_op(cfg.task, kernel=kernel, hr_hw=(h * up, w * up),
                                 sf=cfg.sf)
            batch_sum = None
            if self.mesh is not None and self.mesh.axis_size("data") > 1:
                # DPS_y0's step is the gradient of the whole batch's residual
                # norm: its square is summed over the data ranks
                batch_sum = lambda v: coll.all_reduce_sum(v, self.mesh, "data")  # noqa: E731
            return dps_sample(self.diffusion, model_fn(self.den), op, plan, x,
                              noise=noise, mode=cfg.generate_mode, task=cfg.task,
                              y=y, lambda_=lambda_, batch_sum=batch_sum)
        slots = make_progress_slots(plan.n_steps) if cfg.log_process else None
        prox = self.make_prox(y, kernel, mask)
        with torch.no_grad():
            return diffpir_sample(
                self.den, prox, plan, x, noise=noise, zeta=zeta,
                iter_num_U=cfg.iter_num_U, generate_mode=cfg.generate_mode, y=y,
                mask=mask, recover_known=inpaint and cfg.recover_known,
                progress_slots=slots, lam_scale=lam_scale)

    def restore_batch(self, batch: Batch, lambda_=None, zeta=None, seed: int = 0,
                      fetch: bool = True):
        """Restore one batch; returns float [0,1] (B,H,W,C) numpy, or
        ``(x, frames)`` with ``log_process``.  ``lambda_``/``zeta`` may be
        per-sample sequences (see ``restore``).  ``fetch=False`` returns the
        tensors on the runner's device without waiting for the card."""
        if self.weights_provenance == "abstract":
            raise RuntimeError("Runner was built with abstract_params=True (no weights "
                               "materialised): only lower_restore() runs")
        lambda_ = self.cfg.lambda_ if lambda_ is None else lambda_
        zeta = self.cfg.zeta if zeta is None else zeta

        def dev(a):
            return None if a is None else torch.from_numpy(a).to(self.device)

        out = self.restore(dev(batch.img_L), dev(batch.mask), lambda_, zeta, seed,
                           kernel=dev(batch.kernel), init=dev(batch.init))
        if not fetch:
            return out
        if isinstance(out, tuple):
            return tuple(o.cpu().numpy() for o in out)
        return out.cpu().numpy()

    def evaluate(self, lambda_: Optional[float] = None,
                 zeta: Optional[float] = None,
                 paths: Optional[list[str]] = None,
                 save: Optional[bool] = None,
                 hole_metrics: bool = False) -> dict:
        """Test-set evaluation with the JAX package's metrics and logging.

        Batch ``bi`` draws its noise from seed ``cfg.seed + bi``; batch
        ``bi + 1`` is dispatched before batch ``bi`` is fetched and scored.
        ``hole_metrics=True`` (inpainting) adds ``psnr_hole``/``ssim_hole``:
        PSNR and SSIM over the masked-out (mask == 0) pixels only, which
        ``recover_known`` does not dilute.  Under a mesh every rank computes
        the metrics; only rank 0 logs and writes files, and a short last
        batch is padded to split over the data ranks."""
        cfg = self.cfg
        lambda_ = cfg.lambda_ if lambda_ is None else lambda_
        zeta = cfg.zeta if zeta is None else zeta
        save = (cfg.save_E or cfg.save_L) if save is None else save
        main = self.mesh is None or not dist.is_initialized() or dist.get_rank() == 0
        save = save and main
        lg = setup_logger(cfg.result_name,
                          os.path.join(cfg.E_path, cfg.result_name + ".log")
                          if save else None)
        if not main:
            lg = logging.getLogger(cfg.result_name + ".quiet")
            lg.disabled = True
        lg.info(f"eta:{cfg.eta}, zeta:{zeta}, lambda:{lambda_}, "
                f"guidance_scale:{cfg.guidance_scale}, device:{self.device}")

        np.random.seed(cfg.seed)
        items = prepare_images(cfg, paths)
        if not items:
            raise FileNotFoundError(
                f"no images found under {cfg.L_path!r} (testset_name="
                f"{cfg.testset_name!r})")
        batches = make_batches(items, cfg.batch_size, pad_to_batch=self.mesh is not None)
        lpips_fn = None
        if cfg.calc_LPIPS:
            from diffpir_tpu_torch.metrics import make_lpips

            lpips_fn = make_lpips(weights_path=cfg.lpips_weights, device=self.device)
        fid = None
        if cfg.calc_FID:
            # a set-level metric: pool3 features per batch, one Fréchet
            # distance at the end
            if not cfg.fid_weights:
                raise ValueError("calc_FID requires fid_weights (local "
                                 "InceptionV3 weights; metrics.FidScorer)")
            from diffpir_tpu_torch.metrics import FidScorer

            fid = FidScorer(cfg.fid_weights, device=self.device)

        psnrs, psnrs_y, ssims, lpipss, n_imgs = [], [], [], [], 0
        psnrs_hole, ssims_hole = [], []
        if save and cfg.task == "inpaint" and cfg.save_progressive_mask:
            im.imsave_batch(batches[0].mask, batches[0].names, cfg.E_path, "mask_")

        def consume(bi: int, batch: Batch, out, t0: float) -> None:
            """Fetch, score and save one dispatched batch."""
            nonlocal n_imgs
            frames = None
            if isinstance(out, tuple):  # (restored, progress frames)
                out, frames = out
                frames = frames.cpu().numpy()
            nb = len(batch.names)
            x0 = out.cpu().numpy()[:nb]
            if frames is not None:
                frames = frames[:, :nb]
            dt = time.perf_counter() - t0
            gt = batch.img_H[:nb].astype(np.float32) / 255.0
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
            if hole_metrics:
                hole = 1.0 - batch.mask[:nb, :, :, 0]  # (nb, H, W), 1 = hole
                ph = float(np.mean([
                    im.psnr_region(x0[j] * 2 - 1, gt[j] * 2 - 1, hole[j][:, :, None])
                    for j in range(nb)]))
                sh = float(np.mean([im.ssim(E_uint[j], batch.img_H[j], region=hole[j])
                                    for j in range(nb)]))
                psnrs_hole.append(ph * nb)
                ssims_hole.append(sh * nb)
                msg += f"; hole PSNR: {ph:.4f}dB SSIM: {sh:.4f}"
            if cfg.calc_SSIM:
                sv = float(np.mean([im.ssim(E_uint[j], batch.img_H[j])
                                    for j in range(nb)]))
                ssims.append(sv * nb)
                msg += f"; SSIM: {sv:.4f}"
            if lpips_fn is not None:
                lp = lpips_fn(x0 * 2 - 1, gt * 2 - 1)
                lpipss.append(lp * nb)
                msg += f"; LPIPS: {lp:.4f}"
            if fid is not None:
                fid.add(x0, gt)
            n_imgs += nb
            lg.info(msg + f" ({nb} imgs, {dt:.2f}s)")
            if save and frames is not None:
                # progress strip: the snapshots side by side
                # (reference main_ddpir_sisr.py:426-432)
                strips = np.concatenate(list(frames), axis=2)
                im.imsave_batch(strips, batch.names, cfg.E_path, "progress_")
            if save and cfg.save_E:
                im.imsave_batch(
                    x0, batch.names, cfg.E_path,
                    f"{cfg.model_name}_x{cfg.sf}_lambda{lambda_:.4f}_zeta{zeta:.4f}_")
            if save and cfg.save_L:
                im.imsave_batch(batch.img_L[:nb], batch.names, cfg.E_path,
                                f"LR_x{cfg.sf}_")
            if save and cfg.task == "deblur":
                # each image's PSF (main_ddpir_deblur.py:177: k * 255 * 200,
                # clipped by the uint8 save)
                for j in range(nb):
                    kv = np.clip(batch.kernel[j] * 255.0 * 200.0, 0, 255)
                    im.imsave(kv.round().astype(np.uint8),
                              os.path.join(cfg.E_path, f"motion_kernel_{batch.names[j]}"))
            if save and cfg.save_LEH:
                im.imsave_batch(leh_montage(batch, x0, cfg.sf), batch.names,
                                cfg.E_path, "LEH_")

        t_wall0 = time.perf_counter()
        overlap_dispatch(
            batches,
            lambda bi, b: self.restore_batch(b, lambda_, zeta, seed=cfg.seed + bi,
                                             fetch=False),
            consume)
        wall = time.perf_counter() - t_wall0

        results = {
            "psnr": sum(psnrs) / n_imgs,
            "psnr_y": sum(psnrs_y) / n_imgs if psnrs_y else None,
            "ssim": sum(ssims) / n_imgs if ssims else None,
            "lpips": sum(lpipss) / n_imgs if lpipss else None,
            "fid": fid.score() if fid is not None else None,
            "psnr_hole": sum(psnrs_hole) / n_imgs if psnrs_hole else None,
            "ssim_hole": sum(ssims_hole) / n_imgs if ssims_hole else None,
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
        if results["fid"] is not None:
            msg += f" | FID: {results['fid']:.2f}"
        if results["psnr_hole"] is not None:
            msg += (f" | hole PSNR: {results['psnr_hole']:.4f} dB "
                    f"SSIM: {results['ssim_hole']:.4f}")
        lg.info(msg + f" | {results['images_per_sec']:.3f} img/s")
        return results

    def evaluate_sweep(self, **kw) -> list[dict]:
        """``evaluate`` at each point of ``reference_sweep``."""
        return [self.evaluate(lambda_=l, zeta=z, **kw)
                for l, z in reference_sweep(self.cfg)]

    def tune_operating_point(self, points, *, batch: Optional[Batch] = None,
                             paths: Optional[list[str]] = None, index: int = 0,
                             indices=None, seed: Optional[int] = None) -> dict:
        """Score (lambda, zeta) candidates on one or more observations, one
        trajectory each (``diffpir_tpu/runner.py:626-720``).

        One observation is replicated ``len(points)`` times and restored with
        per-sample (lambda, zeta), so the whole grid is one batch.  With
        ``indices`` the same is done once per test image and candidates are
        ranked by their mean PSNR.  ``zeta=None`` in a point means the config's;
        ``batch`` (row 0 is the observation) replaces the test set; launch k
        draws from seed ``seed + k`` (default ``cfg.seed``), shared by all
        candidates.  Returns ``{"results": [...], "best": {...}, "output":
        (H,W,C)}``: per-candidate mean PSNR (and SSIM with ``calc_SSIM``) in
        input order, the best row, and its restore of the first image.
        """
        cfg = self.cfg
        pts = [(float(l), cfg.zeta if z is None else float(z)) for l, z in points]
        if not pts:
            raise ValueError("points must be non-empty")
        if batch is not None:
            if indices is not None:
                raise ValueError("pass either batch or indices, not both")
            batches = [batch]
        else:
            np.random.seed(cfg.seed)
            items = prepare_images(cfg, paths)
            idxs = list(indices) if indices is not None else [index]
            if not idxs:
                raise ValueError("indices must be non-empty (need at least one "
                                 "image to tune on)")
            for i in idxs:
                if i >= len(items):
                    raise IndexError(f"index {i} >= {len(items)} test images")
            batches = [make_batches([items[i]], 1)[0] for i in idxs]
        n = len(pts)
        if self.mesh is not None:
            d = self.mesh.axis_size("data")
            n = -(-n // d) * d  # rows padded to split over the data ranks
        lams = np.array([l for l, _ in pts] + [pts[-1][0]] * (n - len(pts)), np.float32)
        zets = np.array([z for _, z in pts] + [pts[-1][1]] * (n - len(pts)), np.float32)
        base_seed = cfg.seed if seed is None else seed
        psnr_acc = np.zeros(len(pts), np.float64)
        ssim_acc = np.zeros(len(pts), np.float64)
        first_out = None
        for k, b in enumerate(batches):
            rep = lambda a: None if a is None else np.repeat(a[:1], n, axis=0)
            grid = Batch(img_H=rep(b.img_H), img_L=rep(b.img_L), kernel=rep(b.kernel),
                         mask=rep(b.mask), names=[b.names[0]] * n, init=rep(b.init))
            out = self.restore_batch(grid, lambda_=lams, zeta=zets, seed=base_seed + k)
            if isinstance(out, tuple):  # drop progress frames
                out = out[0]
            if first_out is None:
                first_out = out
            gt = b.img_H[0].astype(np.float32) / 255.0
            for i in range(len(pts)):
                psnr_acc[i] += float(im.psnr_batch(out[i:i + 1] * 2 - 1, gt[None] * 2 - 1))
                if cfg.calc_SSIM:
                    ssim_acc[i] += float(im.ssim(im.single2uint(out[i]), b.img_H[0]))
        results = []
        for i, (lam, zet) in enumerate(pts):
            row = {"lambda_": lam, "zeta": zet, "psnr": float(psnr_acc[i] / len(batches))}
            if cfg.calc_SSIM:
                row["ssim"] = float(ssim_acc[i] / len(batches))
            results.append(row)
        best_i = int(np.argmax([r["psnr"] for r in results]))
        return {"results": results, "best": results[best_i], "output": first_out[best_i]}

    # ------------------------------------------------------------------
    def lower_restore(self, batch: int, height: int, width: int,
                      kernel_hw: tuple[int, int] = (1, 1)) -> dict:
        """Trace one whole restore on the ``meta`` device, allocating and
        computing nothing (``diffpir_tpu/runner.py:315-344`` lowers it; here
        the trace is the record).  Runs on a Runner built with
        ``abstract_params=True``, so the 553M flagship's dp x tp layout can be
        checked on any host.  ``height``/``width`` are the observation's size
        (for SR the low-resolution input).  Returns this rank's:

          * ``param_bytes``: bytes of its (sharded) parameters;
          * ``activation_peak_bytes``: per UNet level (0 = full resolution),
            the largest activation one of its layers produces;
          * ``nfe``: UNet forwards in the trajectory;
          * ``collectives_per_nfe``: per (op, axis) of one UNet forward,
            ``count`` and ``bytes`` this rank sends or receives;
          * ``collectives_outside_unet``: the same for the rest of the restore
            (the gather of the restored batch over ``data``).
        """
        if self.device.type != "meta":
            raise RuntimeError("lower_restore traces on the meta device: build the "
                               "Runner with abstract_params=True")
        cfg, model = self.cfg, self.model
        meta = dict(device="meta", dtype=torch.float32)
        y = torch.empty((batch, height, width, cfg.n_channels), **meta)
        log: list = []
        marks: list = []
        peaks: dict = {}
        hooks = [model.register_forward_pre_hook(lambda m, a: marks.append(len(log))),
                 model.register_forward_hook(lambda m, a, o: marks.append(len(log)))]
        full_h = None

        def record(m, a, o):
            if not torch.is_tensor(o) or o.ndim != 4 or full_h is None:
                return
            level = int(round(np.log2(full_h / o.shape[1])))
            peaks[level] = max(peaks.get(level, 0), o.numel() * o.element_size())

        def first_layer(m, a):
            nonlocal full_h
            full_h = a[0].shape[1]

        hooks.append(model.input_blocks_0_0.register_forward_pre_hook(first_layer))
        for name, m in model.named_children():
            if name.startswith(("input_blocks", "middle_block", "output_blocks", "out_")):
                hooks.append(m.register_forward_hook(record))
        if self.mesh is not None:
            self.mesh.log = log
        try:
            self.restore(y, torch.empty_like(y), cfg.lambda_, cfg.zeta, 0,
                         noise=lambda i, u, which, shape: torch.empty(shape, **meta),
                         kernel=torch.empty((batch,) + tuple(kernel_hw), **meta))
        finally:
            for h in hooks:
                h.remove()
            if self.mesh is not None:
                self.mesh.log = None

        def tally(entries):
            out: dict = {}
            for op, axis, nbytes in entries:
                row = out.setdefault(f"{op}/{axis}", {"op": op, "axis": axis,
                                                      "count": 0, "bytes": 0})
                row["count"] += 1
                row["bytes"] += nbytes
            return list(out.values())

        spans = list(zip(marks[0::2], marks[1::2]))
        inside = {i for a, b in spans for i in range(a, b)}
        return {
            "mesh": None if self.mesh is None else dict(self.mesh.shape),
            "param_bytes": sum(p.numel() * p.element_size() for p in model.parameters()),
            "activation_peak_bytes": dict(sorted(peaks.items())),
            "nfe": len(spans),
            "collectives_per_nfe": tally(log[spans[0][0]:spans[0][1]]) if spans else [],
            "collectives_outside_unet": tally(
                [e for i, e in enumerate(log) if i not in inside]),
        }


def _dryrun_batch(rng, n: int, h: int, task: str):
    k1 = np.zeros((7, 7), np.float32)
    k1[3, 3] = 1.0  # identity PSF: the shape of a real one, tame numerics
    img_H = rng.integers(0, 256, (n, h, h, 3)).astype(np.uint8)
    mask = np.ones(img_H.shape, np.float32)
    kernel = np.broadcast_to(k1, (n, 7, 7)).copy()
    if task == "inpaint":
        mask = (rng.uniform(size=img_H.shape) > 0.5).astype(np.float32)
        img_L = img_H.astype(np.float32) * mask / 255.0
        kernel = np.ones((n, 1, 1), np.float32)
    elif task == "deblur":
        img_L = img_H.astype(np.float32) / 255.0
    else:  # sr: the low-resolution observation, restored at H = h * sf
        img_L = (img_H.astype(np.float32) / 255.0)[:, ::2, ::2]
    return Batch(img_H=img_H, img_L=img_L.astype(np.float32), kernel=kernel, mask=mask,
                 names=[f"im{i}" for i in range(n)])


# The dry run's parity bar.  The JAX package holds its meshes to 5e-5, which
# its random init meets trivially: it zeroes out_conv, so the UNet returns 0.
# The port's random weights reach the output, and the first step (t = 999)
# multiplies the UNet's rounding by sqrt(1/alphabar - 1) = 156: reordered
# sums (and, on the CPU, a batch of 1 against one of 4) then differ by
# 1e-4 - 2e-4 after two steps.  A wrong row, draw or gather differs by O(1).
DRYRUN_ATOL = 5e-4


def dryrun_restore(n_devices: int, bundle: bool = False) -> None:
    """The JAX package's mesh dry run (``diffpir_tpu/runner.py:724-849``) on
    ``n_devices`` ranks: inpaint, deblur and SR restores of the tiny model
    under dp(n), each also under dp x tp (n/4 x 4) against dp; inpaint under
    dp x sp (n/2 x 2) and dp x tp x sp (n/4 x 2 x 2), against dp; then one
    ``RestorationService`` coalescing round.  Run inside a group of
    ``n_devices`` ranks, or with no group, when it starts one of gloo ranks
    on the CPU (``parallel.multihost.spawn``).  ``bundle=True`` adds the JAX
    dry run's mesh-bundle stage (``diffpir_tpu/runner.py:812-828``): the dp
    inpaint runner's bundle (``export.save_bundle``) loaded and run on the
    mesh, against the live runner at ``DRYRUN_ATOL``."""
    if not dist.is_initialized():
        from diffpir_tpu_torch.parallel.multihost import spawn

        spawn("diffpir_tpu_torch.runner:dryrun_restore", n_devices, [n_devices, bundle])
        return
    from diffpir_tpu_torch.config import load_config
    from diffpir_tpu_torch.parallel.multihost import rank_device

    world = dist.get_world_size()
    assert world == n_devices, f"need {n_devices} ranks, have {world}"
    say = print if dist.get_rank() == 0 else (lambda *a, **k: None)
    device = rank_device()
    rng = np.random.default_rng(0)
    H = 64

    def cfg_for(task, shape, axes=None):
        return load_config(None, overrides=dict(
            task=task, model_name="tiny_test", iter_num=2, iter_num_U=1,
            batch_size=n_devices, noise_level_img=0.0, seed=0, dtype="float32",
            save_L=False, save_E=False, mesh_shape=shape, mesh_axes=axes,
            **(dict(sf=2, sr_mode="blur") if task == "sr" else {})))

    for task in ("inpaint", "deblur", "sr"):
        batch = _dryrun_batch(rng, n_devices, H, task)
        runner = Runner(cfg_for(task, (n_devices,)), device=device)
        assert runner.mesh is not None, "mesh construction failed"
        out = runner.restore_batch(batch)
        assert out.shape == batch.img_H.shape, (out.shape, batch.img_H.shape)
        assert np.isfinite(out).all(), f"non-finite restore output ({task})"
        say(f"dryrun_restore: {task} dp({n_devices}): OK")
        meshes = []
        if n_devices % 4 == 0:
            meshes.append(((n_devices // 4, 4), ("data", "model")))
        if task == "inpaint" and n_devices % 2 == 0:
            meshes.append(((n_devices // 2, 2), ("data", "space")))
        if task == "inpaint" and n_devices % 8 == 0:
            meshes.append(((n_devices // 4, 2, 2), ("data", "model", "space")))
        for shape, axes in meshes:
            got = Runner(cfg_for(task, shape, axes), device=device).restore_batch(batch)
            np.testing.assert_allclose(got, out, rtol=0, atol=DRYRUN_ATOL)
            say(f"dryrun_restore: {task} {' x '.join(axes)}{shape}: OK (parity vs dp)")
        if task == "inpaint":
            inpaint = (cfg_for(task, (n_devices,)), runner, batch, out)

    cfg, runner, batch, out = inpaint
    if bundle:
        import shutil
        import tempfile

        from diffpir_tpu_torch.export import load_bundle, save_bundle

        # one directory for every rank: rank 0 makes it and tells the others
        where = [tempfile.mkdtemp(prefix="diffpir-bundle-") if dist.get_rank() == 0
                 else None]
        dist.broadcast_object_list(where, src=0, group=runner.mesh.host_group)
        try:
            path = save_bundle(runner, os.path.join(where[0], "bundle"), batch=n_devices,
                               height=H, width=H, platforms=(device.type,),
                               allow_random_weights=True)
            got = load_bundle(path, device=device)(batch.img_L, mask=batch.mask, seed=0)
            dist.barrier(group=runner.mesh.host_group)
        finally:
            if dist.get_rank() == 0:
                shutil.rmtree(where[0], ignore_errors=True)
        np.testing.assert_allclose(got, out, rtol=0, atol=DRYRUN_ATOL)
        say(f"dryrun_restore: mesh bundle({n_devices}): OK (parity vs runner)")
    from concurrent.futures import wait

    from diffpir_tpu_torch.serve import RestorationService

    svc = RestorationService(cfg, device=device, use_mesh=True, service_batch=n_devices,
                             max_wait_ms=200.0, allow_random_weights=True)
    try:
        futs = [svc.submit(batch.img_L[i], mask=batch.mask[i]) for i in range(n_devices)]
        wait(futs, timeout=600)
        outs = [f.result() for f in futs]
    finally:
        svc.close()
    assert all(np.isfinite(o).all() for o in outs)
    assert outs[0].shape == batch.img_L[0].shape
    say(f"dryrun_restore: serve coalescing({n_devices}): OK")
    say(f"dryrun_restore({n_devices}): OK (3-task dp + dp x tp + sp + dp x tp x sp"
        + (" + bundle" if bundle else "") + " + serve)")
