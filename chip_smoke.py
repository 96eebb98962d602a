#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``diffpir_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --kernels-only [--package-root DIR]
    python3 chip_smoke.py --only export,parallel,formats

Phases, each announced by a flushed ``phase <name> start`` line and closed by
``phase <name> done <seconds>s``:

  preflight  versions, nvcc, the card; the port imports no JAX, Flax, optax,
             orbax, PyYAML, Pillow or diffpir_tpu; fp32 convolutions and
             matmuls in full fp32
  build      nvcc builds the kernels from diffpir_tpu_torch/kernels/csrc;
             ptxas must report no spills
  kernels    every CUDA kernel against its plain PyTorch version on the card,
             at every shape six paths give it: demo32 (tiny_demo32, heads of
             16), demo64 and DEMO256 (below) in fp32 and bf16, and, in bf16
             alone (fp32 copies of their 0.5 GB cases would double the
             phase), the diffusion_ffhq_10m topology (batch 16, 256 px,
             seeded random weights: bench.py's workload) and
             256x256_diffusion_uncond (553M, batch 1, 256 px: attention at
             T = 1024 with 8 heads of 64 and at T = 256 and 64 with 16 heads,
             GroupNorm up to C = 2048) and the same model under num_heads 4,
             num_head_channels -1 (UNCOND_4HEADS: heads of 128 and 256
             channels, batch 1 and 8, and its attention in fp32 at batch 1:
             (1, 1024, 4 x 128), (1, 256, 4 x 256), (1, 64, 4 x 256), all on
             attn_f32_any), and the train step's DEMO256 at batch
             16, and guided-diffusion's 256x256 classifier (batch 8, bf16,
             its out_norm fp32; the spatial_v2 head's (8, 1, 1, 2048)
             GroupNorm in both types); every head width of the generic
             attention kernel (GENERIC_WIDTHS at T = 64, 256 and 1024, and
             ODD_WIDTH_CASES), heads wider than 256 (WIDE_CASES) in fp32 and
             bf16, more (batch, head) pairs than a grid's y holds
             (PAIRS_CASE), and the sharded GroupNorm's two launches
             (partial statistics, apply) at a space rank's shards of DEMO256
             (bf16) and demo64 (fp32).  Each attention line names the
             variant that ran (kernels/attention.py attention_plan: tuned,
             bf16_any, f32_any or f32_wide, its rows, slices and key splits).
             Each case is run twice and
             must repeat bit for bit; the fp32 high-mean, low-variance GroupNorm input is held
             to the plain version at 1e-3.  Kernel, plain and library-call
             times in two columns: "device", 20 calls captured in a CUDA
             graph and replayed between CUDA events (no host dispatch), and
             "dispatch", 20 back-to-back Python calls between CUDA events
             (the wrapper's host cost included where it exceeds the card's).
             bound_ms: bytes at 3.35 TB/s or operations at the type's peak
             (bf16 989 TFLOP/s; fp32 GroupNorm 67 on CUDA cores; fp32
             attention 495 / 3, the rate of fp32-accurate products as three
             TF32 products, which attn_f32_any's split-TF32 design uses; its
             CUDA-core figure is printed beside it)
  main       the CLI path, ``diffpir_tpu_torch.main.main`` on
             configs/demo64_inpaint.yaml (trained demo64_hq prior, fp32, 4
             images, 50 NFE): PSNR against the JAX package's, launch counts,
             and the same restore with the plain versions
  formats    image decoding without Pillow: every file of
             testsets/demo64_formats (the demo64 images as baseline,
             progressive and gray JPEG, palette, 16-bit and interlaced PNG,
             BMP, PPM, GIF and LZW TIFF, and a 500x375 4:2:0 JPEG) decoded by
             diffpir_tpu_torch/utils/imageio.py to RGB and gray, each equal
             to the sha256 of Pillow's conversion committed in digests.json;
             the 500x375 JPEG's host decode ms (median of 5); the demo64
             inpaint CLI on the baseline JPEG test set at FORMATS_ITER steps,
             within PSNR_TOL_DB of the JAX package's CPU PSNR of the same run,
             with its launch counts
  tasks      the CLI on each path of TASK_RUNS: demo64 deblur (Levin09
             k0, and a DIY motion PSF per image), demo64 SR x2 in the blur, classical and cubic modes, demo32
             inpaint (heads of 16), and the 54M trained prior's demo256
             deblur, SR x4 and inpaint at 100 NFE in bf16; then every other
             trajectory mode: demo64 inpaint repaint, vanilla, iter_num_U=2,
             pred_x_prev with DDIM and log_process, demo64 deblur DPS_y0,
             DPS_yt and the first-order prox, demo64 SR's first-order prox,
             and demo256 (20 NFE) deblur DPS_y0, inpaint repaint with
             iter_num_U=2 and inpaint pred_x_prev.  Each must load the
             trained weights, come within PSNR_TOL_DB of the JAX package's
             PSNR (a mean over seeds where one seed's PSNR moves by more),
             launch the kernels per forward times the mode's forwards, enter
             the autograd.Functions exactly where the mode differentiates
             through the UNet (DPS_y0) and nowhere else, and come within
             PLAIN_PSNR_TOL_DB of a rerun with the plain versions; one more
             run times ms per NFE with the prox's share (CUDA events around
             each prox call) and checks log_process's frames.  The first
             seed runs through the CLI, the others through one Runner (the
             CLI's Runner.evaluate without reloading the weights)
  grad       one DPS_y0 step, d||y - H(x0(x))||/dx, on demo64 (fp32) and
             demo256 (bf16, batch 4) through the kernels' autograd.Functions
             against the same gradient through the plain versions (relative
             L2 and cosine), and a control with GroupNorm and attention
             detached that must fail the same bounds; in bf16 both routes'
             distance to the fp32 gradient (printed); event times of the
             forward alone and of the forward and backward
  flagship   the DEMO256 topology (bf16, 256 px, batch 4, 20 NFE, seeded
             random weights) on testsets/demo256 with a 50% random mask,
             kernels against plain versions, ms per NFE
  serve      the port's HTTP server (diffpir_tpu_torch.server_http) on
             127.0.0.1 over a RestorationService of
             configs/demo256_inpaint.yaml (trained 54M prior, bf16, 100 NFE,
             service batch 4, max_wait 2000 ms), whose worker thread launches
             the kernels: four concurrent npz requests (the testsets/demo256
             observations) must come back 200, finite, within PSNR_TOL_DB of
             the JAX package's PSNR, as one coalesced batch (launches = the
             forwards times the kernels per forward); service.restore must
             equal runner.restore_batch on the batch it built (1e-6); a
             non-binary mask gets 400 and the next request, a 250x240 PNG,
             gets a 250x240 PNG; a second service (configs/demo256_deblur.yaml,
             20 NFE) takes a Levin09 PSF of 19x19, padded to 24x24; demo256's
             weights through a guided-diffusion state dict (torch.save and
             torch.load(weights_only=True) in memory) give the same forward;
             seeded random weights of 256x256_diffusion_uncond (553M) in
             guided-diffusion's layout, converted, run one bf16 forward
             through the kernels within FLAGSHIP_FORWARD_REL_TOL of the
             plain versions, and again under UNCOND_4HEADS (the same
             weights: 101 GroupNorm and 16 attention launches, every one on
             attn_bf16_any; its attention per forward at batch 1 and 8 from
             phase kernels), and the same four-head model in fp32 at batch 1
             (101 GroupNorm and 16 attention launches, every one on
             attn_f32_any, within UNCOND_FP32_FORWARD_REL_TOL = 1e-4 of the
             plain route; its fp32 attention per forward from phase
             kernels); and the CLI's --profile on tiny_demo32 (4 NFE)
             writes a trace that names both kernels (into
             .kernel_build/profile/, deleted after).  Prints latency p50/p95
             (/stats), images per second and ms per NFE of the coalesced
             batch beside the same batch without HTTP and the CLI's demo256
             inpaint ms per NFE of phase tasks
  export     bundles (diffpir_tpu_torch.export) against the live runner at
             one seed, each exported on the card: the trained demo256 prior's
             inpaint (bf16, b4, 100 NFE, dynamic_point) whose step program must
             hold one groupnorm_silu and one legacy_qkv_attention node per call
             of a forward and no plain-version node, launch the live run's
             kernels, and come within EXPORT_PSNR_TOL_DB of its PSNR (bit for
             bit is expected; the largest difference is printed), ms per NFE
             of bundle and live in turns with the main thread's CPU and
             system time, and their ratio (logged, no bar); then, started
             together once the sidecar is written (LoadedRestore.save_aot), two
             fresh ``python -c`` processes that load it, run it and print
             boot_timings with no model, sampler or runner module imported, one
             without the sidecar and one with it in which any kernel build
             raises, and ``python -m diffpir_tpu_torch.server_http --bundle``,
             whose one POST /restore must equal the bundle service's restore;
             demo64 deblur (fp32, the Levin k0 PSF, the FFT prox's spectra
             from the prologue) and EXPORT_MODE_BUNDLES (demo64 fp32:
             pred_x_prev ancestral and DDIM inpaint, DPS_yt deblur at a noisy
             observation, test_mode 3 inpaint: the x8 ensemble's one call of
             32 images a step) within EXPORT_DEBLUR_ATOL; and the
             diffusion_ffhq_10m topology at full width (seeded random weights,
             bf16, b4, 256 px, 4 NFE) as demo256 inpaint and as a DPS_y0 deblur
             bundle (its step program one backward node per kernel node), with
             the export's seconds, the program's size, and for DPS_y0 ms per
             NFE of bundle and live in turns and the peak memory
  train      the training path (diffpir_tpu_torch.train): the DEMO256 recipe
             (scripts/train_demo.py --arch hq256 --batch 16 --lr 1e-4,
             resumed from the 54M prior, bf16 compute with fp32 masters,
             EMA 0.999, a pool of TRAIN_POOL_SIZE rich synthetic images):
             its first step's mean mse and loss against the JAX package's
             fp32 CPU terms of the same weights, batch, t and noise; the
             gradient through the kernels' autograd.Functions against the
             plain versions' (every GroupNorm weight and bias, emb_proj and
             qkv weight, and the whole gradient, at phase grad's bf16 bars)
             and a detached control that must miss them; 2 + 10 steps per
             route, kernels and plain in turns (ms per step, img/s, peak
             memory, launches and Function entries per step, CUDA events
             around the forward, the update and each Function backward); the
             EMA through a .flax.npz and zoo.resolve_model, a bit-equal
             forward.  Then ``python -m diffpir_tpu_torch.train.demo`` from
             scratch as a subprocess (tiny, 32 px, fp32, 200 steps): the last
             20 steps' mean loss at most half the first 20's.  Then
             256x256_diffusion_uncond (553M, seeded random weights, bf16):
             at batch 2 the loss and gradient with and without use_remat and
             the peak memory of each, and three timed steps at batch 4 with
             remat.  Files go to temporary directories removed after
  variants   guided-diffusion's 256x256 classifier (CLASSIFIER_256, seeded
             random weights built as an EncoderUNetModel state dict and read
             through models/convert.py, bf16, batch 8): logits through the
             kernels against the plain versions (launches per forward),
             d log p(y|x_t)/dx through the kernels' Functions against plain
             autograd with a detached control that must fail the bars, a .pt
             round trip that must give the same logits bit for bit,
             GUIDED_STEPS classifier-guided p_sample steps over the demo256
             prior (finite, and not the unguided steps of the same noise),
             and a SuperResUNet forward at the DEMO256 widths (6 input
             channels, 64 px low_res) against the plain versions.  Prints ms
             per forward and per guided step and peak memory
  metrics    configs/demo256_inpaint.yaml through the CLI with calc_LPIPS
             and calc_FID on seeded random VGG16+lin and InceptionV3 weights
             (written under .kernel_build/, removed after): PSNR and
             launches equal to phase tasks' run, LPIPS and FID finite and
             equal to lpips_from_weights and fid_from_weights applied on the
             card to a restore_batch of the same batch; ms per image of LPIPS
             and of the pool3 features
  parallel   the device mesh, ranks sharing the one card over gloo (their
             collectives staged through host memory) started by
             parallel.multihost.spawn, each against the same run unsharded
             in this process (PARALLEL_*): 256x256_diffusion_uncond (553M,
             seeded random weights, bf16, b1) under tp = 2, one forward and a
             4-NFE inpaint restore; the trained DEMO256 prior under sp = 2
             (bf16, b4, 4 NFE), which must launch the sharded GroupNorm's two
             kernels at every GroupNorm; demo64 under dp x tp x sp = 2x2x2
             (fp32, 2 NFE); a bundle of demo64's restore (fp32, 2 NFE) under
             data x model = 1 x 2, exported and run on the tp/sp pair's ranks, within
             DRYRUN_ATOL of the unsharded restore with the kernels' launches;
             on the same ranks DPS_y0 deblur of demo64 (fp32, b2, 2 NFE: its
             gradient through the sharded UNet's collectives) under model = 2
             and under space = 2, and a bundle of the DEMO256 prior's inpaint
             restore under space = 2 in fp32 (b4, 4 NFE; the sharded
             GroupNorm's halves and merge as operators at every GroupNorm,
             the collectives counted), each within DRYRUN_ATOL of the
             unsharded run; dryrun_train_step(4); and a group of one rank
             over NCCL made by multihost.initialize, whose restore must equal
             this process's bit for bit.  Per run: backend, world size,
             mesh, errors, ms per NFE and peak memory per rank (in the
             record line's "parallel")

Any failure prints its traceback and exits non-zero with no result line.  On
success the last lines are the kernels' JSON record, the card's name and
power limit, and ``{"ok": true, "device": {...}}``.  Nothing is written
outside ``.kernel_build/`` and temporary directories that are removed.

``--kernels-only`` stops after phase ``kernels`` and prints the per-forward
sums as JSON (no result line); ``--only export,parallel,formats`` runs those phases
after ``build`` alone (no result line); ``--package-root DIR`` takes the port's
package, and its kernels, from the checkout at DIR (for example an unpacked
parent commit), so that two versions can be timed on one card in turns.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# Mean PSNR of the JAX package on configs/demo64_inpaint.yaml, on the CPU:
#   python main_ddpir.py --opt configs/demo64_inpaint.yaml --cpu --no-sweep \
#       --set save_E=false --set save_L=false
# The two packages draw different noise, so the port is held to within
# PSNR_TOL_DB of it, not to equality.
JAX_DEMO64_PSNR = 45.42825711745008
# Phase formats: the demo64 inpaint CLI on the baseline JPEG copies of the
# demo64 images (testsets/demo64_formats, written by
# scripts/make_format_fixtures.py) at FORMATS_ITER steps; the JAX package's
# CPU PSNR of that run:
#   python main_ddpir.py --opt configs/demo64_inpaint.yaml --cpu --no-sweep
#     --no-compile-cache --set save_E=false --set save_L=false
#     --set testset_name=demo64_formats/jpeg_420 --set iter_num=10 --json
FORMATS_TESTSET = "demo64_formats/jpeg_420"
FORMATS_ITER = 10
FORMATS_BIG_JPEG = "imagenet_size/synth0_500x375.jpg"
JAX_FORMATS_PSNR = 35.96594337523153
PSNR_TOL_DB = 0.5
PLAIN_PSNR_TOL_DB = 0.05

# Mean PSNR of the JAX package on the CPU for each run of phase tasks, each
# from the command above it (with --set save_E=false --set save_L=false).
#   python main_ddpir.py --opt configs/demo64_deblur.yaml --cpu --no-sweep
JAX_DEMO64_DEBLUR_PSNR = 43.131496035679596
#   python main_ddpir.py --opt configs/demo64_sisr.yaml --cpu --no-sweep
JAX_DEMO64_SISR_BLUR_PSNR = 42.640470772054584
#   python main_ddpir.py --opt configs/demo64_sisr.yaml --cpu --no-sweep \
#       --set sr_mode=classical
JAX_DEMO64_SISR_CLASSICAL_PSNR = 43.371566173001995
# cubic SR at this operating point barely sees y (11-13 dB): one run's PSNR
# moves by up to 2 dB with the seed, so both packages are held by their mean
# over CUBIC_SEEDS seeds, each run as
#   python main_ddpir.py --opt configs/demo64_sisr.yaml --cpu --no-sweep \
#       --set sr_mode=cubic --set seed=<42 .. 73>
# (the JAX runs: min 10.8724, max 13.1333, standard deviation 0.5753 dB)
CUBIC_SEEDS = 32
JAX_DEMO64_SISR_CUBIC_PSNR = 11.842025094216517
#   python main_ddpir.py --opt configs/demo32_inpaint.yaml --cpu --no-sweep
JAX_DEMO32_INPAINT_PSNR = 34.953652564655215
#   python main_ddpir.py --opt configs/demo256_deblur.yaml --cpu --no-sweep
JAX_DEMO256_DEBLUR_PSNR = 44.456662192940875
#   python main_ddpir.py --opt configs/demo256_sisr.yaml --cpu --no-sweep
JAX_DEMO256_SISR_PSNR = 41.437732040677446
#   python main_ddpir.py --opt configs/demo256_inpaint.yaml --cpu --no-sweep
JAX_DEMO256_INPAINT_PSNR = 47.18845326994437
# The other trajectory modes, each from the command above it with
# --set save_E=false --set save_L=false --no-compile-cache.
#   python main_ddpir.py --opt configs/demo64_inpaint.yaml --cpu --no-sweep \
#       --set generate_mode=repaint
JAX_DEMO64_REPAINT_PSNR = 45.55653403775764  # seeds 42-57: 45.2161-46.2179
#   python main_ddpir.py --opt configs/demo64_inpaint.yaml --cpu --no-sweep \
#       --set generate_mode=vanilla
JAX_DEMO64_VANILLA_PSNR = 14.022523842854316  # seeds 42-73: 12.9512-15.0871
#   python main_ddpir.py --opt configs/demo64_inpaint.yaml --cpu --no-sweep \
#       --set iter_num_U=2
JAX_DEMO64_ITER_U2_PSNR = 46.19522039259486  # seeds 42-57: 45.8789-46.6167
# pred_x_prev and DPS take one step of the base chain (t -> t-1) where the
# plan jumps ~50 timesteps, so at these NFE they restore little in either
# package (5-11 dB); the runs hold the port to that behaviour.
#   python main_ddpir.py --opt configs/demo64_inpaint.yaml --cpu --no-sweep \
#       --set model_output_type=pred_x_prev --set ddim_sample=true
JAX_DEMO64_XPREV_DDIM_PSNR = 10.890555677312495
#   python main_ddpir.py --opt configs/demo64_deblur.yaml --cpu --no-sweep \
#       --set generate_mode=DPS_y0
JAX_DEMO64_DPS_Y0_PSNR = 5.847043972514592
# DPS_yt and the first-order prox need a noisy observation (sigma_y enters
# their step size as 1/sigma_y^2; at noise_level_img 0 they diverge to NaN
# or -18 dB in both packages), and the first-order prox a lambda at which
# it restores (20; the analytic prox's 150 leaves it near the prior):
#   python main_ddpir.py --opt configs/demo64_deblur.yaml --cpu --no-sweep \
#       --set generate_mode=DPS_yt --set noise_level_img=12.75
JAX_DEMO64_DPS_YT_PSNR = 7.514970561452527
#   python main_ddpir.py --opt configs/demo64_deblur.yaml --cpu --no-sweep \
#       --set sub_1_analytic=false --set noise_level_img=12.75 --set lambda_=20
JAX_DEMO64_DEBLUR_GRAD_PSNR = 25.94008651906491  # seeds 42-57: 25.4922-26.4452
#   python main_ddpir.py --opt configs/demo64_sisr.yaml --cpu --no-sweep \
#       --set sub_1_analytic=false --set noise_level_img=12.75 --set lambda_=20
JAX_DEMO64_SISR_GRAD_PSNR = 37.18207541819505  # seeds 42-57: 36.4223-37.9051
#   python main_ddpir.py --opt configs/demo256_deblur.yaml --cpu --no-sweep \
#       --set iter_num=20 --set generate_mode=DPS_y0
JAX_DEMO256_DPS_Y0_PSNR = 5.581532512288286
#   python main_ddpir.py --opt configs/demo256_inpaint.yaml --cpu --no-sweep \
#       --set iter_num=20 --set generate_mode=repaint --set iter_num_U=2
JAX_DEMO256_REPAINT_U2_PSNR = 45.66042670748715
#   python main_ddpir.py --opt configs/demo256_inpaint.yaml --cpu --no-sweep \
#       --set iter_num=20 --set model_output_type=pred_x_prev
JAX_DEMO256_XPREV_PSNR = 10.474139087734825
# The DIY motion PSF (one per image, default_rng(idx * 10), intensity 0.5)
# at the config's kernel size, 15:
#   python main_ddpir.py --opt configs/demo64_deblur.yaml --cpu --no-sweep \
#       --set use_DIY_kernel=true --set blur_mode=motion
JAX_DEMO64_DEBLUR_MOTION_PSNR = 43.550579627417484
NOISY = {"noise_level_img": 12.75}
# Where the trajectory's noise moves one seed's PSNR by tenths of a dB
# (demo64 repaint, iter_num_U=2 and the first-order proxes; on seed 42 the
# port's repaint was 45.1488 dB on the card against JAX's 45.6658), both
# packages are held by their mean over MODE_SEEDS seeds (the JAX runs'
# standard deviation over seeds 42-57: 0.21-0.37 dB); vanilla, a prior
# sample where half the pixels are observed, by VANILLA_SEEDS (0.57 dB).
# The JAX constants are means over the same seeds, each run as the command
# above it with --set seed=<42 ..>.
MODE_SEEDS = 16
VANILLA_SEEDS = 32
# (name, config, overrides, the JAX package's PSNR, seeds it is a mean over,
# from the config's seed on)
TASK_RUNS = (
    ("demo64_deblur", "configs/demo64_deblur.yaml", {}, JAX_DEMO64_DEBLUR_PSNR, 1),
    ("demo64_deblur_motion", "configs/demo64_deblur.yaml",
     {"use_DIY_kernel": True, "blur_mode": "motion"}, JAX_DEMO64_DEBLUR_MOTION_PSNR, 1),
    ("demo64_sisr_blur", "configs/demo64_sisr.yaml", {}, JAX_DEMO64_SISR_BLUR_PSNR, 1),
    ("demo64_sisr_classical", "configs/demo64_sisr.yaml", {"sr_mode": "classical"},
     JAX_DEMO64_SISR_CLASSICAL_PSNR, 1),
    ("demo64_sisr_cubic", "configs/demo64_sisr.yaml", {"sr_mode": "cubic"},
     JAX_DEMO64_SISR_CUBIC_PSNR, CUBIC_SEEDS),
    ("demo32_inpaint", "configs/demo32_inpaint.yaml", {}, JAX_DEMO32_INPAINT_PSNR, 1),
    ("demo256_deblur", "configs/demo256_deblur.yaml", {}, JAX_DEMO256_DEBLUR_PSNR, 1),
    ("demo256_sisr", "configs/demo256_sisr.yaml", {}, JAX_DEMO256_SISR_PSNR, 1),
    ("demo256_inpaint", "configs/demo256_inpaint.yaml", {}, JAX_DEMO256_INPAINT_PSNR,
     1),
    ("demo64_repaint", "configs/demo64_inpaint.yaml", {"generate_mode": "repaint"},
     JAX_DEMO64_REPAINT_PSNR, MODE_SEEDS),
    ("demo64_vanilla", "configs/demo64_inpaint.yaml", {"generate_mode": "vanilla"},
     JAX_DEMO64_VANILLA_PSNR, VANILLA_SEEDS),
    ("demo64_iter_u2", "configs/demo64_inpaint.yaml", {"iter_num_U": 2},
     JAX_DEMO64_ITER_U2_PSNR, MODE_SEEDS),
    ("demo64_xprev_ddim", "configs/demo64_inpaint.yaml",
     {"model_output_type": "pred_x_prev", "ddim_sample": True},
     JAX_DEMO64_XPREV_DDIM_PSNR, 1),
    # the same restore as phase main's: its frames are checked, not saved
    ("demo64_progress", "configs/demo64_inpaint.yaml", {"log_process": True},
     JAX_DEMO64_PSNR, 1),
    ("demo64_dps_y0", "configs/demo64_deblur.yaml", {"generate_mode": "DPS_y0"},
     JAX_DEMO64_DPS_Y0_PSNR, 1),
    ("demo64_dps_yt", "configs/demo64_deblur.yaml",
     {"generate_mode": "DPS_yt", **NOISY}, JAX_DEMO64_DPS_YT_PSNR, 1),
    ("demo64_deblur_grad", "configs/demo64_deblur.yaml",
     {"sub_1_analytic": False, "lambda_": 20, **NOISY}, JAX_DEMO64_DEBLUR_GRAD_PSNR,
     MODE_SEEDS),
    ("demo64_sisr_grad", "configs/demo64_sisr.yaml",
     {"sub_1_analytic": False, "lambda_": 20, **NOISY}, JAX_DEMO64_SISR_GRAD_PSNR,
     MODE_SEEDS),
    ("demo256_dps_y0", "configs/demo256_deblur.yaml",
     {"iter_num": 20, "generate_mode": "DPS_y0"}, JAX_DEMO256_DPS_Y0_PSNR, 1),
    ("demo256_repaint_u2", "configs/demo256_inpaint.yaml",
     {"iter_num": 20, "generate_mode": "repaint", "iter_num_U": 2},
     JAX_DEMO256_REPAINT_U2_PSNR, 1),
    ("demo256_xprev", "configs/demo256_inpaint.yaml",
     {"iter_num": 20, "model_output_type": "pred_x_prev"}, JAX_DEMO256_XPREV_PSNR, 1),
)
# DPS_y0 gradient on the card: kernels' autograd.Functions against the
# plain versions' autograd (relative L2 of the difference; cosine).  In bf16
# each route's gradient is a few 1e-2 (relative L2) from the fp32 gradient of
# the same weights and input (phase grad prints both), so two bf16 routes
# cannot be held closer than that floor; kernel against plain reached 2.2e-2
# at demo256 in one run of phase grad.  A lost gradient (the detached
# control) is 0.68 or more away.
GRAD_REL_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
GRAD_MIN_COSINE = {"float32": 0.999, "bfloat16": 0.999}

# Kernel against plain version on the card: the JAX package's own test
# tolerances (tests/test_pallas_groupnorm.py, tests/test_pallas_attention.py).
# bf16 outputs are compared with atol = rtol = 3e-2 (one bf16 ulp is 2^-8
# relative; the kernel and the plain version round at different points).
TOL = {
    ("groupnorm_silu", "float32"): dict(atol=2e-5, rtol=0.0),
    ("groupnorm_silu", "bfloat16"): dict(atol=3e-2, rtol=3e-2),
    ("legacy_qkv_attention", "float32"): dict(atol=2e-5, rtol=1e-4),
    ("legacy_qkv_attention", "bfloat16"): dict(atol=3e-2, rtol=3e-2),
}
# Head widths of the generic attention kernel held in phase kernels at
# (8, T, 4 heads) for T = 64, 256 and 1024, and (B, T, heads, ch) cases with
# odd widths at a T that is no multiple of a tile
GENERIC_WIDTHS = (8, 24, 48, 80, 96, 128, 192, 256)
ODD_WIDTH_CASES = ((2, 100, 3, 1), (2, 100, 3, 7), (2, 65, 2, 255))
# Heads wider than 256 (attn_wide): a num_head_channels of -1 with one or two
# heads at ds16 of a 256-px image (T = 256), and 2048 channels over two heads
# at ds32 (T = 64); and more than 65535 (batch, head) pairs at a short T
WIDE_CASES = ((4, 256, 2, 320), (4, 256, 1, 512), (2, 64, 2, 1024))
PAIRS_CASE = (33000, 4, 2, 32)
# 256x256_diffusion_uncond under num_heads 4 and num_head_channels -1
# (guided-diffusion's default, its LSUN checkpoints' setting): the same
# parameters, each attention layer in 4 heads of C / 4 channels, so 5 calls
# at (B, 1024, 4 x 128), 5 at (B, 256, 4 x 256) and 6 at (B, 64, 4 x 256)
# a forward, all on attn_bf16_any in bf16
UNCOND_4HEADS = dict(num_heads=4, num_head_channels=-1)
UNCOND_4HEADS_ATTN = 16
UNCOND_GROUPNORMS = 101
# ... and in fp32, every attention call on attn_f32_any: the forward through
# the kernels against the plain versions at the fp32 parity bar the
# converter's tests use
UNCOND_FP32_FORWARD_REL_TOL = 1e-4
# Phase parallel.  Ranks that share the one card run over gloo, a collective
# going through host memory (gloo's own transport aborts on a CUDA tensor
# with this torch); so these runs show correctness and memory per rank, not
# scaling.  553M (256x256_diffusion_uncond, seeded random weights, bf16, b1,
# 256 px) under tp = 2: one forward and a 4-NFE inpaint restore against the
# unsharded run at phase flagship's bars; DEMO256 (trained 54M prior, bf16,
# b4, 256 px, 4 NFE) under sp = 2 at the same bars; demo64 (fp32, 2 NFE)
# under dp x tp x sp = 2 x 2 x 2 at DRYRUN_ATOL (runner.py: the first step
# multiplies the UNet's rounding by 156); dryrun_train_step(4) at 1e-5.
# phase export: bundles against the live runner.  The bundle runs the live
# path's operations in its order with its draws, so bit-equal outputs are
# expected; the bars are EXPORT_PSNR_TOL_DB and, for the fp32 deblur,
# EXPORT_DEBLUR_ATOL
EXPORT_PSNR_TOL_DB = 0.01
EXPORT_DEBLUR_ATOL = 1e-5
EXPORT_FFHQ_ITER = 5               # 4 NFE
# phase export's demo64 bundles of the other modes (fp32, held as the
# deblur bundle: EXPORT_DEBLUR_ATOL; the inpaint ones at 20 NFE, as the
# deblur config runs): (name, config, overrides)
EXPORT_MODE_BUNDLES = (
    ("demo64_xprev", "configs/demo64_inpaint.yaml",
     {"model_output_type": "pred_x_prev", "iter_num": 20}),
    ("demo64_xprev_ddim", "configs/demo64_inpaint.yaml",
     {"model_output_type": "pred_x_prev", "ddim_sample": True, "iter_num": 20}),
    ("demo64_dps_yt", "configs/demo64_deblur.yaml", {"generate_mode": "DPS_yt", **NOISY}),
    ("demo64_test_mode3", "configs/demo64_inpaint.yaml", {"test_mode": 3, "iter_num": 20}),
)
# the modules a bundle's serving process must not import
MODEL_MODULES = ("diffpir_tpu_torch.models", "diffpir_tpu_torch.sampler",
                 "diffpir_tpu_torch.runner")
PARALLEL_ITER = 5                  # 4 NFE: the final denoise is skipped
PARALLEL_MESH3_ITER = 3            # 2 NFE
PARALLEL_TRAIN_ATOL = 1e-5
# Phase variants: guided-diffusion's 256x256 classifier (the README's
# classifier flags and script_util.py create_classifier: image_size 256,
# classifier_width 128, classifier_depth 2, attention at 32, 16 and 8 px,
# num_head_channels 64, channel_mult (1, 1, 2, 2, 4, 4), resblock_updown and
# use_scale_shift_norm on, pool "attention", 1000 classes), bf16, batch 8;
# per forward 46 GroupNorm calls (2 x 19 ResBlocks, 7 attention norms,
# out_norm) and 7 attention calls; CLASSIFIER_SCALE as the README's
# classifier-guided sampling of the unconditional 256x256 model
CLASSIFIER_256 = dict(image_size=256, in_channels=3, model_channels=128,
                      out_channels=1000, num_res_blocks=2,
                      attention_resolutions=(8, 16, 32),
                      channel_mult=(1, 1, 2, 2, 4, 4), num_heads=4,
                      num_head_channels=64, dropout=0.0,
                      use_scale_shift_norm=True, resblock_updown=True)
CLASSIFIER_BATCH = 8
CLASSIFIER_CALLS = {"groupnorm_silu": 46, "legacy_qkv_attention": 7}
CLASSIFIER_SCALE = 10.0
GUIDED_STEPS = 20
# Phase metrics: the CLI's LPIPS and FID against the functions applied on
# the card to a restore of the same batch (the same kernels and seed: equal
# but for cuDNN's choice of algorithms between the two runs)
METRIC_LPIPS_RTOL = 1e-4
METRIC_FID_RTOL = 1e-3
# Flagship phase, random weights, bf16: one UNet forward through the kernels
# against the plain versions, max |diff| over max |plain output|; and the
# 20-NFE restored images on [0, 1], mean |diff|.
FLAGSHIP_FORWARD_REL_TOL = 5e-2
FLAGSHIP_IMAGE_MEAN_TOL = 2e-2

# Phase train.  The JAX package's fp32 CPU terms of the DEMO256 recipe's first
# step (54M prior, batch TRAIN_BATCH from a pool of TRAIN_POOL_SIZE rich
# synthetic images of --pool-seed TRAIN_POOL_SEED, t and noise from
# numpy.random.default_rng(0)), and its tiny from-scratch loss ratio (for
# information: the packages draw differently), printed by
#   python tests/test_torch_train_demo.py
TRAIN_POOL_SEED, TRAIN_POOL_SIZE, TRAIN_BATCH = 7, 64, 16
JAX_DEMO256_STEP_MSE = 0.0014172473456710577
JAX_DEMO256_STEP_LOSS = 0.0014751895796507597
JAX_TINY_LOSS_RATIO = 0.085794420308903
TINY_TRAIN_ARGS = ("--arch", "tiny", "--image-size", "32", "--steps", "200", "--batch",
                   "64", "--dataset-size", "512", "--save-interval", "10")
# bf16 on the card against fp32 on the CPU: the mean mse within 2 %, the mean
# loss (mse + the VLB term, whose decoder NLL at small t is sensitive to the
# output's rounding) within 5 %; kernels against plain versions on the card:
# the loss within 1e-2, each GroupNorm, emb_proj and qkv gradient and the
# whole gradient within phase grad's bf16 bars (GRAD_REL_TOL, GRAD_MIN_COSINE)
TRAIN_MSE_REL_TOL = 0.02
TRAIN_LOSS_REL_TOL = 0.05
TRAIN_KERNEL_LOSS_REL_TOL = 1e-2
# from scratch, 200 steps: the last 20 steps' mean loss at most half the first 20's
TINY_LOSS_RATIO_MAX = 0.5
# 553M with and without per-block recompute: the same arithmetic but cuDNN's
# weight gradients are not bit-deterministic
REMAT_LOSS_REL_TOL = 1e-3
REMAT_GRAD_REL_TOL = 1e-2

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and FLOP/s by type
# (fp32 on CUDA cores)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
# fp32 attention's operations bound: fp32-accurate products on the tensor
# cores, three TF32 products each (495 TFLOP/s dense TF32), the least time
# in which the card computes them (attn_f32_any's split, and SDPA's fp32
# kernel, do so); GroupNorm's fp32 bound stays at the CUDA-core rate
SPLIT_TF32_FLOPS = 495e12 / 3

FORBIDDEN = ("jax", "flax", "optax", "orbax", "yaml", "PIL", "diffpir_tpu")


def log(msg: str) -> None:
    print(msg, flush=True)


@contextlib.contextmanager
def phase(name: str):
    log(f"phase {name} start")
    t0 = time.perf_counter()
    yield
    log(f"phase {name} done {time.perf_counter() - t0:.3f}s")


def timed_ms(fn, iters: int = 20) -> float:
    """Dispatch time: mean time of ``fn`` in ms, by CUDA events around
    ``iters`` back-to-back calls (host dispatch included where it is longer
    than the card's work)."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 20, replays: int = 3) -> float:
    """Device time: mean time of ``fn`` in ms, with ``iters`` calls captured
    in one CUDA graph and replayed ``replays`` times between CUDA events.
    A capture that fails raises."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    # warm-up on the stream that then captures, off the capture, as CUDA graphs
    # ask: it also makes the GroupNorm wrapper's counters for that stream
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / (iters * replays)


def time_all(**fns) -> dict:
    """Device and dispatch times of each named function: ``<name>_ms`` and
    ``<name>_dispatch_ms`` ("kernel" is written ``ms`` and ``dispatch_ms``)."""
    out = {}
    for name, fn in fns.items():
        pre = "" if name == "kernel" else name + "_"
        out[pre + "ms"] = graph_ms(fn)
        out[pre + "dispatch_ms"] = timed_ms(fn)
    return out


def max_violation(got, ref, atol: float, rtol: float) -> tuple[float, bool]:
    diff = (got.float() - ref.float()).abs()
    ok = bool((diff <= atol + rtol * ref.float().abs()).all())
    return float(diff.max()), ok


# entries into the kernels' autograd.Functions, by kernel (count_function_entries)
FN_CALLS: collections.Counter = collections.Counter()


def count_function_entries() -> None:
    """Count each entry into a kernel's autograd.Function in FN_CALLS."""
    from diffpir_tpu_torch.kernels import attention as kat
    from diffpir_tpu_torch.kernels import groupnorm as kgn

    for name, cls in (("groupnorm_silu", kgn.GroupNormSiLUFunction),
                      ("legacy_qkv_attention", kat.LegacyQKVAttentionFunction)):
        def apply(*args, _orig=cls.apply, _name=name):
            FN_CALLS[_name] += 1
            return _orig(*args)

        cls.apply = apply


def forwards_per_batch(cfg) -> int:
    """UNet forwards of one batch's restore in the config's mode: every
    step of pred_x_prev, all but the last of DPS, and all but the last times
    iter_num_U of DiffPIR, repaint and vanilla.  A backward launches no
    kernel."""
    from diffpir_tpu_torch.schedule import NoiseSchedule, build_plan

    sched = NoiseSchedule.linear(cfg.beta_start, cfg.beta_end, cfg.num_train_timesteps)
    t_start = (None if cfg.t_start_sigma is None
               else sched.sigma_to_t(cfg.t_start_sigma))
    n = build_plan(sched, iter_num=cfg.iter_num, skip_type=cfg.skip_type,
                   t_start=t_start).n_steps
    if cfg.model_output_type == "pred_x_prev":
        return n
    if cfg.generate_mode in ("DPS_y0", "DPS_yt"):
        return n - 1
    return (n - 1) * cfg.iter_num_U


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# shapes the paths give the kernels
# ---------------------------------------------------------------------------

def record_kernel_calls(model, x, t):
    """One forward of ``model``; returns its GroupNorm and attention calls in
    order: ("gn", (B,H,W,C), dtype, film, silu) and ("attn", B, T, heads, ch,
    dtype)."""
    import torch

    from diffpir_tpu_torch.models.unet import AttentionBlock, GroupNorm32

    calls, handles = [], []

    def gn_hook(mod, args, kwargs):
        film = kwargs.get("film", args[1] if len(args) > 1 else None)
        calls.append(("gn", tuple(args[0].shape), str(args[0].dtype).split(".")[1],
                      film is not None, mod.fuse_silu))

    def attn_hook(mod, args):
        b, hh, ww, c = args[0].shape
        calls.append(("attn", b, hh * ww, mod.num_heads, c // mod.num_heads,
                      str(args[0].dtype).split(".")[1]))

    for m in model.modules():
        if isinstance(m, GroupNorm32):
            handles.append(m.register_forward_pre_hook(gn_hook, with_kwargs=True))
        elif isinstance(m, AttentionBlock):
            handles.append(m.register_forward_pre_hook(attn_hook))
    try:
        with torch.no_grad():
            model(x, t)
    finally:
        for h in handles:
            h.remove()
    return calls


# ---------------------------------------------------------------------------
# one kernel case: kernel vs plain, times, bound
# ---------------------------------------------------------------------------

def gn_case(shape, dtype_name, film, silu, gen):
    import torch
    import torch.nn.functional as F

    from diffpir_tpu_torch.kernels import groupnorm as kgn

    dev = torch.device("cuda")
    dtype = getattr(torch, dtype_name)
    b, c = shape[0], shape[-1]
    x = torch.randn(shape, generator=gen, device=dev).to(dtype)
    scale = 1.0 + 0.2 * torch.randn(c, generator=gen, device=dev)
    bias = 0.2 * torch.randn(c, generator=gen, device=dev)
    fs = fb = None
    if film:
        fs = 0.3 * torch.randn((b, c), generator=gen, device=dev)
        fb = 0.3 * torch.randn((b, c), generator=gen, device=dev)
    kern = lambda: kgn.groupnorm_silu(x, scale, bias, fs, fb, do_silu=silu)
    plain = lambda: kgn.groupnorm_silu_plain(x, scale, bias, fs, fb, do_silu=silu)
    xn, sc, bi = x.permute(0, 3, 1, 2), scale.to(dtype), bias.to(dtype)

    def library():
        y = F.group_norm(xn, 32, sc, bi, 1e-5)
        if film:
            y = y * (1.0 + fs.to(dtype)[:, :, None, None]) + fb.to(dtype)[:, :, None, None]
        return F.silu(y) if silu else y

    out, ref, again = kern(), plain(), kern()
    torch.cuda.synchronize()
    err, ok = max_violation(out, ref, **TOL[("groupnorm_silu", dtype_name)])
    n = x.numel()
    nbytes = 2 * n * x.element_size() + (2 * c + (2 * b * c if film else 0)) * 4
    flops = n * (4 + (2 if film else 0) + (4 if silu else 0))
    return dict(err=err, ok=ok, repeats=torch.equal(out, again), bytes=nbytes,
                flops=flops, dtype=dtype_name,
                **time_all(kernel=kern, plain=plain, library=library))


def gn_high_mean_case(gen):
    """fp32, |mean| >> std (tests/test_torch_groupnorm.py's recipe, x*0.03+100)
    at a card shape: kernel against plain version (atol 1e-3, that test's
    tolerance), and both against fp64 statistics."""
    import torch

    from diffpir_tpu_torch.kernels import groupnorm as kgn

    dev = torch.device("cuda")
    x = torch.randn((4, 64, 64, 384), generator=gen, device=dev) * 0.03 + 100.0
    ones = torch.ones(384, device=dev)
    zeros = torch.zeros(384, device=dev)
    out = kgn.groupnorm_silu(x, ones, zeros, do_silu=False)
    ref = kgn.groupnorm_silu_plain(x, ones, zeros, do_silu=False)
    x64 = x.double().reshape(4, 64, 64, 32, 12)
    mu = x64.mean(dim=(1, 2, 4), keepdim=True)
    var = (x64 - mu).square().mean(dim=(1, 2, 4), keepdim=True)
    exact = ((x64 - mu) / torch.sqrt(var + 1e-5)).reshape(x.shape)
    err, ok = max_violation(out, ref, atol=1e-3, rtol=0.0)
    return dict(err=err, ok=ok, kernel_exact=float((out.double() - exact).abs().max()),
                plain_exact=float((ref.double() - exact).abs().max()))


def attn_case(b, t, heads, ch, dtype_name, gen):
    import torch
    import torch.nn.functional as F

    from diffpir_tpu_torch.kernels import attention as kat

    dev = torch.device("cuda")
    dtype = getattr(torch, dtype_name)
    qkv = torch.randn((b, t, 3 * heads * ch), generator=gen, device=dev).to(dtype)
    kern = lambda: kat.legacy_qkv_attention(qkv, heads)
    plain = lambda: kat.legacy_qkv_attention_plain(qkv, heads)
    # the library yardstick takes (B, heads, T, ch): a transposed copy, made
    # once, outside the timing
    q, k, v = qkv.reshape(b, t, heads, 3, ch).permute(3, 0, 2, 1, 4).contiguous()
    library = lambda: F.scaled_dot_product_attention(q, k, v, scale=1.0 / math.sqrt(ch))
    out, ref, again = kern(), plain(), kern()
    torch.cuda.synchronize()
    err, ok = max_violation(out, ref, **TOL[("legacy_qkv_attention", dtype_name)])
    # the variant that ran (a checkout from before attention_plan: "-")
    plan = (kat.attention_plan(b, t, heads, ch, dtype_name == "bfloat16",
                               torch.cuda.get_device_properties(0).multi_processor_count)
            if hasattr(kat, "attention_plan") else None)
    variant = "-" if plan is None else (
        f"{plan.variant} rows={plan.rows} slice={plan.slice_ch}x{plan.slices}"
        + (f" key_splits={plan.key_splits}" if getattr(plan, "key_splits", 1) > 1 else ""))
    lib_err = float((library().permute(0, 2, 1, 3).reshape(b, t, heads * ch).float()
                     - ref.float()).abs().max())
    nbytes = (qkv.numel() + out.numel()) * qkv.element_size()
    flops = 4 * b * heads * t * t * ch
    peak = SPLIT_TF32_FLOPS if dtype_name == "float32" else PEAK_FLOPS[dtype_name]
    return dict(err=err, ok=ok, repeats=torch.equal(out, again), bytes=nbytes,
                flops=flops, dtype=dtype_name, peak_flops=peak, library_err=lib_err,
                variant=variant, **time_all(kernel=kern, plain=plain, library=library))


def dps_grad_case(opt: str, over: dict, step: int, gen, dev):
    """One DPS_y0 step of ``opt``'s first batch: g = d||y - H(x0(x_t))||/dx_t
    at the plan's row ``step``, x_t diffused from the observation.  Returns
    the gradients through the kernels' Functions, through the plain
    versions, through the kernels with their Functions bypassed (the
    outputs then carry no gradient: GroupNorm and attention detached) and,
    for a bf16 config, through the plain versions in fp32; and event times
    of the forward alone and of the forward and backward."""
    import torch

    from diffpir_tpu_torch import guidance
    from diffpir_tpu_torch.config import load_config
    from diffpir_tpu_torch.data import make_batches, prepare_images
    from diffpir_tpu_torch.kernels import attention as kat
    from diffpir_tpu_torch.kernels import groupnorm as kgn
    from diffpir_tpu_torch.runner import Runner
    from diffpir_tpu_torch.sampler import model_fn

    cfg = load_config(opt, {"save_E": False, "save_L": False, **over})
    np.random.seed(cfg.seed)
    batch = make_batches(prepare_images(cfg), cfg.batch_size)[0]
    y = torch.from_numpy(batch.img_L).to(dev)
    kernel = torch.from_numpy(batch.kernel).to(dev)
    op = guidance.make_degrade_op("deblur", kernel=kernel)
    runners = {route: Runner(cfg, device=dev, kernels=route)
               for route in ("cuda", "plain")}
    if cfg.dtype != "float32":
        # the fp32 gradient of the same weights, the floor of both bf16 routes
        runners["fp32"] = Runner(load_config(opt, {"save_E": False, "save_L": False,
                                                  **over, "dtype": "float32"}),
                                 device=dev, kernels="plain")
    plan = runners["cuda"]._plan(cfg.lambda_)
    t = torch.full((y.shape[0],), int(plan.t[step]), dtype=torch.int32, device=dev)
    diffusion = runners["cuda"].diffusion
    x = diffusion.q_sample(2.0 * y - 1.0, t, torch.randn(y.shape, generator=gen,
                                                         device=dev))
    noise = torch.randn(y.shape, generator=gen, device=dev)

    def residual(route, xv):
        out = diffusion.p_sample(model_fn(runners[route].den), xv, t, noise)
        return guidance.frobenius_residual(op, out["pred_xstart"], y)

    def grad(route):
        xv = x.detach().requires_grad_()
        (g,) = torch.autograd.grad(residual(route, xv), xv)
        return g.double()

    def forward():
        with torch.no_grad():
            return residual("cuda", x)

    out = {"t": int(plan.t[step]), "dtype": cfg.dtype, "batch": tuple(y.shape),
           "cuda": grad("cuda"), "plain": grad("plain")}
    if "fp32" in runners:
        out["fp32"] = grad("fp32")
    launches = (kgn.wants_grad, kat.wants_grad)
    kgn.wants_grad = kat.wants_grad = lambda *a: False
    try:
        out["detached"] = grad("cuda")
    finally:
        kgn.wants_grad, kat.wants_grad = launches
    out["forward_ms"] = timed_ms(forward, iters=5)
    out["forward_backward_ms"] = timed_ms(lambda: grad("cuda"), iters=5)
    out["plain_forward_backward_ms"] = timed_ms(lambda: grad("plain"), iters=5)
    del runners
    torch.cuda.empty_cache()
    return out


def grad_agreement(got, ref) -> tuple[float, float]:
    """(relative L2 of got - ref, cosine of got and ref)."""
    rel = float((got - ref).norm() / ref.norm())
    cos = float((got * ref).sum() / (got.norm() * ref.norm()))
    return rel, cos


def http_post(opener, url: str, body: bytes, ctype: str):
    """POST ``body``; returns (status, content type, body), errors included."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, data=body, method="POST",
                                 headers={"Content-Type": ctype})
    try:
        with opener.open(req, timeout=600) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


def npz_bytes(**arrays) -> bytes:
    import io

    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def gn_half_cases(shape, dtype_name, film, silu, gen):
    """The two halves of the sharded GroupNorm at one shard's shape: the
    partial statistics and the apply launch, each against its plain version,
    times, bounds and library calls (``torch.var_mean`` over the groups, and
    ``F.group_norm`` + FiLM + ``F.silu``, which also takes the statistics)."""
    import torch
    import torch.nn.functional as F

    from diffpir_tpu_torch.kernels import groupnorm as kgn

    dev = torch.device("cuda")
    dtype = getattr(torch, dtype_name)
    b, c = shape[0], shape[-1]
    x = torch.randn(shape, generator=gen, device=dev).to(dtype)
    scale = 1.0 + 0.2 * torch.randn(c, generator=gen, device=dev)
    bias = 0.2 * torch.randn(c, generator=gen, device=dev)
    fs = fb = None
    if film:
        fs = 0.3 * torch.randn((b, c), generator=gen, device=dev)
        fb = 0.3 * torch.randn((b, c), generator=gen, device=dev)
    is_bf16 = dtype == torch.bfloat16
    stats = kgn.merge_partial_stats(kgn.groupnorm_partial_stats_plain(x)[None], is_bf16)
    xg = x.reshape(b, -1, 32, c // 32)
    xn, sc, bi = x.permute(0, 3, 1, 2), scale.to(dtype), bias.to(dtype)

    def library_apply():
        y = F.group_norm(xn, 32, sc, bi, 1e-5)
        if film:
            y = y * (1.0 + fs.to(dtype)[:, :, None, None]) + fb.to(dtype)[:, :, None, None]
        return F.silu(y) if silu else y

    out = {}
    p_k, p_p, p_again = (kgn.groupnorm_partial_stats(x), kgn.groupnorm_partial_stats_plain(x),
                         kgn.groupnorm_partial_stats(x))
    torch.cuda.synchronize()
    # the partial sums of a shard: relative to their own size
    err = float(((p_k - p_p).abs() / p_p.abs().clamp_min(1.0)).max())
    n = x.numel()
    out["partial"] = dict(
        err=err, ok=err <= PARTIAL_STATS_RTOL, repeats=torch.equal(p_k, p_again),
        bytes=n * x.element_size() + b * 32 * 3 * 4, flops=3 * n, dtype=dtype_name,
        **time_all(kernel=lambda: kgn.groupnorm_partial_stats(x),
                   plain=lambda: kgn.groupnorm_partial_stats_plain(x),
                   library=lambda: torch.var_mean(xg, dim=(1, 3))))
    kern = lambda: kgn.groupnorm_apply_stats(x, scale, bias, stats, fs, fb, do_silu=silu)
    plain = lambda: kgn.groupnorm_apply_stats_plain(x, scale, bias, stats, fs, fb,
                                                    do_silu=silu)
    a_k, a_p, a_again = kern(), plain(), kern()
    torch.cuda.synchronize()
    err, ok = max_violation(a_k, a_p, **TOL[("groupnorm_silu", dtype_name)])
    out["apply"] = dict(
        err=err, ok=ok, repeats=torch.equal(a_k, a_again),
        bytes=2 * n * x.element_size() + (2 * c + 2 * b * 32 + (2 * b * c if film else 0)) * 4,
        flops=n * (2 + (4 if silu else 0)), dtype=dtype_name,
        **time_all(kernel=kern, plain=plain, library=library_apply))
    return out


# the partial statistics against the plain version's, relative to each sum's
# size (floored at 1): fp32 sums over a shard in a different order
PARTIAL_STATS_RTOL = 1e-4


def bound(case) -> tuple[float, str]:
    """The least time of a case: its bytes at the memory rate or its
    operations at the peak rate of their type (attention in fp32: the
    split-TF32 rate), whichever is longer."""
    t_bytes = case["bytes"] / PEAK_BYTES_PER_S * 1e3
    t_ops = case["flops"] / case.get("peak_flops", PEAK_FLOPS[case["dtype"]]) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def serve_phase(dev, gen, calls256, cli_ms_nfe: float, per_fwd) -> dict:
    """Phase serve: the port's HTTP server on the card (see the module
    docstring).  Returns what the record line and the log report."""
    import io
    import shutil
    import threading
    import urllib.request

    import torch

    from diffpir_tpu_torch.config import load_config
    from diffpir_tpu_torch.data import make_batches, prepare_images
    from diffpir_tpu_torch.kernels import LAUNCHES
    from diffpir_tpu_torch.kernels import attention as kat
    from diffpir_tpu_torch.main import main as cli_main
    from diffpir_tpu_torch.models import convert, zoo
    from diffpir_tpu_torch.models.unet import UNet
    from diffpir_tpu_torch.serve import RestorationService
    from diffpir_tpu_torch.server_http import start_server
    from diffpir_tpu_torch.utils import image as im
    from diffpir_tpu_torch.utils.imageio import decode_image
    from diffpir_tpu_torch.utils.png import encode_png

    out = {}
    over = {"save_E": False, "save_L": False}
    cfg = load_config("configs/demo256_inpaint.yaml", over)
    service = RestorationService(cfg, service_batch=4, max_wait_ms=2000)
    if service.runner.weights_provenance != "demo" or service.runner.device.type != "cuda":
        raise AssertionError(f"service weights {service.runner.weights_provenance!r} on "
                             f"{service.runner.device}: expected the trained prior on the card")
    warm_s = service.warmup((256, 256))
    httpd = start_server(service, port=0, host="127.0.0.1")
    host, port = httpd.server_address
    url = f"http://{host}:{port}"
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    log(f"serve: demo256 inpaint service on {url}, batch 4, max_wait 2000 ms, warm-up "
        f"{warm_s:.3f}s")
    try:
        np.random.seed(cfg.seed)
        items = prepare_images(cfg)
        gt = np.stack([it["img_H"] for it in items]).astype(np.float32) / 255.0
        forwards = forwards_per_batch(cfg)
        per_forward = {"groupnorm_silu": sum(c[0] == "gn" for c in calls256),
                       "legacy_qkv_attention": sum(c[0] == "attn" for c in calls256)}

        # four concurrent requests: one coalesced launch
        restores, batches = [], []  # seconds of each service.restore; batch sizes
        orig_restore = service.restore

        def timed_restore(*a, **kw):
            t0 = time.perf_counter()
            result = orig_restore(*a, **kw)  # fetched: the card's work is done
            restores.append(time.perf_counter() - t0)
            return result

        service.restore = timed_restore
        orig_restore_batch = service.runner.restore_batch

        def counting(batch, *a, **kw):
            batches.append(len(batch.names))
            return orig_restore_batch(batch, *a, **kw)

        service.runner.restore_batch = counting
        answers = [None] * len(items)

        def call(i):
            body = npz_bytes(image=items[i]["img_L"], mask=items[i]["mask"])
            t0 = time.perf_counter()
            answers[i] = http_post(opener, url + "/restore", body, "application/x-npz") + (
                time.perf_counter() - t0,)

        def http_round():
            threads = [threading.Thread(target=call, args=(i,)) for i in range(len(items))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=900)
            if any(t.is_alive() for t in threads):
                raise AssertionError("an HTTP request did not return")

        LAUNCHES.clear()
        FN_CALLS.clear()
        t0 = time.perf_counter()
        http_round()
        wall = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        restored = []
        for i, (code, ctype, body, _) in enumerate(answers):
            if code != 200 or ctype != "application/x-npz":
                raise AssertionError(f"request {i}: {code} {ctype} {body[:200]!r}")
            with np.load(io.BytesIO(body)) as z:
                restored.append(z["restored"])
        restored = np.stack(restored)
        if restored.shape != gt.shape or not np.isfinite(restored).all():
            raise AssertionError(f"answers of shape {restored.shape}, finite "
                                 f"{np.isfinite(restored).all()}")
        psnr = im.psnr_batch(restored * 2 - 1, gt * 2 - 1)
        want = {k: v * forwards for k, v in per_forward.items()}
        if batches != [len(items)] or launches != want:
            raise AssertionError(f"the {len(items)} requests ran as batches {batches} with "
                                 f"launches {launches}; expected one batch, {want}")
        if FN_CALLS:
            raise AssertionError(f"the serve path entered autograd.Functions: "
                                 f"{dict(FN_CALLS)}")
        if not abs(psnr - JAX_DEMO256_INPAINT_PSNR) <= PSNR_TOL_DB:
            raise AssertionError(f"served PSNR {psnr} is not within {PSNR_TOL_DB} dB of "
                                 f"the JAX package's {JAX_DEMO256_INPAINT_PSNR}")
        with opener.open(url + "/stats", timeout=60) as r:
            stats = json.loads(r.read())
        batch_s = restores[0]
        out.update(launches=launches, psnr=psnr, forwards=forwards, wall_s=wall,
                   client_latency_s=[a[3] for a in answers],
                   p50_latency_s=stats["p50_latency_s"],
                   p95_latency_s=stats["p95_latency_s"], batch_s=batch_s,
                   images_per_s=len(items) / batch_s,
                   ms_per_nfe=batch_s * 1e3 / forwards, cli_ms_per_nfe=cli_ms_nfe)
        log(f"serve: {len(items)} concurrent npz requests -> one batch, launches "
            f"{launches} ({forwards} forwards x {per_forward}); PSNR {psnr:.4f} dB (JAX "
            f"CPU {JAX_DEMO256_INPAINT_PSNR:.4f}); latency p50 "
            f"{stats['p50_latency_s']:.4f}s p95 {stats['p95_latency_s']:.4f}s (/stats; the "
            f"first request waits out max_wait for more); coalesced batch {batch_s:.4f}s = "
            f"{len(items) / batch_s:.4f} img/s, {batch_s * 1e3 / forwards:.4f} ms per NFE "
            f"(the CLI's demo256 inpaint in phase tasks: {cli_ms_nfe:.4f})")

        # the same batch through the worker thread without HTTP (submit from
        # this thread), through service.restore and through the runner alone
        # on this thread, in turns with HTTP: what the handler threads and
        # the service's host work cost the dispatching thread
        obs = [it["img_L"] for it in items]
        masks = [it["mask"] for it in items]
        cli_batch = make_batches(items, len(items))[0]
        nfe_ms = {"http": [out["ms_per_nfe"]], "submit": [], "restore": [], "runner": []}
        order = ("submit", "restore", "runner")
        for kind in order:
            restores.clear()
            t0 = time.perf_counter()
            if kind == "http":
                http_round()
            elif kind == "submit":
                futs = [service.submit(o, mask=m) for o, m in zip(obs, masks)]
                [f.result(timeout=900) for f in futs]
            elif kind == "restore":
                service.restore(obs, masks=masks)
            else:
                orig_restore_batch(cli_batch, seed=0)  # fetched
                restores.append(time.perf_counter() - t0)
            nfe_ms[kind].append(restores[0] * 1e3 / forwards)
        out["ms_per_nfe_by_route"] = nfe_ms
        log(f"serve: ms per NFE of the same batch, in turns http, {', '.join(order)}: "
            f"{nfe_ms}")

        # the service is transparent: service.restore == runner.restore_batch
        restores.clear()
        handed = []
        service.runner.restore_batch = lambda batch, *a, **kw: (
            handed.append((batch, kw.get("seed"))) or orig_restore_batch(batch, *a, **kw))
        via_service = np.stack(service.restore(obs, masks=masks, seed=7))
        service.runner.restore_batch = orig_restore_batch
        (batch, seed), = handed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        direct = orig_restore_batch(batch, seed=seed)
        direct_s = time.perf_counter() - t0
        delta = float(np.abs(via_service - direct).max())
        out.update(transparency_max_abs=delta, direct_service_ms_per_nfe=restores[0] * 1e3
                   / forwards, direct_runner_ms_per_nfe=direct_s * 1e3 / forwards)
        log(f"serve: service.restore vs runner.restore_batch (seed {seed}): max |diff| "
            f"{delta:.3e}; ms per NFE without HTTP: service "
            f"{out['direct_service_ms_per_nfe']:.4f}, runner "
            f"{out['direct_runner_ms_per_nfe']:.4f}")
        if not delta <= 1e-6:
            raise AssertionError(f"service.restore differs from restore_batch by {delta}")

        # a bad request gets 400 and the server answers the next: a PNG of
        # a size the UNet cannot take as it is (padded to 256, cropped back)
        bad_mask = items[0]["mask"] * 0.5
        code, _, body = http_post(opener, url + "/restore",
                                  npz_bytes(image=items[0]["img_L"], mask=bad_mask),
                                  "application/x-npz")
        if code != 400 or b"binary" not in body:
            raise AssertionError(f"a non-binary mask got {code} {body[:200]!r}")
        png = encode_png(items[1]["img_H"][:250, :240])
        code, ctype, body = http_post(opener, url + "/restore", png, "image/png")
        shape = decode_image(body).shape if code == 200 and ctype == "image/png" else None
        if shape != (250, 240, 3):
            raise AssertionError(f"PNG request: {code} {ctype} shape {shape}")
        log(f"serve: non-binary mask -> 400; then a 250x240 PNG -> 200, a PNG of {shape}")

        # deblur on a second service: a Levin09 PSF of odd size, padded to a
        # multiple of 8
        dcfg = load_config("configs/demo256_deblur.yaml", {**over, "iter_num": 20})
        deblur = RestorationService(dcfg)
        np.random.seed(dcfg.seed)
        ditem = prepare_images(dcfg)[0]
        kernels_seen = []
        orig_d = deblur.runner.restore_batch
        deblur.runner.restore_batch = lambda batch, *a, **kw: (
            kernels_seen.append(batch.kernel.shape) or orig_d(batch, *a, **kw))
        (dout,) = deblur.restore([ditem["img_L"]], kernels=[ditem["kernel"]])
        dpsnr = im.psnr_batch(dout[None] * 2 - 1, ditem["img_H"][None] / 127.5 - 1)
        if (kernels_seen != [(4, 24, 24)] or ditem["kernel"].shape != (19, 19)
                or not np.isfinite(dout).all()):
            raise AssertionError(f"deblur: PSF {ditem['kernel'].shape} handed as "
                                 f"{kernels_seen}, finite {np.isfinite(dout).all()}")
        log(f"serve: deblur service (20 NFE), Levin09 PSF {ditem['kernel'].shape} padded to "
            f"{kernels_seen[0][1:]}: finite, PSNR {dpsnr:.4f} dB")
        out["deblur_psnr_20nfe"] = dpsnr
        del deblur

        # the .pt route: demo256's weights out to guided-diffusion's layout,
        # through torch.save/torch.load(weights_only=True), back in
        npz_model = service.runner.model
        buf = io.BytesIO()
        torch.save(convert.to_guided_state_dict(npz_model.state_dict()), buf)
        buf.seek(0)
        pt_model = UNet(npz_model.cfg, dtype=npz_model.dtype)
        pt_model.load_state_dict(convert.convert_state_dict(
            torch.load(buf, map_location="cpu", weights_only=True)))
        pt_model = pt_model.to(dev).eval()
        x = torch.randn((4, 256, 256, 3), generator=gen, device=dev)
        t = torch.tensor([999, 500, 250, 10], dtype=torch.int32, device=dev)
        with torch.no_grad():
            same = torch.equal(pt_model(x, t), npz_model(x, t))
        log(f"serve: demo256 through a .pt state dict in memory: forward equal to the "
            f"npz-loaded model's: {same}")
        if not same:
            raise AssertionError("the .pt round trip changed the demo256 forward")
        del pt_model

        # 256x256_diffusion_uncond (553M), seeded random weights in
        # guided-diffusion's layout, converted; one bf16 forward at batch 1
        ucfg = zoo.MODEL_ZOO_CONFIGS["256x256_diffusion_uncond"]
        guided = convert.to_guided_state_dict(zoo.init_random_(UNet(ucfg), 0).state_dict())
        port_sd = convert.convert_state_dict(guided)
        del guided
        fwd = {}
        x1 = torch.randn((1, 256, 256, 3), generator=gen, device=dev)
        for route in ("cuda", "plain"):
            m = UNet(ucfg, dtype=torch.bfloat16, kernels=route)
            m.load_state_dict(port_sd)
            m = m.to(dev).eval()
            LAUNCHES.clear()
            with torch.no_grad():
                fwd[route] = m(x1, t[:1]).float()
            torch.cuda.synchronize()
            fwd[route + "_launches"] = dict(LAUNCHES)
            del m
        torch.cuda.empty_cache()
        rel = float((fwd["cuda"] - fwd["plain"]).abs().max() / fwd["plain"].abs().max())
        n553 = per_fwd[("uncond553m b1", "gn")]["calls"], per_fwd[("uncond553m b1",
                                                                    "attn")]["calls"]
        want553 = {"groupnorm_silu": n553[0], "legacy_qkv_attention": n553[1]}
        log(f"serve: 256x256_diffusion_uncond (553M) from a guided-diffusion state dict, "
            f"bf16 b1: max |kernel - plain| / max |plain| = {rel:.3e}; launches "
            f"{fwd['cuda_launches']} (plain {fwd['plain_launches']})")
        if fwd["cuda_launches"] != want553 or fwd["plain_launches"]:
            raise AssertionError(f"553M launches {fwd['cuda_launches']}, expected {want553}")
        if not rel <= FLAGSHIP_FORWARD_REL_TOL:
            raise AssertionError(f"553M forward differs by {rel} (relative)")
        out["uncond553m_forward_rel"] = rel

        # the same weights under num_heads 4, num_head_channels -1: heads of
        # 128 and 256 channels, every attention call on attn_bf16_any
        h4cfg = dataclasses.replace(ucfg, **UNCOND_4HEADS)
        fwd4 = {}
        for route in ("cuda", "plain"):
            m = UNet(h4cfg, dtype=torch.bfloat16, kernels=route)
            m.load_state_dict(port_sd)
            m = m.to(dev).eval()
            LAUNCHES.clear()
            kat.VARIANT_LAUNCHES.clear()
            with torch.no_grad():
                fwd4[route] = m(x1, t[:1]).float()
            torch.cuda.synchronize()
            fwd4[route + "_launches"] = dict(LAUNCHES)
            fwd4[route + "_variants"] = dict(kat.VARIANT_LAUNCHES)
            del m
        rel4 = float((fwd4["cuda"] - fwd4["plain"]).abs().max() / fwd4["plain"].abs().max())
        want4 = {"groupnorm_silu": UNCOND_GROUPNORMS, "legacy_qkv_attention": UNCOND_4HEADS_ATTN}
        recorded4 = {"groupnorm_silu": per_fwd[("uncond553m 4 heads b1", "gn")]["calls"],
                     "legacy_qkv_attention": per_fwd[("uncond553m 4 heads b1", "attn")]["calls"]}
        if recorded4 != want4:
            raise AssertionError(f"the four-head 553M forward records {recorded4} calls, "
                                 f"expected {want4}")
        per4 = {b_: per_fwd[(f"uncond553m 4 heads b{b_}", "attn")] for b_ in (1, 8)}
        log(f"serve: 256x256_diffusion_uncond with num_heads 4, num_head_channels -1, same "
            f"weights, bf16 b1: max |kernel - plain| / max |plain| = {rel4:.3e}; launches "
            f"{fwd4['cuda_launches']}, attention by variant {fwd4['cuda_variants']} (plain "
            f"{fwd4['plain_launches']}); attention per forward (phase kernels, device ms): "
            + "; ".join(f"b{b_} kernel {p['ms']:.4f} plain {p['plain_ms']:.4f} SDPA "
                        f"{p['library_ms']:.4f} bound {p['bound_ms']:.4f} ({p['bound_by']})"
                        for b_, p in per4.items()))
        if (fwd4["cuda_launches"] != want4 or fwd4["plain_launches"]
                or fwd4["cuda_variants"] != {"bf16_any": UNCOND_4HEADS_ATTN}):
            raise AssertionError(f"four-head 553M launches {fwd4['cuda_launches']} "
                                 f"{fwd4['cuda_variants']}, expected {want4} on bf16_any")
        if not rel4 <= FLAGSHIP_FORWARD_REL_TOL:
            raise AssertionError(f"four-head 553M forward differs by {rel4} (relative)")
        out["uncond553m_4heads_forward_rel"] = rel4
        out["uncond553m_4heads_variants"] = fwd4["cuda_variants"]
        out["uncond553m_4heads_attention_per_forward"] = {
            f"b{b_}": {k: p[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                                        "calls")} for b_, p in per4.items()}

        # the same weights under UNCOND_4HEADS in fp32: every attention call
        # on attn_f32_any (split-TF32 products), at the fp32 parity bar
        fwd4f = {}
        for route in ("cuda", "plain"):
            m = UNet(h4cfg, dtype=torch.float32, kernels=route)
            m.load_state_dict(port_sd)
            m = m.to(dev).eval()
            LAUNCHES.clear()
            kat.VARIANT_LAUNCHES.clear()
            with torch.no_grad():
                fwd4f[route] = m(x1, t[:1]).float()
            torch.cuda.synchronize()
            fwd4f[route + "_launches"] = dict(LAUNCHES)
            fwd4f[route + "_variants"] = dict(kat.VARIANT_LAUNCHES)
            del m
        torch.cuda.empty_cache()
        rel4f = float((fwd4f["cuda"] - fwd4f["plain"]).abs().max()
                      / fwd4f["plain"].abs().max())
        p4f = per_fwd[("uncond553m 4 heads fp32 b1", "attn")]
        log(f"serve: 256x256_diffusion_uncond with num_heads 4, num_head_channels -1, same "
            f"weights, fp32 b1: max |kernel - plain| / max |plain| = {rel4f:.3e} (bar "
            f"{UNCOND_FP32_FORWARD_REL_TOL}); launches {fwd4f['cuda_launches']}, attention by "
            f"variant {fwd4f['cuda_variants']} (plain {fwd4f['plain_launches']}); attention "
            f"per forward (phase kernels, device ms): kernel {p4f['ms']:.4f} plain "
            f"{p4f['plain_ms']:.4f} SDPA {p4f['library_ms']:.4f} bound {p4f['bound_ms']:.4f} "
            f"({p4f['bound_by']}, split-TF32 rate)")
        if (fwd4f["cuda_launches"] != want4 or fwd4f["plain_launches"]
                or fwd4f["cuda_variants"] != {"f32_any": UNCOND_4HEADS_ATTN}):
            raise AssertionError(f"fp32 four-head 553M launches {fwd4f['cuda_launches']} "
                                 f"{fwd4f['cuda_variants']}, expected {want4} on f32_any")
        if not bool(torch.isfinite(fwd4f["cuda"]).all()):
            raise AssertionError("the fp32 four-head 553M forward is not finite")
        if not rel4f <= UNCOND_FP32_FORWARD_REL_TOL:
            raise AssertionError(f"fp32 four-head 553M forward differs by {rel4f} (relative)")
        out["uncond553m_4heads_fp32_forward_rel"] = rel4f
        out["uncond553m_4heads_fp32_variants"] = fwd4f["cuda_variants"]
        out["uncond553m_4heads_fp32_attention_per_forward"] = {
            k: p4f[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "calls")}
        del port_sd

        # --profile: a Chrome trace of a 4-NFE tiny_demo32 run holds both kernels
        prof_dir = os.path.join(REPO, ".kernel_build", "profile")
        shutil.rmtree(prof_dir, ignore_errors=True)
        cli_main(["--opt", "configs/demo32_inpaint.yaml", "--no-sweep", "--set", "iter_num=5",
                  "--set", "save_E=false", "--set", "save_L=false", "--profile", prof_dir])
        with open(os.path.join(prof_dir, "trace.json")) as f:
            names = {ev.get("name", "") for ev in json.load(f)["traceEvents"]}
        shutil.rmtree(prof_dir)
        gn_names = sorted(n for n in names if "gn_stats" in n or "gn_apply" in n)
        attn_names = sorted(n for n in names if "attn_f32" in n or "attn_bf16" in n)
        log(f"serve: --profile trace: {len(names)} event names, GroupNorm {gn_names}, "
            f"attention {attn_names}")
        if not gn_names or not attn_names:
            raise AssertionError("the --profile trace lacks the port's kernels")
    finally:
        httpd.shutdown()
        service.close()
    return out


def train_grads(trainer, batch, t, noise, detach: bool = False):
    """(loss, {name: fp32 gradient}) of one step's loss at the trainer's
    weights, nothing updated; ``detach`` launches the kernels without their
    autograd.Functions (their outputs then carry no gradient: the control)."""
    import torch

    from diffpir_tpu_torch.kernels import attention as kat
    from diffpir_tpu_torch.kernels import groupnorm as kgn

    names, params = zip(*trainer.model.named_parameters())
    launches = (kgn.wants_grad, kat.wants_grad)
    if detach:
        kgn.wants_grad = kat.wants_grad = lambda *a: False
    try:
        ones = torch.ones((batch.shape[0],), device=batch.device)
        loss, _ = trainer._loss(batch, t, ones, noise)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
    finally:
        kgn.wants_grad, kat.wants_grad = launches
    return float(loss.detach()), {n: (torch.zeros_like(p) if g is None else g.float())
                         for n, p, g in zip(names, params, grads)}


def grad_bars(got: dict, ref: dict, groups: dict) -> tuple[dict, list]:
    """Relative L2 and cosine of each named gradient and of the whole
    flattened gradient; returns them and the names that miss the bf16 bars."""
    import torch

    rows = {n: grad_agreement(got[n].double(), ref[n].double())
            for names in groups.values() for n in names}
    rows["all"] = grad_agreement(torch.cat([got[n].flatten() for n in ref]),
                                 torch.cat([ref[n].flatten() for n in ref]))
    bad = [n for n, (rel, cos) in rows.items()
           if not (rel <= GRAD_REL_TOL["bfloat16"] and cos >= GRAD_MIN_COSINE["bfloat16"])]
    return rows, bad


def train_phase(dev, root: str) -> dict:
    """Phase train (see the module docstring).  Returns what the record line
    and the log report."""
    import dataclasses
    import glob
    import tempfile

    import torch

    from diffpir_tpu_torch.diffusion import Diffusion, ModelMeanType, ModelVarType
    from diffpir_tpu_torch.kernels import LAUNCHES
    from diffpir_tpu_torch.kernels import attention as kat
    from diffpir_tpu_torch.kernels import groupnorm as kgn
    from diffpir_tpu_torch.models import zoo
    from diffpir_tpu_torch.models.unet import (AttentionBlock, GroupNorm32, ResBlock,
                                               UNet)
    from diffpir_tpu_torch.schedule import NoiseSchedule
    from diffpir_tpu_torch.train.demo import synth_batch
    from diffpir_tpu_torch.train.loop import TrainConfig, Trainer

    out = {}
    diff = Diffusion(NoiseSchedule.linear(1e-4, 0.02, 1000), ModelMeanType.EPSILON,
                     ModelVarType.LEARNED_RANGE)
    tcfg = TrainConfig(lr=1e-4, ema_rates=(0.999,), compute_dtype="bfloat16")
    flat = zoo.load_params_npz(os.path.join(REPO, "assets", "demo", "demo256.flax.npz"))

    def demo_trainer(route):
        model = UNet(zoo.DEMO256_CONFIG, dtype=torch.bfloat16, kernels=route,
                     param_dtype=torch.float32)
        model.load_state_dict(zoo.flax_to_torch(flat))
        trainer = Trainer(model.to(dev), diff, tcfg)
        return trainer, trainer.init_state(seed=None)

    trainers = {route: demo_trainer(route) for route in ("cuda", "plain")}
    trainer, state = trainers["cuda"]
    # the inputs of tests/test_torch_train_demo.py::train_inputs
    pool_np = synth_batch(np.random.default_rng(TRAIN_POOL_SEED), TRAIN_POOL_SIZE, 256,
                          rich=True)
    idx = np.random.default_rng(0).integers(0, TRAIN_POOL_SIZE, (1, TRAIN_BATCH))[0]
    rng = np.random.default_rng(0)
    t = torch.from_numpy(rng.integers(0, 1000, TRAIN_BATCH)).to(dev)
    noise = torch.from_numpy(rng.standard_normal((TRAIN_BATCH, 256, 256, 3),
                                                 dtype=np.float32)).to(dev)
    pool = torch.from_numpy(pool_np).to(dev)
    batch = pool[torch.from_numpy(idx).to(dev)]

    # (b) kernels against plain, and the detached control
    groups = {"groupnorm": [], "emb_proj": [], "qkv": []}
    for name, mod in trainer.model.named_modules():
        if isinstance(mod, GroupNorm32):
            groups["groupnorm"] += [f"{name}.weight", f"{name}.bias"]
        elif isinstance(mod, ResBlock):
            groups["emb_proj"] += [f"{name}.emb_proj.weight", f"{name}.emb_proj.bias"]
        elif isinstance(mod, AttentionBlock):
            groups["qkv"].append(f"{name}.qkv.weight")
    LAUNCHES.clear()
    FN_CALLS.clear()
    loss_k, g_k = train_grads(trainer, batch, t, noise)
    grad_launches, grad_fn = dict(LAUNCHES), dict(FN_CALLS)
    loss_p, g_p = train_grads(trainers["plain"][0], batch, t, noise)
    loss_d, g_d = train_grads(trainer, batch, t, noise, detach=True)
    rows, bad = grad_bars(g_k, g_p, groups)
    rows_d, bad_d = grad_bars(g_d, g_p, groups)
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    worst = max((r for n, r in rows.items() if n != "all"), key=lambda r: r[0])
    log(f"train: demo256 b{TRAIN_BATCH} bf16 gradient, kernels vs plain: loss "
        f"{loss_k:.6f} vs {loss_p:.6f} (rel {loss_rel:.3e}, bound "
        f"{TRAIN_KERNEL_LOSS_REL_TOL}); whole gradient rel L2 {rows['all'][0]:.3e} cosine "
        f"{rows['all'][1]:.6f}; worst of {len(rows) - 1} named (GroupNorm "
        f"{len(groups['groupnorm'])}, emb_proj {len(groups['emb_proj'])}, qkv "
        f"{len(groups['qkv'])}) rel L2 {worst[0]:.3e} cosine {worst[1]:.6f}; misses "
        f"{bad}; launches {grad_launches}, Function entries {grad_fn}; detached "
        f"control: whole rel L2 {rows_d['all'][0]:.3e} cosine {rows_d['all'][1]:.6f}, "
        f"{len(bad_d)} of {len(rows_d)} miss")
    if not loss_rel <= TRAIN_KERNEL_LOSS_REL_TOL or bad:
        raise AssertionError(f"train gradient through the kernels differs from the "
                             f"plain one: loss rel {loss_rel}, misses {bad}")
    if not bad_d:
        raise AssertionError("the detached control passes the gradient bars, so the "
                             "check could not see a lost gradient")
    if grad_fn != grad_launches or set(grad_launches) != {"groupnorm_silu",
                                                          "legacy_qkv_attention"}:
        raise AssertionError(f"a train forward launched {grad_launches} with Function "
                             f"entries {grad_fn}: every launch must enter its Function")
    out["grad"] = dict(loss_rel=loss_rel, all=rows["all"], worst_named=worst,
                       control_all=rows_d["all"], control_misses=len(bad_d))
    del g_k, g_p, g_d

    # (a) the first step against the JAX package's fp32 CPU terms
    with torch.no_grad():
        terms = diff.training_losses(lambda x, tv: trainer.model(x, tv), batch, t, noise)
    mse = float(terms["mse"].mean())
    state, m = trainer.train_step(state, batch, t=t, noise=noise)
    loss = float(m["loss"])
    mse_rel = abs(mse - JAX_DEMO256_STEP_MSE) / JAX_DEMO256_STEP_MSE
    loss_rel = abs(loss - JAX_DEMO256_STEP_LOSS) / JAX_DEMO256_STEP_LOSS
    log(f"train: demo256 first step mean mse {mse:.6f} (JAX CPU fp32 "
        f"{JAX_DEMO256_STEP_MSE:.6f}, rel {mse_rel:.3e}), loss {loss:.6f} (JAX "
        f"{JAX_DEMO256_STEP_LOSS:.6f}, rel {loss_rel:.3e}), grad_norm "
        f"{float(m['grad_norm']):.4f}")
    if not (mse_rel <= TRAIN_MSE_REL_TOL and loss_rel <= TRAIN_LOSS_REL_TOL):
        raise AssertionError(f"first step mse {mse} / loss {loss} not within "
                             f"{TRAIN_MSE_REL_TOL} / {TRAIN_LOSS_REL_TOL} of JAX's")
    out["first_step"] = dict(mse=mse, loss=loss, mse_rel=mse_rel, loss_rel=loss_rel)

    # (d) timed steps, each route: events around the forward (the loss), the
    # update and each Function backward
    def timed_steps(route, n_warm=2, n_timed=10):
        tr, st = trainers[route]
        events = {"fwd": [], "upd": [], "fn_bwd": [], "step": []}

        def bracket(kind, fn):
            def wrapped(*a, **kw):
                e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                e0.record()
                r = fn(*a, **kw)
                e1.record()
                events[kind].append((e0, e1))
                return r
            return wrapped

        orig = {(cls, "backward"): cls.backward for cls in
                (kgn.GroupNormSiLUFunction, kat.LegacyQKVAttentionFunction)}
        tr._loss = bracket("fwd", tr._loss)
        tr._update = bracket("upd", tr._update)
        for cls, _ in orig:
            cls.backward = staticmethod(bracket("fn_bwd", cls.backward))
        gen = torch.Generator(dev).manual_seed(1)
        prng = np.random.default_rng(0)
        step = bracket("step", lambda s, i: tr.train_steps_from_pool(s, pool, i, gen))
        try:
            for i in range(n_warm + n_timed):
                ix = torch.from_numpy(prng.integers(0, TRAIN_POOL_SIZE, (1, TRAIN_BATCH))
                                      .astype(np.int32)).to(dev)
                if i == n_warm:
                    torch.cuda.synchronize()
                    for v in events.values():
                        v.clear()
                    LAUNCHES.clear()
                    FN_CALLS.clear()
                    torch.cuda.reset_peak_memory_stats()
                    t0 = time.perf_counter()
                st, _ = step(st, ix)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / n_timed
        finally:
            del tr._loss, tr._update
            for (cls, _), fn in orig.items():
                cls.backward = fn
        trainers[route] = (tr, st)
        ms = {k: sum(a.elapsed_time(b) for a, b in v) / n_timed for k, v in events.items()}
        return dict(ms_per_step=wall * 1e3, img_per_s=TRAIN_BATCH / wall,
                    peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                    event_step_ms=ms["step"], forward_ms=ms["fwd"],
                    update_ms=ms["upd"],
                    backward_ms=ms["step"] - ms["fwd"] - ms["upd"],
                    function_backward_ms=ms["fn_bwd"],
                    launches_per_step={k: v / n_timed for k, v in LAUNCHES.items()},
                    fn_entries_per_step={k: v / n_timed for k, v in FN_CALLS.items()})

    steps = {}
    for route in ("cuda", "plain", "plain", "cuda"):
        r = timed_steps(route)
        steps.setdefault(route, []).append(r)
        log(f"train: demo256 b{TRAIN_BATCH} bf16 {route} route, 10 steps: "
            f"{r['ms_per_step']:.3f} ms/step, {r['img_per_s']:.3f} img/s, peak "
            f"{r['peak_gb']:.3f} GB; events per step: step {r['event_step_ms']:.3f}, "
            f"forward {r['forward_ms']:.3f}, backward {r['backward_ms']:.3f} (Function "
            f"backwards {r['function_backward_ms']:.3f}), update {r['update_ms']:.3f} ms; "
            f"launches {r['launches_per_step']}, Function entries "
            f"{r['fn_entries_per_step']} per step")
    want = {"groupnorm_silu": 65.0, "legacy_qkv_attention": 4.0}
    for r in steps["cuda"]:
        if r["launches_per_step"] != want or r["fn_entries_per_step"] != want:
            raise AssertionError(f"a train step launched {r['launches_per_step']} with "
                                 f"Function entries {r['fn_entries_per_step']}, expected "
                                 f"{want} of each")
    for r in steps["plain"]:
        if r["launches_per_step"]:
            raise AssertionError(f"the plain route launched {r['launches_per_step']}")
    out["steps"] = steps
    out["launches_per_step"] = steps["cuda"][0]["launches_per_step"]
    del trainers["plain"]

    # (e) the EMA through a .flax.npz and the port's zoo: a bit-equal forward
    trainer, state = trainers["cuda"]
    ema_model = UNet(zoo.DEMO256_CONFIG, dtype=torch.bfloat16,
                     param_dtype=torch.float32).to(dev).eval()
    ema_model.load_state_dict(state["ema"][0])
    x_probe = torch.randn((4, 256, 256, 3), generator=torch.Generator(dev).manual_seed(3),
                          device=dev)
    t_probe = torch.tensor([999, 500, 250, 10], dtype=torch.int32, device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        zoo.save_params_npz(zoo.torch_to_flax(state["ema"][0]),
                            os.path.join(tmp, "demo256.flax.npz"))
        loaded = zoo.resolve_model("demo256", tmp, dtype=torch.bfloat16, device=dev)
    with torch.no_grad():
        equal = torch.equal(ema_model(x_probe, t_probe), loaded.model(x_probe, t_probe))
    log(f"train: EMA -> .flax.npz -> zoo.resolve_model (provenance {loaded.provenance}): "
        f"forward bit-equal {equal}")
    if not equal or loaded.provenance != "cache":
        raise AssertionError("the EMA round trip through .flax.npz changed the forward")
    del trainers, trainer, state, ema_model, loaded, pool
    torch.cuda.empty_cache()

    # tiny from scratch, fp32, as a user runs the demo trainer
    with tempfile.TemporaryDirectory() as tmp:
        env = dict(os.environ, DIFFPIR_LOG_FORMAT="csv", TMPDIR=tmp,
                   PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
        cmd = [sys.executable, "-m", "diffpir_tpu_torch.train.demo", *TINY_TRAIN_ARGS,
               "--out", os.path.join(tmp, "tiny.flax.npz")]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=root, env=env, capture_output=True, text=True,
                              timeout=600)
        wall = time.perf_counter() - t0
        if proc.returncode:
            raise AssertionError(f"{' '.join(cmd)} failed:\n{proc.stdout[-3000:]}\n"
                                 f"{proc.stderr[-3000:]}")
        (csv_path,) = glob.glob(os.path.join(tmp, "diffpir-*", "progress.csv"))
        losses = read_losses(csv_path)
        zoo.load_params_npz(os.path.join(tmp, "tiny.flax.npz"))
    ratio = float(np.mean(losses[-20:]) / np.mean(losses[:20]))
    log(f"train: tiny from scratch ({' '.join(TINY_TRAIN_ARGS)}, fp32): {len(losses)} "
        f"steps in {wall:.3f}s, loss first 20 {np.mean(losses[:20]):.5f}, last 20 "
        f"{np.mean(losses[-20:]):.5f}, ratio {ratio:.4f} (bound {TINY_LOSS_RATIO_MAX}; "
        f"JAX CPU {JAX_TINY_LOSS_RATIO:.4f}, other draws)")
    if len(losses) != 200 or not ratio <= TINY_LOSS_RATIO_MAX:
        raise AssertionError(f"tiny from scratch: {len(losses)} steps, ratio {ratio}")
    out["tiny"] = dict(ratio=ratio, seconds=wall)

    # 553M, bf16, 256 px, seeded random weights: remat against none, then b4 steps
    cfg553 = zoo.MODEL_ZOO_CONFIGS["256x256_diffusion_uncond"]
    model = zoo.init_random_(UNet(cfg553, dtype=torch.bfloat16, param_dtype=torch.float32),
                             0).to(dev)
    big = Trainer(model, diff, TrainConfig(lr=1e-4, ema_rates=(0.9999,),
                                           compute_dtype="bfloat16"))
    brng = np.random.default_rng(0)
    x2 = torch.from_numpy(brng.uniform(-1, 1, (2, 256, 256, 3)).astype(np.float32)).to(dev)
    t2 = torch.from_numpy(brng.integers(0, 1000, 2)).to(dev)
    n2 = torch.from_numpy(brng.standard_normal((2, 256, 256, 3), dtype=np.float32)).to(dev)
    res = {}
    for remat in (False, True):
        model.cfg = dataclasses.replace(cfg553, use_remat=remat)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        LAUNCHES.clear()
        loss_r, g = train_grads(big, x2, t2, n2)
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 1e9
        res[remat] = (loss_r, torch.cat([v.flatten() for v in g.values()]), peak,
                      dict(LAUNCHES))
        del g
    rel_loss = abs(res[True][0] - res[False][0]) / abs(res[False][0])
    rel_g, cos_g = grad_agreement(res[True][1], res[False][1])
    log(f"train: 553M b2 bf16 remat vs none: loss {res[True][0]:.6f} vs "
        f"{res[False][0]:.6f} (rel {rel_loss:.3e}, bound {REMAT_LOSS_REL_TOL}), gradient "
        f"rel L2 {rel_g:.3e} cosine {cos_g:.6f} (bound {REMAT_GRAD_REL_TOL}); peak above "
        f"the weights {res[True][2]:.3f} GB with remat, {res[False][2]:.3f} GB without; "
        f"launches {res[True][3]} with remat, {res[False][3]} without")
    if not (rel_loss <= REMAT_LOSS_REL_TOL and rel_g <= REMAT_GRAD_REL_TOL
            and res[True][2] < res[False][2]):
        raise AssertionError("553M remat and no remat disagree, or remat saves no memory")
    out["remat"] = dict(loss_rel=rel_loss, grad_rel=rel_g, peak_gb_remat=res[True][2],
                        peak_gb_none=res[False][2])
    del res

    state = big.init_state(seed=None)
    x4 = torch.from_numpy(brng.uniform(-1, 1, (4, 256, 256, 3)).astype(np.float32)).to(dev)
    gen = torch.Generator(dev).manual_seed(2)
    state, _ = big.train_step(state, x4, gen)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.clear()
    t0 = time.perf_counter()
    for _ in range(3):
        state, m = big.train_step(state, x4, gen)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / 3
    loss = float(m["loss"])
    log(f"train: 553M b4 bf16 remat, 3 steps: {wall * 1e3:.3f} ms/step, "
        f"{4 / wall:.3f} img/s, peak {torch.cuda.max_memory_allocated() / 1e9:.3f} GB, "
        f"loss {loss:.5f}, launches per step "
        f"{ {k: v / 3 for k, v in LAUNCHES.items()} }")
    if not np.isfinite(loss):
        raise AssertionError(f"553M train step loss {loss}")
    out["uncond553m_b4"] = dict(ms_per_step=wall * 1e3, img_per_s=4 / wall,
                                peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    del big, model, state
    torch.cuda.empty_cache()
    return out


def classifier_logp_grad(model, x, t, y):
    """d sum_i log p(y_i | x_i, t_i) / dx through ``model`` (fp32 result)."""
    import torch

    with torch.enable_grad():
        xv = x.detach().float().requires_grad_()
        logits = model(xv, t).float()
        logp = torch.log_softmax(logits, dim=-1)[torch.arange(x.shape[0], device=x.device), y]
        if not logp.requires_grad:  # every path to x cut (the detached control)
            return torch.zeros_like(xv)
        (g,) = torch.autograd.grad(logp.sum(), xv)
    return g


def variants_phase(dev, gen) -> dict:
    """The guided-diffusion 256x256 classifier (CLASSIFIER_256, seeded random
    weights as an ``EncoderUNetModel`` state dict read through
    ``models/convert.py``, bf16, batch 8) through both kernels: logits and
    d log p(y|x_t)/dx against the plain versions (a detached control must
    fail the gradient bars), a ``.pt`` round trip, GUIDED_STEPS
    classifier-guided ``p_sample`` steps over the demo256 prior against the
    unguided steps with the same noise, and a ``SuperResUNet`` forward at the
    DEMO256 widths (6 input channels, a 64 px ``low_res``)."""
    import dataclasses
    import io

    import torch

    from diffpir_tpu_torch.diffusion import Diffusion, ModelMeanType, ModelVarType
    from diffpir_tpu_torch.kernels import LAUNCHES
    from diffpir_tpu_torch.kernels import attention as kat
    from diffpir_tpu_torch.kernels import groupnorm as kgn
    from diffpir_tpu_torch.models import convert, zoo
    from diffpir_tpu_torch.models.unet import UNetConfig
    from diffpir_tpu_torch.models.variants import EncoderUNet, SuperResUNet
    from diffpir_tpu_torch.schedule import NoiseSchedule

    out = {}
    cfg = UNetConfig(**CLASSIFIER_256)
    b = CLASSIFIER_BATCH
    guided_sd = convert.to_guided_state_dict(
        zoo.init_random_(EncoderUNet(cfg, pool="attention"), 0).state_dict())
    sd = convert.convert_state_dict(guided_sd)
    models = {}
    for route in ("cuda", "plain"):
        m = EncoderUNet(cfg, pool="attention", dtype=torch.bfloat16, kernels=route)
        m.load_state_dict(sd)
        models[route] = m.to(dev).eval().requires_grad_(False)
    out["params"] = sum(p.numel() for p in models["cuda"].parameters())
    x = torch.randn((b, 256, 256, 3), generator=gen, device=dev)
    t = torch.randint(0, 1000, (b,), generator=gen, device=dev)
    y = torch.randint(0, cfg.out_channels, (b,), generator=gen, device=dev)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()

    # 1. logits, kernels against plain
    LAUNCHES.clear()
    with torch.no_grad():
        lk = models["cuda"](x, t).float()
    torch.cuda.synchronize()
    out["launches_per_forward"] = dict(LAUNCHES)
    LAUNCHES.clear()
    with torch.no_grad():
        lp = models["plain"](x, t).float()
    if sum(LAUNCHES.values()):
        raise AssertionError(f"the plain classifier launched kernels: {dict(LAUNCHES)}")
    if out["launches_per_forward"] != CLASSIFIER_CALLS:
        raise AssertionError(f"classifier launches {out['launches_per_forward']}, "
                             f"expected {CLASSIFIER_CALLS}")
    if not (bool(torch.isfinite(lk).all()) and lk.shape == (b, cfg.out_channels)):
        raise AssertionError(f"classifier logits {tuple(lk.shape)} are not finite")
    out["logits_rel"] = float((lk - lp).abs().max() / lp.abs().max())
    out["argmax_agree"] = int((lk.argmax(-1) == lp.argmax(-1)).sum())
    if not out["logits_rel"] <= FLAGSHIP_FORWARD_REL_TOL:
        raise AssertionError(f"classifier logits differ by {out['logits_rel']} (relative)")
    with torch.no_grad():
        out["forward_ms"] = timed_ms(lambda: models["cuda"](x, t), iters=10)
        out["plain_forward_ms"] = timed_ms(lambda: models["plain"](x, t), iters=10)

    # 2. d log p(y|x_t)/dx through the Functions against plain autograd
    FN_CALLS.clear()
    gk = classifier_logp_grad(models["cuda"], x, t, y).double()
    out["function_entries"] = dict(FN_CALLS)
    if out["function_entries"] != CLASSIFIER_CALLS:
        raise AssertionError(f"classifier gradient entered the Functions "
                             f"{out['function_entries']}, expected {CLASSIFIER_CALLS}")
    gp = classifier_logp_grad(models["plain"], x, t, y).double()
    saved = (kgn.wants_grad, kat.wants_grad)
    kgn.wants_grad = kat.wants_grad = lambda *a: False
    try:
        gd = classifier_logp_grad(models["cuda"], x, t, y).double()
    finally:
        kgn.wants_grad, kat.wants_grad = saved
    rel, cos = grad_agreement(gk, gp)
    rel_d, cos_d = grad_agreement(gd, gp)
    tol, min_cos = GRAD_REL_TOL["bfloat16"], GRAD_MIN_COSINE["bfloat16"]
    out.update(grad_rel_l2=rel, grad_cosine=cos, detached_rel_l2=rel_d,
               detached_cosine=cos_d)
    if not (rel <= tol and cos >= min_cos):
        raise AssertionError(f"classifier gradient through the kernels differs from "
                             f"the plain one (rel {rel}, cosine {cos})")
    if rel_d <= tol and cos_d >= min_cos:
        raise AssertionError("the detached control passes the gradient bounds")
    out["forward_backward_ms"] = timed_ms(
        lambda: classifier_logp_grad(models["cuda"], x, t, y), iters=5)

    # 3. a .pt round trip of the guided-diffusion state dict: bit-equal logits
    buf = io.BytesIO()
    torch.save(convert.to_guided_state_dict(models["cuda"].state_dict()), buf)
    buf.seek(0)
    back = EncoderUNet(cfg, pool="attention", dtype=torch.bfloat16)
    back.load_state_dict(convert.convert_state_dict(torch.load(buf, weights_only=True)))
    back = back.to(dev).eval()
    with torch.no_grad():
        out["pt_round_trip_equal"] = bool(torch.equal(back(x, t).float(), lk))
    del back
    if not out["pt_round_trip_equal"]:
        raise AssertionError("classifier logits changed through the .pt round trip")

    # 4. classifier-guided ancestral steps over the demo256 prior
    resolved = zoo.resolve_model("demo256", "model_zoo", dtype=torch.bfloat16, device=dev)
    if resolved.provenance != "demo":
        raise AssertionError(f"demo256 weights are {resolved.provenance!r}")
    prior = resolved.model
    diffusion = Diffusion(NoiseSchedule.linear(1e-4, 0.02, 1000), ModelMeanType.EPSILON,
                          ModelVarType.LEARNED_RANGE)
    x_t = torch.randn((b, 256, 256, 3), generator=gen, device=dev)
    noises = [torch.randn(x_t.shape, generator=gen, device=dev) for _ in range(GUIDED_STEPS)]

    def prior_fn(v, tt):
        return prior(v.to(torch.bfloat16), tt)

    def cond_fn(v, tt):
        return CLASSIFIER_SCALE * classifier_logp_grad(models["cuda"], v, tt, y)

    def steps(guided: bool):
        v = x_t
        for i in range(GUIDED_STEPS):
            tt = torch.full((b,), 999 - i, dtype=torch.int32, device=dev)
            with torch.no_grad():
                v = diffusion.p_sample(prior_fn, v, tt, noises[i],
                                       cond_fn=cond_fn if guided else None)["sample"]
        return v

    LAUNCHES.clear()
    FN_CALLS.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    xg = steps(True)
    torch.cuda.synchronize()
    out["guided_step_ms"] = (time.perf_counter() - t0) * 1e3 / GUIDED_STEPS
    out["guided_launches"] = dict(LAUNCHES)
    out["guided_function_entries"] = dict(FN_CALLS)
    want = {k: (CLASSIFIER_CALLS[k] + n) * GUIDED_STEPS
            for k, n in (("groupnorm_silu", 65), ("legacy_qkv_attention", 4))}
    want_fn = {k: n * GUIDED_STEPS for k, n in CLASSIFIER_CALLS.items()}
    if out["guided_launches"] != want or out["guided_function_entries"] != want_fn:
        raise AssertionError(f"guided steps: launches {out['guided_launches']} (expected "
                             f"{want}), Function entries {out['guided_function_entries']} "
                             f"(expected {want_fn})")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    xu = steps(False)
    torch.cuda.synchronize()
    out["unguided_step_ms"] = (time.perf_counter() - t0) * 1e3 / GUIDED_STEPS
    out["guided_minus_unguided_max"] = float((xg - xu).abs().max())
    if not (bool(torch.isfinite(xg).all()) and out["guided_minus_unguided_max"] > 0.0):
        raise AssertionError("guided steps are not finite or equal the unguided ones")
    out["peak_gb"] = (torch.cuda.max_memory_allocated() - base) / 1e9
    del prior, resolved, models
    torch.cuda.empty_cache()

    # 5. SuperResUNet at the DEMO256 widths, kernels against plain
    srcfg = dataclasses.replace(zoo.DEMO256_CONFIG, in_channels=6)
    srsd = zoo.init_random_(SuperResUNet(srcfg), 0).state_dict()
    srs = {}
    for route in ("cuda", "plain"):
        m = SuperResUNet(srcfg, dtype=torch.bfloat16, kernels=route)
        m.load_state_dict(srsd)
        srs[route] = m.to(dev).eval()
    xs = torch.randn((4, 256, 256, 3), generator=gen, device=dev)
    low = torch.rand((4, 64, 64, 3), generator=gen, device=dev) * 2 - 1
    LAUNCHES.clear()
    with torch.no_grad():
        sk = srs["cuda"](xs, t[:4], low).float()
        out["superres_launches"] = dict(LAUNCHES)
        sp = srs["plain"](xs, t[:4], low).float()
    out["superres_rel"] = float((sk - sp).abs().max() / sp.abs().max())
    if out["superres_launches"] != {"groupnorm_silu": 65, "legacy_qkv_attention": 4}:
        raise AssertionError(f"SuperResUNet launches {out['superres_launches']}")
    if not (sk.shape == (4, 256, 256, 6) and bool(torch.isfinite(sk).all())
            and out["superres_rel"] <= FLAGSHIP_FORWARD_REL_TOL):
        raise AssertionError(f"SuperResUNet forward differs by {out['superres_rel']}")
    with torch.no_grad():
        out["superres_forward_ms"] = timed_ms(lambda: srs["cuda"](xs, t[:4], low), iters=10)
    del srs
    torch.cuda.empty_cache()
    return out


def random_lpips_weights(rng) -> dict:
    """Seeded random VGG16 ``features.*`` and LPIPS ``lin{k}`` weights in the
    torchvision and ``lpips`` layouts."""
    chans = {0: (3, 64), 2: (64, 64), 5: (64, 128), 7: (128, 128), 10: (128, 256),
             12: (256, 256), 14: (256, 256), 17: (256, 512), 19: (512, 512),
             21: (512, 512), 24: (512, 512), 26: (512, 512), 28: (512, 512)}
    flat = {}
    for i, (cin, cout) in chans.items():
        flat[f"features.{i}.weight"] = (rng.standard_normal((cout, cin, 3, 3))
                                        * np.sqrt(2.0 / (9 * cin))).astype(np.float32)
        flat[f"features.{i}.bias"] = (rng.standard_normal(cout) * 0.01).astype(np.float32)
    for k, c in enumerate((64, 128, 256, 512, 512)):
        flat[f"lin{k}.model.1.weight"] = np.abs(
            rng.standard_normal((1, c, 1, 1)) * 0.05).astype(np.float32)
    return flat


def random_inception_weights(rng) -> dict:
    """Seeded random InceptionV3 weights in torchvision's layout (conv + BN
    statistics), scaled so that 94 ReLU convs neither die nor explode."""
    from diffpir_tpu_torch.inception import expected_conv_shapes

    flat = {}
    for prefix, (cout, cin, kh, kw) in expected_conv_shapes().items():
        flat[f"{prefix}.conv.weight"] = (rng.standard_normal((cout, cin, kh, kw))
                                         * (1.5 / np.sqrt(cin * kh * kw))).astype(np.float32)
        flat[f"{prefix}.bn.weight"] = rng.uniform(0.7, 1.3, cout).astype(np.float32)
        flat[f"{prefix}.bn.bias"] = (rng.standard_normal(cout) * 0.05).astype(np.float32)
        flat[f"{prefix}.bn.running_mean"] = (rng.standard_normal(cout)
                                             * 0.05).astype(np.float32)
        flat[f"{prefix}.bn.running_var"] = rng.uniform(0.7, 1.3, cout).astype(np.float32)
    return flat


def metrics_phase(dev, cli_main, task_psnr: dict, task_launches: dict) -> dict:
    """LPIPS and FID through the CLI on configs/demo256_inpaint.yaml (seeded
    random VGG16+lin and InceptionV3 weights written under .kernel_build/ and
    removed after): the PSNR must equal phase tasks' run of the same config,
    the launches too, and LPIPS and FID must be finite and equal
    ``lpips_from_weights`` and ``fid_from_weights`` on the card applied to a
    ``restore_batch`` of the same batch."""
    import shutil
    import tempfile

    import torch

    from diffpir_tpu_torch.config import load_config
    from diffpir_tpu_torch.data import make_batches, prepare_images
    from diffpir_tpu_torch.inception import fid_from_weights, inception_pool3_from_weights
    from diffpir_tpu_torch.kernels import LAUNCHES
    from diffpir_tpu_torch.kernels.build import BUILD_DIR
    from diffpir_tpu_torch.metrics import lpips_from_weights
    from diffpir_tpu_torch.runner import Runner

    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="metrics_", dir=BUILD_DIR)
    out = {}
    try:
        rng = np.random.default_rng(0)
        lpips_path = os.path.join(tmp, "lpips_vgg.npz")
        fid_path = os.path.join(tmp, "pt_inception.npz")
        np.savez(lpips_path, **random_lpips_weights(rng))
        np.savez(fid_path, **random_inception_weights(rng))
        opt = "configs/demo256_inpaint.yaml"
        over = {"save_E": False, "save_L": False, "calc_LPIPS": True,
                "lpips_weights": lpips_path, "calc_FID": True, "fid_weights": fid_path}
        argv = ["--opt", opt, "--no-sweep"]
        for k, v in over.items():
            argv += ["--set", f"{k}={v if isinstance(v, str) else json.dumps(v)}"]
        LAUNCHES.clear()
        t0 = time.perf_counter()
        res = cli_main(argv)[0]
        torch.cuda.synchronize()
        out["cli_s"] = time.perf_counter() - t0
        out["launches"] = dict(LAUNCHES)
        out.update(psnr=res["psnr"], lpips=res["lpips"], fid=res["fid"])
        if out["launches"] != task_launches["demo256_inpaint"]:
            raise AssertionError(f"launches {out['launches']}, phase tasks "
                                 f"{task_launches['demo256_inpaint']}")
        out["psnr_minus_tasks"] = res["psnr"] - task_psnr["demo256_inpaint"]
        if abs(out["psnr_minus_tasks"]) > 1e-6:
            raise AssertionError(f"PSNR {res['psnr']} with the metrics, "
                                 f"{task_psnr['demo256_inpaint']} without")
        if not (np.isfinite(res["lpips"]) and np.isfinite(res["fid"])):
            raise AssertionError(f"LPIPS {res['lpips']} or FID {res['fid']} not finite")

        cfg = load_config(opt, over)
        np.random.seed(cfg.seed)
        batch = make_batches(prepare_images(cfg), cfg.batch_size)[0]
        x0 = Runner(cfg, device=dev).restore_batch(batch, seed=cfg.seed)
        gt = batch.img_H.astype(np.float32) / 255.0
        lpips_fn = lpips_from_weights(lpips_path, dev)
        out["lpips_direct"] = lpips_fn(x0 * 2 - 1, gt * 2 - 1)
        out["fid_direct"] = fid_from_weights(fid_path, dev)(x0, gt)
        pool3 = inception_pool3_from_weights(fid_path, device=dev)
        out["lpips_ms_per_image"] = timed_host_ms(
            lambda: lpips_fn(x0 * 2 - 1, gt * 2 - 1)) / len(x0)
        out["pool3_ms_per_image"] = timed_host_ms(lambda: pool3(x0)) / len(x0)
        if not (abs(out["lpips_direct"] - res["lpips"])
                <= METRIC_LPIPS_RTOL * abs(out["lpips_direct"])
                and abs(out["fid_direct"] - res["fid"])
                <= METRIC_FID_RTOL * abs(out["fid_direct"])):
            raise AssertionError(f"CLI LPIPS {res['lpips']} FID {res['fid']}; the "
                                 f"functions on the same batch {out['lpips_direct']}, "
                                 f"{out['fid_direct']}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


# ---------------------------------------------------------------------------
# phase export
# ---------------------------------------------------------------------------

# a fresh serving process: load a bundle, run it once, report (run as
# ``python -c``; ``poison`` makes any kernel build raise)
BOOT_SCRIPT = """
import json, sys, time
t0 = time.perf_counter()
sys.path.insert(0, {root!r})
import numpy as np
from diffpir_tpu_torch.kernels import build
builds = []
real_build = build.build
def counted():
    builds.append(1)
    if {poison!r}:
        raise RuntimeError("a kernel build (nvcc) in a sidecar boot")
    return real_build()
build.build = counted
from diffpir_tpu_torch.export import load_bundle
t1 = time.perf_counter()
loaded = load_bundle({path!r}, use_aot={poison!r})
t2 = time.perf_counter()
with np.load({inputs!r}) as z:
    out = loaded(z["y"], mask=z["mask"], seed=int(z["seed"]))
t3 = time.perf_counter()
np.save({output!r}, out)
bad = sorted(m for m in sys.modules if m.startswith({modules!r}))
print(json.dumps(dict(boot_timings=loaded.boot_timings, import_s=t1 - t0,
                      load_s=t2 - t1, first_call_s=t3 - t2, builds=len(builds),
                      model_modules=bad)))
"""


def start_fresh_boot(root: str, path: str, inputs: str, output: str, sidecar: bool):
    """A fresh serving process that boots from the bundle, without the
    sidecar or with it (and then any kernel build raises); returns (the
    process, its start time) for ``finish_fresh_boot``."""
    code = BOOT_SCRIPT.format(root=root, path=path, inputs=inputs, output=output,
                              poison=sidecar, modules=MODEL_MODULES)
    return (subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True, cwd=REPO),
            time.perf_counter())


def finish_fresh_boot(started) -> dict:
    proc, t0 = started
    try:
        out, err = proc.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"the fresh boot failed:\n{out}\n{err}")
    res = json.loads(out.strip().splitlines()[-1])
    res["process_wall_s"] = wall
    return res


def export_phase(dev, root: str) -> dict:
    """Phase export (see the module docstring).  Returns what the record
    line and the log report."""
    import shutil
    import tempfile
    import urllib.request

    import torch

    from diffpir_tpu_torch.config import load_config
    from diffpir_tpu_torch.data import make_batches, prepare_images
    from diffpir_tpu_torch.export import (LoadedRestore, expected_report, load_bundle,
                                          program_report, save_bundle)
    from diffpir_tpu_torch.kernels import LAUNCHES
    from diffpir_tpu_torch.kernels.build import BUILD_DIR
    from diffpir_tpu_torch.models.unet import AttentionBlock, GroupNorm32
    from diffpir_tpu_torch.parallel.multihost import free_port
    from diffpir_tpu_torch.runner import Runner
    from diffpir_tpu_torch.serve import RestorationService
    from diffpir_tpu_torch.utils import image as im

    os.makedirs(BUILD_DIR, exist_ok=True)
    work = tempfile.mkdtemp(prefix="export_", dir=BUILD_DIR)
    out: dict = {"launches": {}}
    over = {"save_E": False, "save_L": False}

    def per_forward(model):
        mods = list(model.modules())
        return {"groupnorm_silu": sum(isinstance(m, GroupNorm32) for m in mods),
                "legacy_qkv_attention": sum(isinstance(m, AttentionBlock) for m in mods)}

    def bundle_vs_live(name, runner, batch, **save_kw):
        """Export, check the graph, run bundle and live at one seed; returns
        (path, loaded, live images, bundle images, record)."""
        cfg = runner.cfg
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = save_bundle(runner, os.path.join(work, name), batch=cfg.batch_size,
                           height=batch.img_L.shape[1], width=batch.img_L.shape[2],
                           kernel_hw=tuple(batch.kernel.shape[1:]), platforms=("cuda",),
                           **save_kw)
        export_s = time.perf_counter() - t0
        loaded = load_bundle(path, device=dev)
        rep = program_report(loaded.programs["step"])
        pf = per_forward(runner.model)
        # UNet calls a step makes (test_mode's ensemble and split make more)
        calls = loaded._steps["noise"]["forwards"]
        nodes = expected_report(runner, calls)
        if rep["plain_nodes"] or any(rep[k] != v for k, v in nodes.items()):
            raise AssertionError(f"{name}: the step program holds {rep}; a forward calls "
                                 f"{pf}, a step {calls} forwards: {nodes}")
        nfe = forwards_per_batch(cfg)
        want = {k: v * nfe * calls for k, v in pf.items()}
        LAUNCHES.clear()
        live = runner.restore_batch(batch, seed=cfg.seed)
        live_launches = dict(LAUNCHES)
        LAUNCHES.clear()
        got = loaded(batch.img_L, kernel=batch.kernel, mask=batch.mask, seed=cfg.seed)
        torch.cuda.synchronize()
        bundle_launches = dict(LAUNCHES)
        if live_launches != want or bundle_launches != want:
            raise AssertionError(f"{name}: launches live {live_launches}, bundle "
                                 f"{bundle_launches}, expected {want}")
        if got.shape != live.shape or not np.isfinite(got).all():
            raise AssertionError(f"{name}: bundle output {got.shape}, finite "
                                 f"{np.isfinite(got).all()}")
        gt = batch.img_H.astype(np.float32) / 255.0
        psnr_live = im.psnr_batch(live * 2 - 1, gt * 2 - 1)
        psnr_bundle = im.psnr_batch(got * 2 - 1, gt * 2 - 1)
        rec = dict(export_s=export_s, program_bytes=os.path.getsize(
            os.path.join(path, "program.pt2")), params_bytes=os.path.getsize(
            os.path.join(path, "params.npz")), nfe=nfe, forwards_per_step=calls,
            step_report={k: v for k, v in rep.items() if v},
            max_abs_diff=float(np.abs(got - live).max()),
            bit_equal=bool(np.array_equal(got, live)), psnr_live=psnr_live,
            psnr_bundle=psnr_bundle, launches=bundle_launches,
            weights=runner.weights_provenance, boot_timings=dict(loaded.boot_timings))
        out["launches"][name] = bundle_launches
        log(f"export {name}: exported in {export_s:.3f}s (program {rec['program_bytes']} "
            f"bytes, params {rec['params_bytes']} bytes); step program "
            f"{rec['step_report']} ({calls} forwards a step), {rep['plain_nodes']} "
            f"plain-version nodes; bundle vs live max |diff| "
            f"{rec['max_abs_diff']:.3e} (bit-equal {rec['bit_equal']}), PSNR bundle "
            f"{psnr_bundle:.4f} live {psnr_live:.4f} dB; launches {bundle_launches} "
            f"({nfe} forwards); boot {loaded.boot_timings}")
        return path, loaded, live, got, rec

    try:
        # demo256 inpaint: the trained 54M prior, bf16, b4, 100 NFE, (lambda,
        # zeta) at call time
        cfg = load_config("configs/demo256_inpaint.yaml", over)
        runner = Runner(cfg, device=dev)
        if runner.weights_provenance != "demo":
            raise AssertionError(f"demo256 weights {runner.weights_provenance!r}")
        np.random.seed(cfg.seed)
        batch = make_batches(prepare_images(cfg), cfg.batch_size)[0]
        path, loaded, live, got, rec = bundle_vs_live("demo256_inpaint", runner, batch,
                                                      dynamic_point=True)
        if not abs(rec["psnr_bundle"] - rec["psnr_live"]) <= EXPORT_PSNR_TOL_DB:
            raise AssertionError(f"demo256 bundle PSNR {rec['psnr_bundle']} vs live "
                                 f"{rec['psnr_live']}")
        # ms per NFE, the bundle and the live runner in turns (no bar): wall
        # time of the fetched restore, and the card's time between events
        import resource

        ms: dict = collections.defaultdict(list)
        for kind in ("bundle", "live", "live", "bundle"):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            ru0 = resource.getrusage(resource.RUSAGE_THREAD)
            t0, c0 = time.perf_counter(), time.thread_time()
            start.record()
            if kind == "live":
                runner.restore_batch(batch, seed=cfg.seed)
            else:
                loaded(batch.img_L, mask=batch.mask, seed=cfg.seed)
            end.record()
            torch.cuda.synchronize()
            ms[kind].append((time.perf_counter() - t0) * 1e3 / rec["nfe"])
            ms[kind + "_thread_cpu"].append((time.thread_time() - c0) * 1e3 / rec["nfe"])
            ms[kind + "_device"].append(start.elapsed_time(end) / rec["nfe"])
            ru1 = resource.getrusage(resource.RUSAGE_THREAD)
            ms[kind + "_system"].append((ru1.ru_stime - ru0.ru_stime) * 1e3 / rec["nfe"])
            ms[kind + "_minor_faults"].append(ru1.ru_minflt - ru0.ru_minflt)
            ms[kind + "_switches"].append([ru1.ru_nvcsw - ru0.ru_nvcsw,
                                           ru1.ru_nivcsw - ru0.ru_nivcsw])
            ms[kind + "_os_threads"].append(len(os.listdir("/proc/self/task")))
        rec["ms_per_nfe"] = ms = dict(ms)
        log(f"export demo256_inpaint: ms per NFE (wall; between events; the main "
            f"thread's CPU, system) bundle {ms['bundle']}; {ms['bundle_device']}; "
            f"{ms['bundle_thread_cpu']}, {ms['bundle_system']} live {ms['live']}; "
            f"{ms['live_device']}; {ms['live_thread_cpu']}, {ms['live_system']}; minor "
            f"faults bundle {ms['bundle_minor_faults']} live {ms['live_minor_faults']}; "
            f"(voluntary, involuntary) switches bundle {ms['bundle_switches']} live "
            f"{ms['live_switches']}; OS threads {ms['bundle_os_threads']}")
        # the bundle against the live runner (ROADMAP C6), fastest of two each:
        # logged, no bar
        rec["bundle_over_live"] = dict(
            wall=min(ms["bundle"]) / min(ms["live"]),
            device=min(ms["bundle_device"]) / min(ms["live_device"]))
        log(f"export demo256_inpaint: bundle / live ms per NFE, wall "
            f"{rec['bundle_over_live']['wall']:.4f}, between events "
            f"{rec['bundle_over_live']['device']:.4f}")
        # the operator's host cost against the wrapper's, one GroupNorm call
        # of a DEMO256 shape, 200 back-to-back calls each
        from diffpir_tpu_torch.kernels.groupnorm import groupnorm_silu

        gx = torch.zeros((4, 64, 64, 128), device=dev, dtype=torch.bfloat16)
        gs, gb = torch.ones(128, device=dev), torch.zeros(128, device=dev)
        host_us = {}
        for kind, fn in (("wrapper", lambda: groupnorm_silu(gx, gs, gb)),
                         ("operator", lambda: torch.ops.diffpir_tpu_torch.groupnorm_silu(
                             gx, gs, gb, None, None, 32, 1e-5, True))):
            for _ in range(5):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(200):
                fn()
            host_us[kind] = (time.perf_counter() - t0) / 200 * 1e6
            torch.cuda.synchronize()
        rec["groupnorm_host_us_per_call"] = host_us
        log(f"export: groupnorm_silu host us per call, wrapper {host_us['wrapper']:.2f}, "
            f"operator {host_us['operator']:.2f}")
        del runner
        torch.cuda.empty_cache()

        # three fresh processes, started together once the sidecar is
        # written: a boot without the sidecar, one with it (no kernel build),
        # and the HTTP server booted from the bundle
        inputs = os.path.join(work, "inputs.npz")
        np.savez(inputs, y=batch.img_L, mask=batch.mask, seed=cfg.seed)
        t0 = time.perf_counter()
        sidecar = LoadedRestore(path, use_aot=False, device=dev).save_aot()
        aot_s = time.perf_counter() - t0
        starts = {kind: start_fresh_boot(root, path, inputs,
                                         os.path.join(work, f"{kind}.npy"), kind == "sidecar")
                  for kind in ("cold", "sidecar")}
        port = free_port()
        env = dict(os.environ, PYTHONPATH=os.pathsep.join([root, REPO]))
        server = subprocess.Popen([sys.executable, "-m", "diffpir_tpu_torch.server_http",
                                   "--bundle", path, "--port", str(port)], cwd=REPO, env=env,
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
        url = f"http://127.0.0.1:{port}"
        try:
            t0 = time.perf_counter()
            while True:
                try:
                    with opener.open(url + "/healthz", timeout=5) as r:
                        health = json.loads(r.read())
                    break
                except OSError:
                    if server.poll() is not None or time.perf_counter() - t0 > 300:
                        raise AssertionError("the --bundle server did not come up: "
                                             + (server.stdout.read() if server.poll()
                                                is not None else "timeout"))
                    time.sleep(0.2)
            up_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            code, ctype, body = http_post(opener, url + "/restore",
                                          npz_bytes(image=batch.img_L[0], mask=batch.mask[0]),
                                          "application/x-npz")
            req_s = time.perf_counter() - t0
        finally:
            server.terminate()
            server.wait(timeout=60)
            if sys.exc_info()[0] is not None:
                for proc, _ in starts.values():  # the boots, on a failure
                    proc.kill()
                    proc.wait()
        boots = {kind: finish_fresh_boot(st) for kind, st in starts.items()}
        for kind, b in boots.items():
            same = bool(np.array_equal(np.load(os.path.join(work, f"{kind}.npy")), got))
            b["equal_to_in_process"] = same
            log(f"export demo256_inpaint boot {kind}: {json.dumps(b)}")
            if b["model_modules"] or not same:
                raise AssertionError(f"{kind} boot imported {b['model_modules']}, output "
                                     f"equal {same}")
        if ("aot_load_s" not in boots["sidecar"]["boot_timings"]
                or "aot_load_s" in boots["cold"]["boot_timings"]):
            raise AssertionError("the boots did not take the sidecar as asked")
        rec["boots"] = boots
        rec["save_aot_s"] = aot_s
        log(f"export demo256_inpaint: save_aot wrote {os.path.basename(sidecar)} in "
            f"{aot_s:.3f}s; the sidecar boot made {boots['sidecar']['builds']} kernel builds")
        out["demo256_inpaint"] = rec
        if code != 200:
            raise AssertionError(f"--bundle server: {code} {body[:200]!r}")
        import io

        with np.load(io.BytesIO(body)) as z:
            served = z["restored"]
        svc = RestorationService(bundle_path=path)
        # the server's worker gives its first launch the seed block 1 << 12
        (want,) = svc.restore([batch.img_L[0]], masks=[batch.mask[0]], seed=1 << 12)
        svc.close()
        http_diff = float(np.abs(served - want).max())
        out["http"] = dict(up_s=up_s, request_s=req_s, max_abs_diff=http_diff,
                           health=health)
        log(f"export: server_http --bundle up in {up_s:.3f}s (boot with the sidecar, beside "
            f"the two fresh boots), one POST /restore in {req_s:.3f}s, max |served - "
            f"service.restore| {http_diff:.3e}")
        if not http_diff <= 1e-6:
            raise AssertionError(f"the --bundle server's answer differs by {http_diff}")
        del loaded, svc
        torch.cuda.empty_cache()

        # demo64 deblur: fp32, the Levin k0 PSF, the FFT prox's spectra from
        # the prologue
        dcfg = load_config("configs/demo64_deblur.yaml", over)
        runner = Runner(dcfg, device=dev)
        np.random.seed(dcfg.seed)
        dbatch = make_batches(prepare_images(dcfg), dcfg.batch_size)[0]
        *_, rec = bundle_vs_live("demo64_deblur", runner, dbatch)
        if not rec["max_abs_diff"] <= EXPORT_DEBLUR_ATOL:
            raise AssertionError(f"demo64 deblur bundle differs by {rec['max_abs_diff']}")
        out["demo64_deblur"] = rec
        del runner

        # the other modes on demo64 (fp32): pred_x_prev ancestral and DDIM,
        # DPS_yt as phase tasks runs it, and test_mode 3 (the x8 ensemble:
        # one UNet call of 8 x 4 images a step)
        for name, opt, extra in EXPORT_MODE_BUNDLES:
            mcfg = load_config(opt, {**over, **extra})
            runner = Runner(mcfg, device=dev)
            np.random.seed(mcfg.seed)
            mbatch = make_batches(prepare_images(mcfg), mcfg.batch_size)[0]
            *_, rec = bundle_vs_live(name, runner, mbatch)
            if not rec["max_abs_diff"] <= EXPORT_DEBLUR_ATOL:
                raise AssertionError(f"{name} bundle differs by {rec['max_abs_diff']}")
            out[name] = rec
            del runner
        torch.cuda.empty_cache()

        # the diffusion_ffhq_10m topology at full width: 95M, seeded random
        # weights, bf16, b4, 256 px, 4 NFE
        fcfg = load_config("configs/demo256_inpaint.yaml", {
            **over, "model_name": "diffusion_ffhq_10m", "iter_num": EXPORT_FFHQ_ITER})
        runner = Runner(fcfg, device=dev)
        *_, rec = bundle_vs_live("ffhq_inpaint", runner, batch, allow_random_weights=True)
        if not abs(rec["psnr_bundle"] - rec["psnr_live"]) <= EXPORT_PSNR_TOL_DB:
            raise AssertionError(f"ffhq bundle PSNR {rec['psnr_bundle']} vs live "
                                 f"{rec['psnr_live']}")
        out["ffhq_inpaint"] = rec
        del runner
        torch.cuda.empty_cache()

        # the same topology as a DPS_y0 deblur bundle (its step program
        # differentiates through the UNet: a backward node per kernel node),
        # 4 NFE on demo256's Levin PSFs; ms per NFE in turns, peak memory
        fcfg = load_config("configs/demo256_deblur.yaml", {
            **over, "model_name": "diffusion_ffhq_10m", "iter_num": EXPORT_FFHQ_ITER,
            "generate_mode": "DPS_y0"})
        runner = Runner(fcfg, device=dev)
        np.random.seed(fcfg.seed)
        fbatch = make_batches(prepare_images(fcfg), fcfg.batch_size)[0]
        torch.cuda.reset_peak_memory_stats()
        _, loaded, _, _, rec = bundle_vs_live("ffhq_dps_y0", runner, fbatch,
                                              allow_random_weights=True)
        rec["export_peak_bytes"] = torch.cuda.max_memory_allocated()
        if not abs(rec["psnr_bundle"] - rec["psnr_live"]) <= EXPORT_PSNR_TOL_DB:
            raise AssertionError(f"ffhq DPS_y0 bundle PSNR {rec['psnr_bundle']} vs live "
                                 f"{rec['psnr_live']}")
        ms, peak = {"bundle": [], "live": []}, {}
        for kind in ("bundle", "live", "live", "bundle"):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            if kind == "live":
                runner.restore_batch(fbatch, seed=fcfg.seed)
            else:
                loaded(fbatch.img_L, kernel=fbatch.kernel, seed=fcfg.seed)
            torch.cuda.synchronize()
            ms[kind].append((time.perf_counter() - t0) * 1e3 / rec["nfe"])
            peak[kind] = torch.cuda.max_memory_allocated() - base
        rec.update(ms_per_nfe=ms, peak_bytes_over_held=peak)
        log(f"export ffhq_dps_y0: ms per NFE bundle {ms['bundle']} live {ms['live']}; "
            f"peak bytes over those held bundle {peak['bundle']} live {peak['live']}; "
            f"peak through the export {rec['export_peak_bytes']}")
        out["ffhq_dps_y0"] = rec
        del runner, loaded
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


# ---------------------------------------------------------------------------
# phase parallel: what the ranks run (each rank a process on the one card)
# ---------------------------------------------------------------------------

def _parallel_cfg(task, model_name, dtype, batch, iter_num, shape=None, axes=None,
                  **extra):
    from diffpir_tpu_torch.config import load_config

    return load_config(None, overrides=dict(
        task=task, model_name=model_name, iter_num=iter_num, iter_num_U=1,
        batch_size=batch, noise_level_img=0.0, seed=0, dtype=dtype, save_L=False,
        save_E=False, mesh_shape=shape, mesh_axes=axes, **extra))


def _parallel_restore(cfg, batch, nfe):
    """One restore of ``batch`` under ``cfg``'s mesh (if any) on this rank's
    card: (images, ms per NFE, peak bytes over the memory held before it,
    parameter bytes, launches)."""
    import torch

    from diffpir_tpu_torch.kernels import LAUNCHES
    from diffpir_tpu_torch.parallel.multihost import rank_device
    from diffpir_tpu_torch.runner import Runner

    dev = rank_device()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    runner = Runner(cfg, device=dev)
    runner.restore_batch(batch, seed=0)  # warm-up: allocations, cuDNN's choices
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.clear()
    t0 = time.perf_counter()
    out = runner.restore_batch(batch, seed=0)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / nfe
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated() - base
    params = sum(p.numel() * p.element_size() for p in runner.model.parameters())
    return runner, out, ms, peak, params, launches


def _is_rank0() -> bool:
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


def parallel_pair(work: str) -> dict:
    """Two ranks (or, with no group, the unsharded reference): the 553M
    model under tp = 2 (one forward, a 4-NFE inpaint restore), DEMO256
    under sp = 2 (a 4-NFE inpaint restore) and ``parallel_bundle``."""
    import torch
    import torch.distributed as dist

    from diffpir_tpu_torch.runner import _dryrun_batch

    sharded = dist.is_initialized()
    tag = "ranks" if sharded else "ref"
    res = {}
    nfe = PARALLEL_ITER - 1
    cfg = _parallel_cfg("inpaint", "256x256_diffusion_uncond", "bfloat16", 1,
                        PARALLEL_ITER, (1, 2) if sharded else None,
                        ("data", "model") if sharded else None)
    batch = _dryrun_batch(np.random.default_rng(0), 1, 256, "inpaint")
    runner, out, ms, peak, params, launches = _parallel_restore(cfg, batch, nfe)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (1, 256, 256, 3)).astype(np.float32)).to(runner.device)
    with torch.no_grad():
        fwd = runner.model(x, torch.tensor([500], device=runner.device)).float()
    if _is_rank0():
        np.save(os.path.join(work, f"tp553_{tag}_restore.npy"), out)
        np.save(os.path.join(work, f"tp553_{tag}_forward.npy"), fwd.cpu().numpy())
    res["tp553"] = dict(ms_per_nfe=ms, peak_bytes=peak, param_bytes=params,
                        launches=launches, weights=runner.weights_provenance)
    del runner, x, fwd
    torch.cuda.empty_cache()

    cfg = _parallel_cfg("inpaint", "demo256", "bfloat16", 4, PARALLEL_ITER,
                        (1, 2) if sharded else None, ("data", "space") if sharded else None)
    batch = _dryrun_batch(np.random.default_rng(2), 4, 256, "inpaint")
    runner, out, ms, peak, params, launches = _parallel_restore(cfg, batch, nfe)
    if _is_rank0():
        np.save(os.path.join(work, f"sp256_{tag}_restore.npy"), out)
    res["sp256"] = dict(ms_per_nfe=ms, peak_bytes=peak, param_bytes=params,
                        launches=launches, weights=runner.weights_provenance)
    del runner
    torch.cuda.empty_cache()
    res["bundle"] = parallel_bundle(work)
    res["dps"] = parallel_dps(work)
    res["space_bundle"] = parallel_space_bundle(work)
    return res


def parallel_dps(work: str) -> dict:
    """On ``parallel_pair``'s two ranks: DPS_y0 deblur of demo64 (fp32, b2,
    2 NFE), which differentiates through the UNet at every step, under
    model = 2 and then under space = 2; with no group, the same restore
    unsharded."""
    import torch.distributed as dist

    from diffpir_tpu_torch.runner import _dryrun_batch

    sharded = dist.is_initialized()
    batch = _dryrun_batch(np.random.default_rng(6), 2, 64, "deblur")
    out = {}
    for axis in ("model", "space") if sharded else ("ref",):
        cfg = _parallel_cfg("deblur", "demo64_hq", "float32", 2, PARALLEL_MESH3_ITER,
                            (2,) if sharded else None, (axis,) if sharded else None,
                            generate_mode="DPS_y0")
        _, img, ms, peak, _, launches = _parallel_restore(cfg, batch,
                                                          PARALLEL_MESH3_ITER - 1)
        if _is_rank0():
            np.save(os.path.join(work, f"dps_{axis}.npy"), img)
        out[axis] = dict(ms_per_nfe=ms, peak_bytes=peak, launches=launches)
    return out


def parallel_space_bundle(work: str) -> dict:
    """On ``parallel_pair``'s two ranks: a bundle of the DEMO256 prior's
    inpaint restore under space = 2 in fp32 (b4, 4 NFE; in bf16 the
    sharded GroupNorm's merged statistics round differently from the
    unsharded ones, 8e-3 apart), exported by both ranks, loaded and run on
    the group, its step program's operators counted; with no group, the
    same restore unsharded."""
    import torch.distributed as dist

    from diffpir_tpu_torch.export import load_bundle, program_report, save_bundle
    from diffpir_tpu_torch.kernels import LAUNCHES
    from diffpir_tpu_torch.parallel.multihost import rank_device
    from diffpir_tpu_torch.runner import Runner, _dryrun_batch

    sharded = dist.is_initialized()
    cfg = _parallel_cfg("inpaint", "demo256", "float32", 4, PARALLEL_ITER,
                        (1, 2) if sharded else None, ("data", "space") if sharded else None)
    batch = _dryrun_batch(np.random.default_rng(2), 4, 256, "inpaint")
    runner = Runner(cfg, device=rank_device())
    if not sharded:
        np.save(os.path.join(work, "space_bundle_ref.npy"),
                runner.restore_batch(batch, seed=0))
        return {}
    t0 = time.perf_counter()
    path = save_bundle(runner, os.path.join(work, "space_bundle"), batch=4, height=256,
                       width=256, platforms=("cuda",))
    export_s = time.perf_counter() - t0
    loaded = load_bundle(path, device=runner.device)
    LAUNCHES.clear()
    out = loaded(batch.img_L, mask=batch.mask, seed=0)
    launches = dict(LAUNCHES)
    if _is_rank0():
        np.save(os.path.join(work, "space_bundle_ranks.npy"), out)
    rep = program_report(loaded.programs["step"])
    return dict(export_s=export_s, launches=launches, report={k: v for k, v in rep.items()
                                                              if v},
                mesh=loaded.manifest["mesh"]["shape"], weights=runner.weights_provenance)


def parallel_mesh8(work: str) -> dict:
    """Eight ranks (or the unsharded reference): demo64 (fp32, 2 NFE) under
    dp x tp x sp = 2 x 2 x 2."""
    import torch.distributed as dist

    from diffpir_tpu_torch.runner import _dryrun_batch

    sharded = dist.is_initialized()
    cfg = _parallel_cfg("inpaint", "demo64_hq", "float32", 2, PARALLEL_MESH3_ITER,
                        (2, 2, 2) if sharded else None,
                        ("data", "model", "space") if sharded else None)
    batch = _dryrun_batch(np.random.default_rng(3), 2, 64, "inpaint")
    _, out, ms, peak, params, launches = _parallel_restore(cfg, batch,
                                                           PARALLEL_MESH3_ITER - 1)
    if _is_rank0():
        np.save(os.path.join(work, f"mesh8_{'ranks' if sharded else 'ref'}.npy"), out)
    return dict(ms_per_nfe=ms, peak_bytes=peak, param_bytes=params, launches=launches)


def parallel_bundle(work: str) -> dict:
    """On ``parallel_pair``'s two ranks: a bundle of the demo64 restore
    (fp32, b2, 2 NFE) under data x model = 1 x 2, exported (rank 0 traces,
    both gather the parameters), loaded and run on the group; with no
    group, the same restore unsharded."""
    import torch.distributed as dist

    from diffpir_tpu_torch.export import load_bundle, save_bundle
    from diffpir_tpu_torch.kernels import LAUNCHES
    from diffpir_tpu_torch.parallel.multihost import rank_device
    from diffpir_tpu_torch.runner import Runner, _dryrun_batch

    sharded = dist.is_initialized()
    dev = rank_device()
    cfg = _parallel_cfg("inpaint", "demo64_hq", "float32", 2, PARALLEL_MESH3_ITER,
                        (1, 2) if sharded else None, ("data", "model") if sharded else None)
    batch = _dryrun_batch(np.random.default_rng(5), 2, 64, "inpaint")
    runner = Runner(cfg, device=dev)
    if not sharded:
        np.save(os.path.join(work, "bundle_ref.npy"), runner.restore_batch(batch, seed=0))
        return {}
    t0 = time.perf_counter()
    path = save_bundle(runner, os.path.join(work, "mesh_bundle"), batch=2, height=64,
                       width=64, platforms=("cuda",))
    export_s = time.perf_counter() - t0
    loaded = load_bundle(path, device=dev)
    LAUNCHES.clear()
    out = loaded(batch.img_L, mask=batch.mask, seed=0)
    launches = dict(LAUNCHES)
    if _is_rank0():
        np.save(os.path.join(work, "bundle_ranks.npy"), out)
    return dict(export_s=export_s, launches=launches, mesh=loaded.manifest["mesh"]["shape"],
                weights=runner.weights_provenance)


def parallel_train() -> dict:
    """Four ranks: the sharded dry-run train step on the card."""
    import torch

    from diffpir_tpu_torch.train.loop import dryrun_train_step

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss = dryrun_train_step(4)
    return dict(loss=loss, s=time.perf_counter() - t0,
                peak_bytes=torch.cuda.max_memory_allocated())


def parallel_nccl(work: str, port: int) -> dict:
    """A group of one rank over NCCL, made by ``multihost.initialize``: its
    collectives on the card, and a Runner's restore under it."""
    import torch
    import torch.distributed as dist

    from diffpir_tpu_torch.parallel import multihost
    from diffpir_tpu_torch.runner import _dryrun_batch

    multihost.initialize(f"127.0.0.1:{port}", 1, 0)
    backend = dist.get_backend()
    t = torch.arange(4.0, device="cuda")
    dist.all_reduce(t)
    g = torch.empty(4, device="cuda")
    dist.all_gather_into_tensor(g, t)
    cfg = _parallel_cfg("inpaint", "tiny_demo32", "float32", 2, PARALLEL_MESH3_ITER)
    batch = _dryrun_batch(np.random.default_rng(4), 2, 32, "inpaint")
    runner, out, ms, peak, params, launches = _parallel_restore(
        cfg, batch, PARALLEL_MESH3_ITER - 1)
    np.save(os.path.join(work, "nccl_restore.npy"), out)
    dist.destroy_process_group()
    return dict(backend=backend, world=1, collectives_ok=bool(
        torch.equal(g, torch.arange(4.0, device="cuda"))), mesh=runner.mesh is not None,
        ms_per_nfe=ms, peak_bytes=peak)


MERGE = "groupnorm_partial_merge"


def split_merges(launches: dict, nfe: int) -> tuple[dict, int]:
    """``launches`` without the partial statistics' merge launches (the
    second kernel of a plan with pixel segments, counted on their own), and
    their number, which must be the same at every NFE and at most one a
    partial-statistics launch."""
    merges = launches.get(MERGE, 0)
    if merges % nfe or merges > launches.get("groupnorm_partial_stats", 0):
        raise AssertionError(f"{merges} merge launches in {nfe} NFE: {launches}")
    return {k: v for k, v in launches.items() if k != MERGE}, merges


def parallel_phase(dev, root: str) -> dict:
    """Phase parallel (see the module docstring and PARALLEL_*)."""
    import shutil
    import tempfile

    import torch

    from diffpir_tpu_torch.kernels.build import BUILD_DIR
    from diffpir_tpu_torch.parallel.multihost import free_port, spawn
    from diffpir_tpu_torch.runner import DRYRUN_ATOL, _dryrun_batch
    from diffpir_tpu_torch.train.loop import dryrun_train_step

    os.makedirs(BUILD_DIR, exist_ok=True)
    work = tempfile.mkdtemp(prefix="parallel_", dir=BUILD_DIR)
    env = {"PYTHONPATH": os.pathsep.join([root, REPO])}
    runs = []
    try:
        t0 = time.perf_counter()
        pair = spawn("chip_smoke:parallel_pair", 2, [work], env=env, timeout=600)
        pair_s = time.perf_counter() - t0
        ref = parallel_pair(work)
        torch.cuda.empty_cache()
        load = lambda name: np.load(os.path.join(work, name))  # noqa: E731
        # 553M, tp = 2
        f_r, f_u = load("tp553_ranks_forward.npy"), load("tp553_ref_forward.npy")
        fwd_rel = float(np.abs(f_r - f_u).max() / np.abs(f_u).max())
        img = np.abs(load("tp553_ranks_restore.npy") - load("tp553_ref_restore.npy"))
        runs.append(dict(
            run="256x256_diffusion_uncond tp=2 bf16 b1 256px", backend="gloo (host-staged)",
            world=2, mesh={"data": 1, "model": 2}, forward_max_rel_err=fwd_rel,
            max_abs_err=float(img.max()), mean_abs_err=float(img.mean()),
            ms_per_nfe_per_rank=[r["tp553"]["ms_per_nfe"] for r in pair],
            peak_bytes_per_rank=[r["tp553"]["peak_bytes"] for r in pair],
            param_bytes_per_rank=[r["tp553"]["param_bytes"] for r in pair],
            unsharded=dict(ms_per_nfe=ref["tp553"]["ms_per_nfe"],
                           peak_bytes=ref["tp553"]["peak_bytes"],
                           param_bytes=ref["tp553"]["param_bytes"]),
            launches_rank0=pair[0]["tp553"]["launches"]))
        if not (fwd_rel <= FLAGSHIP_FORWARD_REL_TOL
                and float(img.mean()) <= FLAGSHIP_IMAGE_MEAN_TOL):
            raise AssertionError(f"553M tp=2 against unsharded: forward {fwd_rel}, "
                                 f"images mean {float(img.mean())}")
        # DEMO256, sp = 2
        img = np.abs(load("sp256_ranks_restore.npy") - load("sp256_ref_restore.npy"))
        sp_launches = pair[0]["sp256"]["launches"]
        runs.append(dict(
            run="demo256 sp=2 bf16 b4 256px", backend="gloo (host-staged)", world=2,
            mesh={"data": 1, "space": 2}, max_abs_err=float(img.max()),
            mean_abs_err=float(img.mean()),
            ms_per_nfe_per_rank=[r["sp256"]["ms_per_nfe"] for r in pair],
            peak_bytes_per_rank=[r["sp256"]["peak_bytes"] for r in pair],
            unsharded=dict(ms_per_nfe=ref["sp256"]["ms_per_nfe"],
                           peak_bytes=ref["sp256"]["peak_bytes"]),
            launches_rank0=sp_launches, weights=pair[0]["sp256"]["weights"]))
        nfe = PARALLEL_ITER - 1
        want = {"groupnorm_partial_stats": 65 * nfe, "groupnorm_apply_stats": 65 * nfe,
                "legacy_qkv_attention": 4 * nfe}
        if (not float(img.mean()) <= FLAGSHIP_IMAGE_MEAN_TOL
                or split_merges(sp_launches, nfe)[0] != want):
            raise AssertionError(f"demo256 sp=2: images mean {float(img.mean())}, "
                                 f"launches {sp_launches} (expected {want})")
        # demo64, dp x tp x sp
        t0 = time.perf_counter()
        mesh8 = spawn("chip_smoke:parallel_mesh8", 8, [work], env=env, timeout=600)
        mesh8_s = time.perf_counter() - t0
        mref = parallel_mesh8(work)
        err = float(np.abs(load("mesh8_ranks.npy") - load("mesh8_ref.npy")).max())
        runs.append(dict(
            run="demo64_hq dp x tp x sp = 2x2x2 fp32 b2 64px", backend="gloo (host-staged)",
            world=8, mesh={"data": 2, "model": 2, "space": 2}, max_abs_err=err,
            ms_per_nfe_per_rank=[r["ms_per_nfe"] for r in mesh8],
            peak_bytes_per_rank=[r["peak_bytes"] for r in mesh8],
            unsharded=dict(ms_per_nfe=mref["ms_per_nfe"], peak_bytes=mref["peak_bytes"]),
            launches_rank0=mesh8[0]["launches"]))
        if not err <= DRYRUN_ATOL:
            raise AssertionError(f"demo64 2x2x2 differs from unsharded by {err}")
        # the demo64 bundle under model = 2 (on the same two ranks)
        err = float(np.abs(load("bundle_ranks.npy") - load("bundle_ref.npy")).max())
        bund = [r["bundle"] for r in pair]
        bundle_launches = bund[0]["launches"]
        runs.append(dict(run="demo64_hq bundle, data x model = 1x2, fp32 b2 64px",
                         backend="gloo (host-staged)", world=2, mesh={"data": 1, "model": 2},
                         max_abs_err=err, export_s=[r["export_s"] for r in bund],
                         launches_rank0=bundle_launches, weights=bund[0]["weights"]))
        want = {"groupnorm_silu": 44 * (PARALLEL_MESH3_ITER - 1),
                "legacy_qkv_attention": PARALLEL_MESH3_ITER - 1}
        if not err <= DRYRUN_ATOL or bundle_launches != want:
            raise AssertionError(f"demo64 model=2 bundle: {err} from unsharded, launches "
                                 f"{bundle_launches} (expected {want})")
        # DPS_y0 under model = 2 and under space = 2 (on the same two ranks)
        nfe = PARALLEL_MESH3_ITER - 1
        dps_launches = {}
        for axis in ("model", "space"):
            err = float(np.abs(load(f"dps_{axis}.npy") - load("dps_ref.npy")).max())
            dps = [r["dps"][axis] for r in pair]
            dps_launches[axis] = dps[0]["launches"]
            runs.append(dict(run=f"demo64_hq DPS_y0 deblur, {axis} = 2, fp32 b2 64px",
                             backend="gloo (host-staged)", world=2, mesh={axis: 2},
                             max_abs_err=err,
                             ms_per_nfe_per_rank=[r["ms_per_nfe"] for r in dps],
                             peak_bytes_per_rank=[r["peak_bytes"] for r in dps],
                             unsharded=dict(ms_per_nfe=ref["dps"]["ref"]["ms_per_nfe"],
                                            peak_bytes=ref["dps"]["ref"]["peak_bytes"]),
                             launches_rank0=dps[0]["launches"]))
            want = ({"groupnorm_silu": 44 * nfe, "legacy_qkv_attention": nfe}
                    if axis == "model" else
                    {"groupnorm_partial_stats": 44 * nfe, "groupnorm_apply_stats": 44 * nfe,
                     "legacy_qkv_attention": nfe})
            if not err <= DRYRUN_ATOL or split_merges(dps[0]["launches"], nfe)[0] != want:
                raise AssertionError(f"demo64 DPS_y0 {axis}=2: {err} from unsharded, "
                                     f"launches {dps[0]['launches']} (expected {want})")
        # the DEMO256 bundle under space = 2 (fp32), against the unsharded
        # restore
        err = float(np.abs(load("space_bundle_ranks.npy")
                           - load("space_bundle_ref.npy")).max())
        sb = [r["space_bundle"] for r in pair]
        space_bundle_launches = sb[0]["launches"]
        rep = sb[0]["report"]
        runs.append(dict(run="demo256 bundle, data x space = 1x2, fp32 b4 256px",
                         backend="gloo (host-staged)", world=2, mesh={"data": 1, "space": 2},
                         max_abs_err=err, export_s=[r["export_s"] for r in sb],
                         step_report=rep, launches_rank0=space_bundle_launches,
                         weights=sb[0]["weights"]))
        nfe = PARALLEL_ITER - 1
        want = {"groupnorm_partial_stats": 65 * nfe, "groupnorm_apply_stats": 65 * nfe,
                "legacy_qkv_attention": 4 * nfe}
        halves = {k: rep.get(k, 0) for k in ("groupnorm_partial_stats",
                                             "groupnorm_apply_stats",
                                             "groupnorm_merge_stats")}
        if (not err <= DRYRUN_ATOL or split_merges(space_bundle_launches, nfe)[0] != want
                or set(halves.values()) != {65} or rep.get("groupnorm_silu", 0)
                or rep.get("plain_nodes", 0) or not rep.get("collectives")):
            raise AssertionError(f"demo256 space=2 bundle: {err} from unsharded, launches "
                                 f"{space_bundle_launches} (expected {want}), step {rep}")
        # the sharded train step
        train = spawn("chip_smoke:parallel_train", 4, [], env=env, timeout=600)
        ref_loss = dryrun_train_step(1)
        err = max(abs(r["loss"] - ref_loss) for r in train)
        runs.append(dict(run="dryrun_train_step(4) fp32", backend="gloo (host-staged)",
                         world=4, mesh={"data": 2, "model": 2}, loss=train[0]["loss"],
                         loss_one_rank=ref_loss, max_abs_err=err,
                         s_per_rank=[r["s"] for r in train],
                         peak_bytes_per_rank=[r["peak_bytes"] for r in train]))
        if not err <= PARALLEL_TRAIN_ATOL:
            raise AssertionError(f"sharded train loss {train[0]['loss']}, one rank "
                                 f"{ref_loss}")
        # one rank over NCCL
        (nccl,) = spawn("chip_smoke:parallel_nccl", 1, [work, free_port()], env=env,
                        timeout=300)
        from diffpir_tpu_torch.runner import Runner

        cfg = _parallel_cfg("inpaint", "tiny_demo32", "float32", 2, PARALLEL_MESH3_ITER)
        own = Runner(cfg, device=dev).restore_batch(
            _dryrun_batch(np.random.default_rng(4), 2, 32, "inpaint"), seed=0)
        equal = bool(np.array_equal(own, load("nccl_restore.npy")))
        runs.append(dict(run="tiny_demo32 one-rank NCCL group", world=1,
                         backend=nccl["backend"], mesh=None,
                         max_abs_err=float(np.abs(own - load("nccl_restore.npy")).max()),
                         bit_equal=equal, collectives_ok=nccl["collectives_ok"],
                         ms_per_nfe_per_rank=[nccl["ms_per_nfe"]],
                         peak_bytes_per_rank=[nccl["peak_bytes"]]))
        if not (nccl["backend"] == "nccl" and nccl["collectives_ok"] and equal):
            raise AssertionError(f"one-rank NCCL group: {nccl}, bit-equal {equal}")
        for r in runs:
            log("parallel: " + json.dumps(r))
        log(f"parallel: spawned groups took {pair_s:.1f} s (2 ranks) and {mesh8_s:.1f} s "
            "(8 ranks), rank start-up included")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return dict(runs=runs, sp_launches=sp_launches, bundle_launches=bundle_launches,
                dps_launches=dps_launches, space_bundle_launches=space_bundle_launches)


def formats_phase(dev, root: str) -> dict:
    """Phase formats: every file of testsets/demo64_formats decoded by the
    port (no Pillow in this process) against the sha256 digests of Pillow's
    conversions committed beside them; the host time of decoding the
    500x375 4:2:0 JPEG; and the demo64 inpaint CLI on the baseline JPEG test
    set at FORMATS_ITER steps, held to the JAX package's CPU PSNR of the same
    run and to its launch counts."""
    import hashlib

    import torch

    from diffpir_tpu_torch.config import load_config
    from diffpir_tpu_torch.kernels import LAUNCHES
    from diffpir_tpu_torch.main import main as cli_main
    from diffpir_tpu_torch.utils.image import list_images
    from diffpir_tpu_torch.utils.imageio import decode_image

    folder = os.path.join(REPO, "testsets", "demo64_formats")
    with open(os.path.join(folder, "digests.json")) as f:
        digests = json.load(f)
    bad = []
    for rel, want in sorted(digests.items()):
        with open(os.path.join(folder, rel), "rb") as f:
            data = f.read()
        for mode in ("RGB", "L"):
            got = hashlib.sha256(decode_image(data, mode).tobytes()).hexdigest()
            if got != want[mode]:
                bad.append(f"{rel} {mode}")
    if "PIL" in sys.modules:
        raise AssertionError("phase formats ran with Pillow imported")
    if bad:
        raise AssertionError(f"decodes that differ from Pillow's digests: {bad}")
    log(f"formats: {len(digests)} files x RGB, L equal to Pillow's digests (no Pillow "
        "in this process)")

    with open(os.path.join(folder, FORMATS_BIG_JPEG), "rb") as f:
        big = f.read()
    decode_ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        decode_image(big)
        decode_ms.append((time.perf_counter() - t0) * 1e3)
    log(f"formats: {FORMATS_BIG_JPEG} ({len(big)} bytes) decodes in "
        f"{sorted(decode_ms)[2]:.3f} ms host time (median of 5: "
        f"{', '.join(f'{t:.3f}' for t in decode_ms)})")

    opt = "configs/demo64_inpaint.yaml"
    over = {"save_E": False, "save_L": False, "testset_name": FORMATS_TESTSET,
            "iter_num": FORMATS_ITER}
    argv = ["--opt", opt, "--no-sweep", "--json"]
    for k, v in over.items():
        argv += ["--set", f"{k}={v if isinstance(v, str) else json.dumps(v)}"]
    cfg = load_config(opt, over)
    names = list_images(cfg.L_path)
    forwards = math.ceil(len(names) / cfg.batch_size) * forwards_per_batch(cfg)
    LAUNCHES.clear()
    t0 = time.perf_counter()
    res = cli_main(argv)[0]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    want = {"groupnorm_silu": 44 * forwards, "legacy_qkv_attention": 1 * forwards}
    log(f"formats: CLI on {FORMATS_TESTSET} ({len(names)} JPEGs, iter_num "
        f"{FORMATS_ITER}): PSNR {res['psnr']:.4f} dB (JAX CPU {JAX_FORMATS_PSNR:.4f}), "
        f"{wall:.3f}s, launches {launches}, {forwards} UNet forwards")
    if not all(n.endswith(".jpg") for n in names):
        raise AssertionError(f"the JPEG test set holds {names}")
    if launches != want:
        raise AssertionError(f"launches {launches}, expected {want}")
    if not abs(res["psnr"] - JAX_FORMATS_PSNR) <= PSNR_TOL_DB:
        raise AssertionError(f"PSNR {res['psnr']} is not within {PSNR_TOL_DB} dB of the "
                             f"JAX package's {JAX_FORMATS_PSNR}")
    return {"files": len(digests), "decode_ms_500x375": sorted(decode_ms)[2],
            "cli_psnr": res["psnr"], "cli_launches": launches, "cli_seconds": wall}


# the phases --only runs: each needs nothing of an earlier phase but the build
ONLY_PHASES = {"export": export_phase, "parallel": parallel_phase, "formats": formats_phase}


def timed_host_ms(fn, iters: int = 5) -> float:
    """Mean wall time of ``fn`` in ms (host round trips included: each call
    takes numpy in and gives a number or numpy back)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def read_losses(csv_path: str) -> list:
    """The per-step ``loss`` column of a kvlogger CSV, in step order."""
    import csv

    with open(csv_path) as f:
        rows = list(csv.DictReader(f))
    return [float(r["loss"]) for r in sorted(rows, key=lambda r: int(r["step"]))]


# ---------------------------------------------------------------------------

def run(argv: list[str]) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="smoke test of the port on one CUDA card")
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after phase kernels; print its per-forward sums")
    ap.add_argument("--package-root", default=REPO,
                    help="checkout whose diffpir_tpu_torch (and kernels) to run")
    ap.add_argument("--only", default=None, metavar="PHASES",
                    help="after build, run only these comma-separated phases of "
                         f"{'/'.join(ONLY_PHASES)} and print their results (no result "
                         "line)")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.package_root)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr, flush=True)
        return 2
    if not os.path.isdir(os.path.join(root, "diffpir_tpu_torch")):
        print(f"chip_smoke: no diffpir_tpu_torch package in {root}",
              file=sys.stderr, flush=True)
        return 2
    os.chdir(REPO)
    sys.path.insert(0, root)
    dev = torch.device("cuda")

    with phase("preflight"):
        import diffpir_tpu_torch  # noqa: F401
        import diffpir_tpu_torch.main  # noqa: F401
        import diffpir_tpu_torch.train.datasets  # noqa: F401
        import diffpir_tpu_torch.train.demo  # noqa: F401
        from diffpir_tpu_torch.kernels import LAUNCHES, build
        from diffpir_tpu_torch.kernels import attention as kat

        bad = sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)
        if bad:
            raise RuntimeError(f"the port pulled in forbidden modules: {bad}")
        nvcc = build.find_nvcc()
        nvcc_version = subprocess.run([nvcc, "--version"], capture_output=True,
                                      text=True, timeout=60, check=True).stdout
        card = smi_line()
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
        log(f"package {diffpir_tpu_torch.__file__}")
        log(f"torch {torch.__version__} cuda {torch.version.cuda} | nvcc {nvcc} "
            f"({nvcc_version.strip().splitlines()[-1]}) | {card} | "
            f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
            f"matmul_precision={torch.get_float32_matmul_precision()} | "
            f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    with phase("build"):
        info = build.build()
        build.load_library()
        log(f"built={info.built} seconds={info.seconds:.3f} lib={os.path.relpath(info.path)}")
        for line in info.log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log("  ptxas: " + line.strip())
        # another checkout's spills (--package-root) are not under test
        if root == REPO and build.spill_bytes(info.log):
            raise AssertionError(f"ptxas reports {build.spill_bytes(info.log)} bytes "
                                 "of spills")

    if args.only:
        for name in args.only.split(","):
            if name not in ONLY_PHASES:
                raise ValueError(f"--only takes {ONLY_PHASES}, got {name!r}")
            with phase(name):
                log(f"{name}: " + json.dumps(ONLY_PHASES[name](dev, root)))
        return 0

    from diffpir_tpu_torch import sampler
    from diffpir_tpu_torch.config import load_config
    from diffpir_tpu_torch.data import make_batches, prepare_images
    from diffpir_tpu_torch.main import main as cli_main
    from diffpir_tpu_torch.models import zoo
    from diffpir_tpu_torch.models.unet import UNet, UNetConfig
    from diffpir_tpu_torch.models.variants import EncoderUNet
    from diffpir_tpu_torch.runner import Runner
    from diffpir_tpu_torch.schedule import (NoiseSchedule, build_plan,
                                            make_progress_slots)
    from diffpir_tpu_torch.utils.image import list_images

    gen = torch.Generator(device=dev).manual_seed(0)
    t_probe = torch.tensor([999, 500, 250, 10], dtype=torch.int32, device=dev)

    with phase("kernels"):
        # the calls one forward makes on each path, recorded with the plain
        # versions
        demo32 = zoo.resolve_model("tiny_demo32", "model_zoo", dtype=torch.float32,
                                   device=dev, kernels="plain").model
        calls32 = record_kernel_calls(
            demo32, torch.randn((4, 32, 32, 3), generator=gen, device=dev), t_probe)
        del demo32
        demo64 = zoo.resolve_model("demo64_hq", "model_zoo", dtype=torch.float32,
                                   device=dev, kernels="plain").model
        calls64 = record_kernel_calls(
            demo64, torch.randn((4, 64, 64, 3), generator=gen, device=dev), t_probe)
        del demo64
        flag = zoo.init_random_(UNet(zoo.DEMO256_CONFIG, dtype=torch.bfloat16,
                                     kernels="plain"), 0).to(dev).eval()
        calls256 = record_kernel_calls(
            flag, torch.randn((4, 256, 256, 3), generator=gen, device=dev), t_probe)
        # the train step's forward (phase train: the DEMO256 recipe at b16)
        calls256b16 = record_kernel_calls(
            flag, torch.randn((16, 256, 256, 3), generator=gen, device=dev),
            t_probe.repeat(4))
        del flag
        ffhq = zoo.init_random_(UNet(zoo.MODEL_ZOO_CONFIGS["diffusion_ffhq_10m"],
                                     dtype=torch.bfloat16, kernels="plain"),
                                0).to(dev).eval()
        callsffhq = record_kernel_calls(
            ffhq, torch.randn((16, 256, 256, 3), generator=gen, device=dev),
            t_probe.repeat(4))
        del ffhq
        uncond = zoo.init_random_(UNet(zoo.MODEL_ZOO_CONFIGS["256x256_diffusion_uncond"],
                                       dtype=torch.bfloat16, kernels="plain"),
                                  0).to(dev).eval()
        calls553 = record_kernel_calls(
            uncond, torch.randn((1, 256, 256, 3), generator=gen, device=dev), t_probe[:1])
        del uncond
        uncond4 = zoo.init_random_(UNet(dataclasses.replace(
            zoo.MODEL_ZOO_CONFIGS["256x256_diffusion_uncond"], **UNCOND_4HEADS),
            dtype=torch.bfloat16, kernels="plain"), 0).to(dev).eval()
        calls553h4 = record_kernel_calls(
            uncond4, torch.randn((1, 256, 256, 3), generator=gen, device=dev), t_probe[:1])
        calls553h4b8 = record_kernel_calls(
            uncond4, torch.randn((8, 256, 256, 3), generator=gen, device=dev),
            t_probe.repeat(2))
        del uncond4
        clf = zoo.init_random_(EncoderUNet(UNetConfig(**CLASSIFIER_256), pool="attention",
                                           dtype=torch.bfloat16, kernels="plain"),
                               0).to(dev).eval()
        callsclf = record_kernel_calls(
            clf, torch.randn((CLASSIFIER_BATCH, 256, 256, 3), generator=gen, device=dev),
            t_probe.repeat(CLASSIFIER_BATCH // 4))
        del clf
        torch.cuda.empty_cache()
        paths = (("demo32", calls32), ("demo64", calls64), ("demo256", calls256),
                 ("ffhq b16", callsffhq), ("uncond553m b1", calls553),
                 ("demo256 b16", calls256b16), ("classifier b8", callsclf),
                 ("uncond553m 4 heads b1", calls553h4), ("uncond553m 4 heads b8", calls553h4b8))
        for name, calls in paths:
            log(f"{name}: {sum(c[0] == 'gn' for c in calls)} GroupNorm and "
                f"{sum(c[0] == 'attn' for c in calls)} attention calls per forward")

        gn_keys, attn_keys = set(), set()
        for calls, dtypes in ((calls32 + calls64 + calls256, ("float32", "bfloat16")),
                              (callsffhq + calls553 + calls256b16 + calls553h4 + calls553h4b8,
                               ("bfloat16",))):
            for c in calls:
                for dt in dtypes:
                    if c[0] == "gn":
                        gn_keys.add((c[1], dt, c[3], c[4]))
                    else:
                        attn_keys.add((c[1], c[2], c[3], c[4], dt))
        for dt in ("float32", "bfloat16"):
            attn_keys.add((4, 1024, 8, 64, dt))  # 256x256_diffusion_uncond at ds8
            # the generic kernel: every other head width, as a config with
            # num_heads set and num_head_channels -1 gives them
            for ch in GENERIC_WIDTHS:
                for t in (64, 256, 1024):
                    attn_keys.add((8, t, 4, ch, dt))
            for key in ODD_WIDTH_CASES + WIDE_CASES:
                attn_keys.add(key + (dt,))
            # the spatial_v2 classifier head's GroupNorm: one pixel, 2048 channels
            gn_keys.add(((CLASSIFIER_BATCH, 1, 1, 2048), dt, False, False))
        # the four-head 553M model's attention in fp32 (phase serve's fp32
        # forward, all on attn_f32_any)
        calls553h4f32 = [c[:5] + ("float32",) for c in calls553h4 if c[0] == "attn"]
        for c in calls553h4f32:
            attn_keys.add(c[1:])
        # the classifier in its own types: bf16, and fp32 at out_norm
        for c in callsclf:
            (gn_keys if c[0] == "gn" else attn_keys).add(c[1:])
        attn_keys.add(PAIRS_CASE + ("bfloat16",))

        def columns(r):
            return " ".join(f"{k}={r[k]:.4f}" for k in (
                "ms", "dispatch_ms", "plain_ms", "plain_dispatch_ms", "library_ms",
                "library_dispatch_ms"))

        results, failures = {}, []
        for key in sorted(gn_keys):
            r = results[("gn",) + key] = gn_case(*key, gen)
            log(f"groupnorm_silu shape={key[0]} {key[1]} film={key[2]} silu={key[3]}: "
                f"max_abs_err={r['err']:.3e} repeats={r['repeats']} {columns(r)} "
                f"bound_ms={bound(r)[0]:.4e}"
                + ("" if r["ok"] and r["repeats"] else "  FAIL"))
            if not (r["ok"] and r["repeats"]):
                failures.append(("groupnorm_silu",) + key)
        for key in sorted(attn_keys):
            r = results[("attn",) + key] = attn_case(*key, gen)
            log(f"legacy_qkv_attention B={key[0]} T={key[1]} heads={key[2]} ch={key[3]} "
                f"{key[4]} variant={r['variant']}: max_abs_err={r['err']:.3e} "
                f"repeats={r['repeats']} "
                f"{columns(r)} (library err {r['library_err']:.2e}) "
                f"bound_ms={bound(r)[0]:.4e} ({bound(r)[1]})"
                + (f" cuda_core_bound_ms={r['flops'] / PEAK_FLOPS['float32'] * 1e3:.4e}"
                   if key[4] == "float32" else "")
                + ("" if r["ok"] and r["repeats"] else "  FAIL"))
            if not (r["ok"] and r["repeats"]):
                failures.append(("legacy_qkv_attention",) + key)
        # the sharded GroupNorm's halves at a space rank's shard of DEMO256
        # (bf16, batch 4, half the rows: phase parallel's sp run) and of demo64
        # (fp32)
        half_keys = set()
        for calls, dt in ((calls256, "bfloat16"), (calls64, "float32")):
            for c in calls:
                if c[0] == "gn":
                    b_, h_, w_, c_ = c[1]
                    half_keys.add(((b_, h_ // 2, w_, c_), dt, c[3], c[4]))
        half = {}
        for key in sorted(half_keys):
            r = half[key] = gn_half_cases(*key, gen)
            for part, name in (("partial", "groupnorm_partial_stats"),
                               ("apply", "groupnorm_apply_stats")):
                rp = r[part]
                log(f"{name} shape={key[0]} {key[1]} film={key[2]} silu={key[3]}: "
                    f"max_err={rp['err']:.3e} repeats={rp['repeats']} {columns(rp)} "
                    f"bound_ms={bound(rp)[0]:.4e}"
                    + ("" if rp["ok"] and rp["repeats"] else "  FAIL"))
                if not (rp["ok"] and rp["repeats"]):
                    failures.append((name,) + key)
        hm = gn_high_mean_case(gen)
        log(f"groupnorm_silu high mean (4, 64, 64, 384) float32 x*0.03+100: |kernel - "
            f"plain| {hm['err']:.3e} (atol 1e-3); against fp64 statistics: kernel "
            f"{hm['kernel_exact']:.3e}, plain {hm['plain_exact']:.3e}"
            + ("" if hm["ok"] else "  FAIL"))
        if not hm["ok"]:
            failures.append(("groupnorm_silu", "high mean"))
        if failures:
            raise AssertionError(f"kernels disagree with their plain versions or do "
                                 f"not repeat: {failures}")

        timed = ("ms", "dispatch_ms", "plain_ms", "plain_dispatch_ms", "library_ms",
                 "library_dispatch_ms")

        def per_forward(calls, kind):
            """Sums over the calls of one forward (times, bound, errors)."""
            rows = []
            for c in calls:
                if c[0] != kind:
                    continue
                rows.append(results[("gn", c[1], c[2], c[3], c[4]) if kind == "gn"
                                    else ("attn",) + c[1:]])
            tot = {k: sum(r[k] for r in rows) for k in timed}
            tot["bound_ms"] = sum(bound(r)[0] for r in rows)
            by = [bound(r)[1] for r in rows]
            tot["bound_by"] = max(set(by), key=by.count)
            tot["max_abs_err"] = max(r["err"] for r in rows)
            tot["calls"] = len(rows)
            return tot

        per_fwd = {(path, kind): per_forward(calls, kind)
                   for path, calls in paths for kind in ("gn", "attn")}
        per_fwd[("uncond553m 4 heads fp32 b1", "attn")] = per_forward(calls553h4f32, "attn")

        def half_per_forward(part):
            """Sums over the GroupNorm calls of one DEMO256 forward on a space
            rank (batch 4, 128 of the 256 rows) of one half."""
            rows = [half[((c[1][0], c[1][1] // 2) + c[1][2:], "bfloat16", c[3], c[4])][part]
                    for c in calls256 if c[0] == "gn"]
            tot = {k: sum(r[k] for r in rows) for k in timed}
            tot["bound_ms"] = sum(bound(r)[0] for r in rows)
            by = [bound(r)[1] for r in rows]
            tot["bound_by"] = max(set(by), key=by.count)
            tot["max_abs_err"] = max(r["err"] for r in rows)
            tot["calls"] = len(rows)
            return tot

        per_fwd[("demo256 sp2 shard", "partial")] = half_per_forward("partial")
        per_fwd[("demo256 sp2 shard", "apply")] = half_per_forward("apply")
        wide = {" ".join(map(str, k[1:])): {f: results[k][f] for f in
                                             ("err", "ms", "plain_ms", "library_ms")}
                | {"bound_ms": bound(results[k])[0]}
                for k in results if k[0] == "attn"
                and (k[1:5] in WIDE_CASES or k[1:5] == PAIRS_CASE)}
        for (path, kind), tot in per_fwd.items():
            log(f"per forward {path} {kind}: {tot['calls']} calls, kernel "
                f"{tot['ms']:.4f} ms device / {tot['dispatch_ms']:.4f} ms dispatch, "
                f"plain {tot['plain_ms']:.4f} / {tot['plain_dispatch_ms']:.4f} ms, "
                f"library {tot['library_ms']:.4f} / {tot['library_dispatch_ms']:.4f} ms, "
                f"bound {tot['bound_ms']:.4f} ms ({tot['bound_by']})")
        log("kernels: groupnorm_silu (diffpir_tpu_torch/kernels/csrc/groupnorm.cu), "
            "legacy_qkv_attention (diffpir_tpu_torch/kernels/csrc/attention.cu): "
            f"{len(gn_keys)} + {len(attn_keys)} cases agree and repeat bit for bit")

    if args.kernels_only:
        log(json.dumps({"package": root, "card": card, "per_forward": {
            f"{path} {kind}": tot for (path, kind), tot in per_fwd.items()},
            "cases": {" ".join(map(str, k)): {f: r[f] for f in timed}
                      for k, r in results.items()}}))
        return 0

    with phase("main"):
        opt = "configs/demo64_inpaint.yaml"
        argv = ["--opt", opt, "--no-sweep", "--set", "save_E=false",
                "--set", "save_L=false", "--json"]
        cfg = load_config(opt, {"save_E": False, "save_L": False})
        n_batches = math.ceil(len(list_images(cfg.L_path)) / cfg.batch_size)
        forwards = n_batches * forwards_per_batch(cfg)
        count_function_entries()
        LAUNCHES.clear()
        kat.VARIANT_LAUNCHES.clear()
        FN_CALLS.clear()
        t0 = time.perf_counter()
        res = cli_main(argv)[0]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        main_launches = dict(LAUNCHES)
        main_variants = dict(kat.VARIANT_LAUNCHES)
        if FN_CALLS:
            raise AssertionError(f"the DiffPIR path entered autograd.Functions: "
                                 f"{dict(FN_CALLS)}")
        log(f"main path: PSNR {res['psnr']:.4f} dB (JAX CPU {JAX_DEMO64_PSNR:.4f}), "
            f"SSIM {res['ssim']:.4f}, {wall:.3f}s, launches {main_launches} (attention "
            f"by variant {main_variants}), {forwards} UNet forwards")
        want = {"groupnorm_silu": 44 * forwards, "legacy_qkv_attention": 1 * forwards}
        if main_launches != want:
            raise AssertionError(f"launches {main_launches}, expected {want}")
        if not abs(res["psnr"] - JAX_DEMO64_PSNR) <= PSNR_TOL_DB:
            raise AssertionError(f"PSNR {res['psnr']} is not within {PSNR_TOL_DB} dB "
                                 f"of the JAX package's {JAX_DEMO64_PSNR}")

        np.random.seed(cfg.seed)
        batch = make_batches(prepare_images(cfg), cfg.batch_size)[0]
        kern_runner = Runner(cfg, device=dev)
        plain_runner = Runner(cfg, device=dev, kernels="plain")
        LAUNCHES.clear()
        res_plain = plain_runner.evaluate()
        if sum(LAUNCHES.values()):
            raise AssertionError(f"the plain run launched kernels: {dict(LAUNCHES)}")
        gap = abs(res_plain["psnr"] - res["psnr"])
        img_k = kern_runner.restore_batch(batch, seed=cfg.seed)
        img_p = plain_runner.restore_batch(batch, seed=cfg.seed)
        log(f"plain versions: PSNR {res_plain['psnr']:.4f} dB, gap {gap:.4f} dB, "
            f"restored images max |kernel - plain| {abs(img_k - img_p).max():.3e}")
        if not gap <= PLAIN_PSNR_TOL_DB:
            raise AssertionError(f"kernel and plain PSNR differ by {gap} dB")
        del kern_runner, plain_runner

    with phase("formats"):
        formats_out = formats_phase(dev, root)
        log("formats: " + json.dumps(formats_out))

    with phase("tasks"):
        per_forward_calls = {"tiny_demo32": calls32, "demo64_hq": calls64,
                             "demo256": calls256}
        task_launches, task_ms_nfe, task_psnr = {}, {}, {}
        for name, opt, over, jax_psnr, n_seeds in TASK_RUNS:
            over = {"save_E": False, "save_L": False, **over}
            argv = ["--opt", opt, "--no-sweep"]
            for k, v in over.items():
                argv += ["--set", f"{k}={v if isinstance(v, str) else json.dumps(v)}"]
            cfg = load_config(opt, over)
            calls = per_forward_calls[cfg.model_name]
            forwards = (math.ceil(len(list_images(cfg.L_path)) / cfg.batch_size)
                        * forwards_per_batch(cfg))
            runs = n_seeds * forwards
            want = {"groupnorm_silu": sum(c[0] == "gn" for c in calls) * runs,
                    "legacy_qkv_attention": sum(c[0] == "attn" for c in calls) * runs}
            # only DPS_y0 differentiates through the UNet: each of its kernel
            # calls goes through the kernel's autograd.Function
            want_fn = want if cfg.generate_mode == "DPS_y0" else {}
            LAUNCHES.clear()
            FN_CALLS.clear()
            t0 = time.perf_counter()
            res_seeds = [cli_main(argv + ["--set", f"seed={cfg.seed}"])[0]]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if n_seeds > 1:
                # the other seeds through one Runner: the CLI's evaluate
                # (main.py: Runner(cfg).evaluate()) without reloading the
                # weights for every seed
                seeds_runner = Runner(load_config(opt, over), device=dev)
                for seed in range(cfg.seed + 1, cfg.seed + n_seeds):
                    seeds_runner.cfg.seed = seed
                    res_seeds.append(seeds_runner.evaluate())
                del seeds_runner
            task_launches[name] = dict(LAUNCHES)
            res = res_seeds[0]
            task_psnr[name] = res["psnr"]
            psnr = float(np.mean([r["psnr"] for r in res_seeds]))
            if task_launches[name] != want:
                raise AssertionError(f"{name}: launches {task_launches[name]}, "
                                     f"expected {want}")
            fn_calls = dict(FN_CALLS)
            if fn_calls != want_fn:
                raise AssertionError(f"{name}: autograd.Function entries "
                                     f"{fn_calls}, expected {want_fn}")
            if {r["weights"] for r in res_seeds} != {"demo"}:
                raise AssertionError(f"{name}: weights are {res['weights']!r}, not the "
                                     "trained prior under assets/demo")
            if not abs(psnr - jax_psnr) <= PSNR_TOL_DB:
                raise AssertionError(f"{name}: PSNR {psnr} (mean of {n_seeds} seeds) is "
                                     f"not within {PSNR_TOL_DB} dB of the JAX package's "
                                     f"{jax_psnr}")

            plain_runner = Runner(cfg, device=dev, kernels="plain")
            LAUNCHES.clear()
            res_plain = plain_runner.evaluate()
            if sum(LAUNCHES.values()):
                raise AssertionError(f"{name}: the plain run launched kernels: "
                                     f"{dict(LAUNCHES)}")
            del plain_runner
            gap = abs(res_plain["psnr"] - res["psnr"])
            if not gap <= PLAIN_PSNR_TOL_DB:
                raise AssertionError(f"{name}: kernel and plain PSNR differ by {gap} dB")

            # one more run: ms per NFE, and the prox's share by CUDA events
            # around each of its calls
            runner = Runner(cfg, device=dev)
            prox_events = []
            make_prox = runner.make_prox

            def timed_make_prox(*a, make_prox=make_prox, prox_events=prox_events):
                prox = make_prox(*a)

                def timed(x0, tau):
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    out = prox(x0, tau)
                    end.record()
                    prox_events.append((start, end))
                    return out

                return timed

            runner.make_prox = timed_make_prox
            np.random.seed(cfg.seed)
            batches = make_batches(prepare_images(cfg), cfg.batch_size)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs = [runner.restore_batch(b, seed=cfg.seed + bi)
                    for bi, b in enumerate(batches)]
            torch.cuda.synchronize()
            ms_nfe = task_ms_nfe[name] = (time.perf_counter() - t0) * 1e3 / forwards
            frames_note = ""
            if cfg.log_process:
                n_slots = int(make_progress_slots(runner._plan(cfg.lambda_).n_steps).max()) + 1
                for (img, frames), b in zip(outs, batches):
                    if frames.shape != (n_slots,) + b.img_H.shape:
                        raise AssertionError(f"{name}: frames {frames.shape}, expected "
                                             f"{(n_slots,) + b.img_H.shape}")
                    if not np.array_equal(frames[-1], img):
                        raise AssertionError(f"{name}: the last frame is not the output")
                frames_note = f"; {n_slots} frames per image, the last one the output"
            prox_nfe = sum(a.elapsed_time(b) for a, b in prox_events) / forwards
            del runner
            torch.cuda.empty_cache()
            spread = ""
            if n_seeds > 1:
                ps = [r["psnr"] for r in res_seeds]
                spread = (f" (mean of seeds {cfg.seed}..{cfg.seed + n_seeds - 1}: min "
                          f"{min(ps):.4f}, max {max(ps):.4f}, std {np.std(ps):.4f})")
            log(f"task {name}: {cfg.task} {cfg.sr_mode if cfg.task == 'sr' else ''} "
                f"{cfg.model_name} {cfg.dtype} weights={res['weights']} PSNR "
                f"{psnr:.4f} dB{spread} (JAX CPU {jax_psnr:.4f}); seed {cfg.seed} "
                f"{res['psnr']:.4f}, plain {res_plain['psnr']:.4f} (gap {gap:.4f}), SSIM "
                f"{res['ssim']:.4f}, CLI {wall:.3f}s (seed {cfg.seed}), {forwards} "
                f"forwards, launches "
                f"{task_launches[name]}; timed run {ms_nfe:.4f} ms per NFE: prox "
                f"{prox_nfe:.4f} ms ({len(prox_events)} calls), UNet and renoise "
                f"{ms_nfe - prox_nfe:.4f} ms; autograd.Function entries "
                f"{fn_calls}{frames_note}")

    with phase("grad"):
        grad_results = {}
        for name, opt, over in (
                ("demo64 fp32", "configs/demo64_deblur.yaml", {}),
                ("demo256 bf16", "configs/demo256_deblur.yaml", {"iter_num": 20})):
            # the plan's row 5 (t ~ 500): x0 = c1 x - c2 eps with c1, c2 ~ 1-3,
            # away from t = 999 where c1 = 156 and the clamp's branch decides
            g = dps_grad_case(opt, over, 5, gen, dev)
            rel, cos = grad_agreement(g["cuda"], g["plain"])
            rel_d, cos_d = grad_agreement(g["detached"], g["plain"])
            tol, min_cos = GRAD_REL_TOL[g["dtype"]], GRAD_MIN_COSINE[g["dtype"]]
            ok = rel <= tol and cos >= min_cos
            control_fails = not (rel_d <= tol and cos_d >= min_cos)
            floor = ""
            if "fp32" in g:
                rel_k32, _ = grad_agreement(g["cuda"], g["fp32"])
                rel_p32, _ = grad_agreement(g["plain"], g["fp32"])
                floor = (f"; against the fp32 gradient: kernels {rel_k32:.3e}, plain "
                         f"{rel_p32:.3e}")
            grad_results[name] = dict(t=g["t"], rel_l2=rel, cosine=cos,
                                      detached_rel_l2=rel_d, detached_cosine=cos_d,
                                      forward_ms=g["forward_ms"],
                                      forward_backward_ms=g["forward_backward_ms"],
                                      plain_forward_backward_ms=g["plain_forward_backward_ms"])
            log(f"DPS_y0 gradient {name} {g['batch']} t={g['t']}: kernels vs plain "
                f"relative L2 {rel:.3e} cosine {cos:.6f} (bounds {tol:g}, {min_cos}); "
                f"detached control relative L2 {rel_d:.3e} cosine {cos_d:.6f}{floor}; event "
                f"ms forward {g['forward_ms']:.4f}, forward and backward "
                f"{g['forward_backward_ms']:.4f} (plain "
                f"{g['plain_forward_backward_ms']:.4f})"
                + ("" if ok and control_fails else "  FAIL"))
            if not ok:
                raise AssertionError(f"{name}: the gradient through the kernels differs "
                                     f"from the plain one (rel {rel}, cosine {cos})")
            if not control_fails:
                raise AssertionError(f"{name}: the detached control passes the bounds, "
                                     "so the check could not see a lost gradient")
        log("grad: " + json.dumps(grad_results))

    with phase("flagship"):
        fcfg = load_config("configs/demo256_inpaint.yaml", {
            "save_E": False, "save_L": False, "iter_num": 20, "batch_size": 4,
            "mask_type": "random", "mask_prob_range": [0.5, 0.5],
            "noise_level_img": 0, "dtype": "bfloat16"})
        np.random.seed(fcfg.seed)
        fbatch = make_batches(prepare_images(fcfg), 4)[0]
        y = torch.from_numpy(fbatch.img_L).to(dev)
        mask = torch.from_numpy(fbatch.mask).to(dev)
        sched = NoiseSchedule.linear(fcfg.beta_start, fcfg.beta_end,
                                     fcfg.num_train_timesteps)
        plan = build_plan(sched, iter_num=fcfg.iter_num, lambda_=fcfg.lambda_,
                          sigma_y=fcfg.sigma)
        sa0 = float(sched.sqrt_alphas_cumprod[-1])
        s1m0 = float(np.sqrt(1 - sched.alphas_cumprod[-1]))
        n_fwd = plan.n_steps - 1
        models = {route: zoo.init_random_(UNet(zoo.DEMO256_CONFIG, dtype=torch.bfloat16,
                                               kernels=route), 0).to(dev).eval()
                  for route in ("cuda", "plain")}

        x_probe = torch.randn((4, 256, 256, 3), generator=gen, device=dev)
        with torch.no_grad():
            fk = models["cuda"](x_probe, t_probe).float()
            fp = models["plain"](x_probe, t_probe).float()
        rel = float((fk - fp).abs().max() / fp.abs().max())
        log(f"one forward: max |kernel - plain| / max |plain| = {rel:.3e}")
        if not rel <= FLAGSHIP_FORWARD_REL_TOL:
            raise AssertionError(f"flagship forward differs by {rel} (relative)")

        def trajectory(route):
            g = torch.Generator(device=dev).manual_seed(0)
            noise = sampler.generator_noise(g, dev)
            x = sampler.init_x("inpaint", y, mask, 1, noise(-1, 0, "init", tuple(y.shape)),
                               sqrt_acp_start=sa0, sqrt_1m_acp_start=s1m0)
            den = sampler.make_denoiser(models[route], sched,
                                        compute_dtype=torch.bfloat16)
            return sampler.diffpir_sample(
                den, sampler.make_inpaint_prox(y, mask), plan, x, noise=noise,
                zeta=fcfg.zeta, y=y, mask=mask, recover_known=True)

        out, ms_per_nfe = {}, {}
        for route in ("cuda", "plain"):
            trajectory(route)  # warm-up: allocations, cuDNN algorithm choice
        for route in ("cuda", "plain", "plain", "cuda"):
            LAUNCHES.clear()
            FN_CALLS.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out[route] = trajectory(route)
            torch.cuda.synchronize()
            ms_per_nfe.setdefault(route, []).append(
                (time.perf_counter() - t0) * 1e3 / n_fwd)
            counts = dict(LAUNCHES)
            want = ({"groupnorm_silu": 65 * n_fwd, "legacy_qkv_attention": 4 * n_fwd}
                    if route == "cuda" else {})
            if counts != want:
                raise AssertionError(f"{route} run launches {counts}, expected {want}")
            if FN_CALLS:
                raise AssertionError(f"the DiffPIR path entered autograd.Functions: "
                                     f"{dict(FN_CALLS)}")
        for route, img in out.items():
            if not bool(torch.isfinite(img).all()):
                raise AssertionError(f"non-finite output on the {route} route")
        diff = (out["cuda"] - out["plain"]).abs()
        log(f"flagship {n_fwd} forwards: ms per NFE kernels {ms_per_nfe['cuda']} "
            f"plain {ms_per_nfe['plain']}; images mean |kernel - plain| "
            f"{float(diff.mean()):.3e} max {float(diff.max()):.3e}; launches per "
            f"run {65 * n_fwd} + {4 * n_fwd}")
        if not float(diff.mean()) <= FLAGSHIP_IMAGE_MEAN_TOL:
            raise AssertionError(f"flagship images differ by {float(diff.mean())} on average")

    with phase("serve"):
        serve_out = serve_phase(dev, gen, calls256, task_ms_nfe["demo256_inpaint"],
                                per_fwd)
        serve_launches = serve_out["launches"]

    with phase("export"):
        export_out = export_phase(dev, root)

    with phase("train"):
        train_out = train_phase(dev, root)

    with phase("variants"):
        variants_out = variants_phase(dev, gen)
        log("variants: " + json.dumps(variants_out))

    with phase("metrics"):
        metrics_out = metrics_phase(dev, cli_main, task_psnr, task_launches)
        log("metrics: " + json.dumps(metrics_out))

    with phase("parallel"):
        parallel_out = parallel_phase(dev, root)

    record = {"kernels": []}
    for name, kind, source, replaces in (
            ("groupnorm_silu", "gn", "diffpir_tpu_torch/kernels/csrc/groupnorm.cu",
             "diffpir_tpu/pallas/groupnorm.py:73"),
            ("legacy_qkv_attention", "attn", "diffpir_tpu_torch/kernels/csrc/attention.cu",
             "diffpir_tpu/pallas/attention.py:47")):
        tot = per_fwd[("demo64", kind)]
        record["kernels"].append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": main_launches.get(name, 0),
            "launches_per_path": {"main demo64_inpaint": main_launches.get(name, 0),
                                  **{f"tasks {t}": n.get(name, 0)
                                     for t, n in task_launches.items()},
                                  "serve demo256_inpaint": serve_launches.get(name, 0),
                                  "train demo256 step":
                                      train_out["launches_per_step"].get(name, 0),
                                  "variants classifier forward":
                                      variants_out["launches_per_forward"].get(name, 0),
                                  "variants guided steps":
                                      variants_out["guided_launches"].get(name, 0),
                                  "variants superres forward":
                                      variants_out["superres_launches"].get(name, 0),
                                  "metrics demo256_inpaint":
                                      metrics_out["launches"].get(name, 0),
                                  **{f"export {b} bundle": n.get(name, 0)
                                     for b, n in export_out["launches"].items()},
                                  "parallel demo64 model=2 bundle rank 0":
                                      parallel_out["bundle_launches"].get(name, 0),
                                  "parallel demo64 DPS_y0 model=2 rank 0":
                                      parallel_out["dps_launches"]["model"].get(name, 0)},
            "max_abs_err": max(r["err"] for k, r in results.items() if k[0] == kind),
            "ms": tot["ms"], "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
            "bound_by": tot["bound_by"], "library_ms": tot["library_ms"],
            "dispatch_ms": tot["dispatch_ms"],
            "plain_dispatch_ms": tot["plain_dispatch_ms"],
            "library_dispatch_ms": tot["library_dispatch_ms"],
            "basis": "sum over the calls of one UNet forward of the main path "
                     "(demo64_hq, fp32, batch 4, 64 px); ms, plain_ms, library_ms "
                     "by CUDA-graph replay (device), *_dispatch_ms by back-to-back "
                     "calls",
            "demo32_per_forward": per_fwd[("demo32", kind)],
            "flagship_per_forward": per_fwd[("demo256", kind)],
            "ffhq_b16_per_forward": per_fwd[("ffhq b16", kind)],
            "uncond553m_b1_per_forward": per_fwd[("uncond553m b1", kind)],
            "uncond553m_4heads_b1_per_forward": per_fwd[("uncond553m 4 heads b1", kind)],
            "uncond553m_4heads_b8_per_forward": per_fwd[("uncond553m 4 heads b8", kind)],
            **({"uncond553m_4heads_fp32_b1_per_forward":
                per_fwd[("uncond553m 4 heads fp32 b1", kind)]} if kind == "attn" else {}),
            "train_demo256_b16_per_forward": per_fwd[("demo256 b16", kind)],
            "classifier_b8_per_forward": per_fwd[("classifier b8", kind)]})
        if kind == "gn":
            record["kernels"][-1]["launches_per_path"]["parallel 553M tp=2 rank 0"] = \
                parallel_out["runs"][0]["launches_rank0"].get(name, 0)
        else:
            record["kernels"][-1]["wide_heads_and_pairs"] = wide
            record["kernels"][-1]["launches_by_variant"] = {
                "main demo64_inpaint": main_variants,
                "serve uncond553m 4 heads b1 forward": serve_out["uncond553m_4heads_variants"],
                "serve uncond553m 4 heads fp32 b1 forward":
                    serve_out["uncond553m_4heads_fp32_variants"]}
            paths = record["kernels"][-1]["launches_per_path"]
            paths["parallel demo256 sp=2 rank 0"] = parallel_out["sp_launches"].get(name, 0)
            paths["parallel demo256 space=2 bundle rank 0"] = \
                parallel_out["space_bundle_launches"].get(name, 0)
            paths["parallel demo64 DPS_y0 space=2 rank 0"] = \
                parallel_out["dps_launches"]["space"].get(name, 0)
    # the two halves of the sharded GroupNorm, on the sp path: launches of
    # rank 0 of phase parallel's DEMO256 sp=2 restore, times summed over the
    # calls of one forward on a space rank
    for name, part in (("groupnorm_partial_stats", "partial"),
                       ("groupnorm_apply_stats", "apply")):
        tot = per_fwd[("demo256 sp2 shard", part)]
        record["kernels"].append({
            "name": name, "route": "cuda",
            "source": "diffpir_tpu_torch/kernels/csrc/" + (
                "groupnorm_partial.cu" if part == "partial" else "groupnorm.cu"),
            "replaces": "diffpir_tpu/pallas/groupnorm.py:73",
            "launches": parallel_out["sp_launches"].get(name, 0),
            "launches_per_path": {
                "parallel demo256 sp=2 rank 0": parallel_out["sp_launches"].get(name, 0),
                "parallel demo256 space=2 bundle rank 0":
                    parallel_out["space_bundle_launches"].get(name, 0),
                "parallel demo64 DPS_y0 space=2 rank 0":
                    parallel_out["dps_launches"]["space"].get(name, 0)},
            **({} if part != "partial" else {"merge_launches_per_path": {
                "parallel demo256 sp=2 rank 0": parallel_out["sp_launches"].get(MERGE, 0),
                "parallel demo256 space=2 bundle rank 0":
                    parallel_out["space_bundle_launches"].get(MERGE, 0),
                "parallel demo64 DPS_y0 space=2 rank 0":
                    parallel_out["dps_launches"]["space"].get(MERGE, 0)}}),
            "max_abs_err": max(r[part]["err"] for r in half.values()),
            "ms": tot["ms"], "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
            "bound_by": tot["bound_by"], "library_ms": tot["library_ms"],
            "dispatch_ms": tot["dispatch_ms"],
            "plain_dispatch_ms": tot["plain_dispatch_ms"],
            "library_dispatch_ms": tot["library_dispatch_ms"],
            "basis": "sum over the GroupNorm calls of one DEMO256 forward on one of "
                     "two space ranks (bf16, batch 4, 128 of 256 rows); library: "
                     + ("torch.var_mean over the groups" if part == "partial" else
                        "F.group_norm + FiLM + F.silu (statistics included)")})
    record["parallel"] = parallel_out["runs"]
    log("serve: " + json.dumps(serve_out))
    log("export: " + json.dumps(export_out))
    log("train: " + json.dumps(train_out))
    log(json.dumps(record))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        rc = run(sys.argv[1:])
    except BaseException:  # report any failure, then leave with a non-zero code
        traceback.print_exc()
        rc = 1
    sys.stdout.flush()
    sys.stderr.flush()
    # leave at once: no interpreter teardown after the last line
    os._exit(rc)
