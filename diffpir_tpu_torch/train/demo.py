"""Train a demo diffusion prior on a synthetic dataset and save its EMA.

The port's counterpart of ``scripts/train_demo.py``, with the same flags and
architectures:

    python -m diffpir_tpu_torch.train.demo [--steps 4000] [--cpu] [--arch hq256]

It writes ``--out`` as a ``.flax.npz`` in the JAX package's layout (the EMA
parameters, through ``zoo.torch_to_flax``), which either package's zoo loads.
The images come from ``synth_batch``, a copy of the script's that draws the
same images bit for bit from the same generator; ``Trainer.fit(pool=...)``
keeps them on the device and ships only gather indices per dispatch.  On the
card the model computes in bf16 with fp32 master weights; ``--cpu`` runs on
the CPU in fp32, as the script does.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

T = 1000


def synth_batch(rng: np.random.Generator, n: int, IMG: int = 64,
                rich: bool = False) -> np.ndarray:
    """Random structured images in [-1, 1], (n, IMG, IMG, 3).

    rich=False is the demo32/demo64 distribution; rich=True (the 256-px demo
    prior's) adds a sinusoidal texture on the background, more shapes and
    thin anti-aliased lines.  The draws, their order and the arithmetic are
    those of ``scripts/train_demo.py``, so the same generator gives the same
    images.
    """
    yy, xx = np.mgrid[0:IMG, 0:IMG].astype(np.float32) / IMG
    out = np.empty((n, IMG, IMG, 3), np.float32)
    for i in range(n):
        # gradient background
        g0, g1 = rng.random(3), rng.random(3)
        ang = rng.random()
        tcoord = ang * xx + (1 - ang) * yy
        img = g0[None, None] * (1 - tcoord[..., None]) + g1[None, None] * tcoord[..., None]
        if rich and rng.random() < 0.7:
            # low-amplitude sinusoidal texture (random orientation/frequency)
            fy, fx = rng.random(2) * 24.0 + 4.0
            phase = rng.random() * 6.283
            amp = rng.random() * 0.12 + 0.03
            tex = np.sin(6.283 * (fy * yy + fx * xx) + phase) * amp
            img = img + tex[..., None] * rng.random(3)[None, None]
        # soft shapes (1-3 classic; 2-5 rich)
        n_shapes = rng.integers(2, 6) if rich else rng.integers(1, 4)
        for _ in range(n_shapes):
            cy, cx = rng.random(2) * 0.8 + 0.1
            ry, rx = rng.random(2) * 0.25 + 0.08
            col = rng.random(3)
            if rng.random() < 0.5:
                d = np.maximum(np.abs(yy - cy) / ry, np.abs(xx - cx) / rx)
            else:
                d = np.sqrt(((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2)
            alpha = np.clip(1.0 - (d - 0.9) / 0.2, 0.0, 1.0)[..., None]
            img = img * (1 - alpha) + col[None, None] * alpha
        if rich:
            # thin lines: sharp high-frequency structure deblurring must resolve
            for _ in range(rng.integers(1, 4)):
                p0 = rng.random(2)
                theta = rng.random() * 6.283
                nvec = np.array([np.cos(theta), np.sin(theta)], np.float32)
                dist = np.abs((yy - p0[0]) * nvec[0] + (xx - p0[1]) * nvec[1])
                width = (rng.random() * 1.5 + 0.75) / IMG
                alpha = np.clip(1.0 - dist / width, 0.0, 1.0)[..., None]
                img = img * (1 - alpha) + rng.random(3)[None, None] * alpha
        out[i] = np.clip(img, 0.0, 1.0) * 2.0 - 1.0
    return out


ARCHS = {"tiny": "TINY_TEST_CONFIG", "hq": "DEMO_HQ_CONFIG",
         "hq256": "DEMO256_CONFIG"}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=4000)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU in fp32 (default: the CUDA card, bf16)")
    ap.add_argument("--out", type=str, default="assets/demo/tiny_demo.flax.npz")
    ap.add_argument("--image-size", type=int, default=64)
    ap.add_argument("--dataset-size", type=int, default=2000,
                    help="pregenerate a fixed pool of N images, kept on the "
                         "device by Trainer.fit(pool=...)")
    ap.add_argument("--arch", choices=sorted(ARCHS), default="tiny",
                    help="tiny = 6M TINY_TEST_CONFIG, hq = 29M DEMO_HQ_CONFIG,"
                         " hq256 = 54M flagship-topology DEMO256_CONFIG")
    ap.add_argument("--rich", action="store_true",
                    help="rich texture distribution (default for hq256)")
    ap.add_argument("--steps-per-call", type=int, default=1,
                    help="K train steps per dispatch")
    ap.add_argument("--save-interval", type=int, default=2000)
    ap.add_argument("--resume", type=str, default=None, metavar="NPZ",
                    help="warm-start params (and EMA) from a saved .flax.npz of "
                         "the same arch, with a fresh optimizer (the npz stores "
                         "EMA params only)")
    ap.add_argument("--pool-seed", type=int, default=0,
                    help="RNG seed of the pregenerated pool (continuation runs "
                         "should pick a fresh seed so they see new draws)")
    args = ap.parse_args(argv)

    import torch

    from diffpir_tpu_torch import resolve_device
    from diffpir_tpu_torch.diffusion import Diffusion, ModelMeanType, ModelVarType
    from diffpir_tpu_torch.models import zoo
    from diffpir_tpu_torch.models.unet import UNet
    from diffpir_tpu_torch.schedule import NoiseSchedule
    from diffpir_tpu_torch.train.loop import TrainConfig, Trainer

    dev = resolve_device(args.cpu)
    arch = getattr(zoo, ARCHS[args.arch])
    IMG = arch.image_size if args.arch == "hq256" else args.image_size
    rich = args.rich or args.arch == "hq256"
    dtype = torch.float32 if args.cpu else torch.bfloat16
    model = UNet(arch, dtype=dtype, param_dtype=torch.float32).to(dev)
    diff = Diffusion(NoiseSchedule.linear(0.0001, 0.02, T), ModelMeanType.EPSILON,
                     ModelVarType.LEARNED_RANGE)
    tcfg = TrainConfig(lr=args.lr, ema_rates=(0.999,),
                       compute_dtype="float32" if args.cpu else "bfloat16")
    trainer = Trainer(model, diff, tcfg)
    if args.resume:
        model.load_state_dict(zoo.flax_to_torch(zoo.load_params_npz(args.resume)))
        state = trainer.init_state(seed=None)
        print(f"resumed params from {args.resume}", flush=True)
    else:
        state = trainer.init_state(seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"arch {args.arch}: {n_params/1e6:.1f}M params, {IMG}px, rich={rich}, "
          f"device {dev}", flush=True)

    rng = np.random.default_rng(args.pool_seed)
    t0 = time.perf_counter()
    pool = synth_batch(rng, args.dataset_size, IMG, rich=rich)
    print(f"pregenerated {args.dataset_size} images "
          f"({time.perf_counter()-t0:.0f}s)", flush=True)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)

    def save_fn(s):
        names = [n for n, _ in model.named_parameters()]
        zoo.save_params_npz(zoo.torch_to_flax({n: s["ema"][0][n] for n in names}),
                            args.out)
        print(f"saved EMA params -> {args.out} (step {int(s['step'])}, "
              f"{(time.perf_counter()-t0)/max(int(s['step']),1)*1000:.0f} "
              f"ms/step incl. startup)", flush=True)

    t0 = time.perf_counter()
    trainer.fit(state, steps=args.steps, seed=1, pool=pool, batch_size=args.batch,
                steps_per_call=args.steps_per_call, save_fn=save_fn,
                save_interval=args.save_interval,
                log_interval=max(args.save_interval // 10, 1))


if __name__ == "__main__":
    main()
