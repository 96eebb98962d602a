"""Command-line entry point of the PyTorch port.

    python -m diffpir_tpu_torch.main --opt configs/demo64_deblur.yaml [--no-sweep] \
        [--set key=value ...] [--cpu] [--json]
    python -m diffpir_tpu_torch.main --opt configs/demo64_deblur.yaml \
        --tune 50,100,150:0.5 [--tune-index I] [--tune-images K]
    python -m diffpir_tpu_torch.main --opt ... --profile DIR

Runs the config's task (deblur, sr or inpaint) in its trajectory mode
(``generate_mode``, ``model_output_type``, ...) on the CUDA card unless
``--cpu`` is given, and refuses to start when there is no card and ``--cpu``
was not asked for.  Without ``--no-sweep`` it evaluates every (lambda, zeta)
of the reference's sweep (``runner.reference_sweep``).  ``--tune`` instead
scores a grid of operating points on test images, all candidates of an image
in one batch (``Runner.tune_operating_point``), and prints the table.
``--profile DIR`` runs the evaluation (or the grid) under ``torch.profiler``
(CPU and, on the card, CUDA activity) and writes a Chrome trace to
``DIR/trace.json``.  ``main(argv)`` can be called in-process and returns the
list of result dicts (with ``--tune``, the per-candidate rows).

On a device mesh, one process a rank:

    torchrun --nproc-per-node N -m diffpir_tpu_torch.main --opt ... \
        --set mesh_shape=[2,2] --set mesh_axes=[data,model]

joins the group ``torchrun`` describes (``parallel.multihost.initialize``:
NCCL when every rank has a card of its own, gloo when ranks share one), and
each rank runs on its card (``--cpu``: on the CPU, over gloo).  Rank 0 alone
prints and saves.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import sys


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--opt", type=str, required=True, help="Path to option YAML file.")
    p.add_argument("--no-sweep", action="store_true",
                   help="run only the configured (lambda, zeta), not the "
                        "reference's sweep (deblur: one point at (7 lambda, "
                        "3 zeta); sr: lambda times 2..12; inpaint: one point)")
    p.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                   help="config override (repeatable); VALUE is parsed as JSON "
                        "when it can be")
    p.add_argument("--cpu", action="store_true", help="run on the CPU")
    p.add_argument("--tune", type=str, default=None, metavar="L1,L2,...",
                   help="score this lambda grid on one test image, all "
                        "candidates in one batch (per-sample operating "
                        "points), and print the per-candidate table; entries "
                        "are 'lambda' or 'lambda:zeta'")
    p.add_argument("--tune-index", type=int, default=0, metavar="I",
                   help="test-set image index --tune runs on (default 0)")
    p.add_argument("--tune-images", type=int, default=1, metavar="K",
                   help="average the --tune grid over K consecutive test "
                        "images from --tune-index on (one batch each)")
    p.add_argument("--json", action="store_true", help="print results as JSON")
    p.add_argument("--profile", type=str, default=None, metavar="DIR",
                   help="write a torch.profiler Chrome trace of the run to "
                        "DIR/trace.json")
    return p.parse_args(argv)


def main(argv=None) -> list[dict]:
    args = parse_args(argv)
    from diffpir_tpu_torch import resolve_device
    from diffpir_tpu_torch.config import load_config, parse_overrides
    from diffpir_tpu_torch.parallel import multihost
    from diffpir_tpu_torch.runner import Runner

    device = resolve_device(args.cpu)
    multihost.initialize(backend="gloo" if args.cpu else None)
    rank, world = multihost.process_shard_info()
    if world > 1 and device.type == "cuda":
        device = multihost.rank_device()
    cfg = load_config(args.opt, parse_overrides(args.set))
    if rank:
        # rank 0 alone prints and saves; the others compute the same
        cfg.save_E = cfg.save_L = cfg.save_LEH = False
        sys.stdout = open(os.devnull, "w")

    if cfg.save_E or cfg.save_L:
        os.makedirs(cfg.E_path, exist_ok=True)
        shutil.copyfile(args.opt, os.path.join(cfg.E_path, "config.yaml"))

    runner = Runner(cfg, device=device)
    with profiled(args.profile, device):
        if args.tune:
            return tune(runner, args)
        results = [runner.evaluate()] if args.no_sweep else runner.evaluate_sweep()
    if len(results) > 1:
        best = max(results, key=lambda r: r["psnr"])
        print("sweep summary:")
        for r in results:
            mark = "  <-- best" if r is best else ""
            print(f"  lambda={r['lambda_']:g} zeta={r['zeta']:g}: "
                  f"{r['psnr']:.2f} dB"
                  + (f" / SSIM {r['ssim']:.4f}" if r.get("ssim") else "") + mark)
    if args.json:
        json.dump(results, sys.stdout, indent=2, default=float)
        print()
    return results


@contextlib.contextmanager
def profiled(out_dir, device):
    """``torch.profiler`` over the block when ``out_dir`` is given (CUDA
    activity too on the card), its Chrome trace written to
    ``out_dir/trace.json``."""
    if out_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(out_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))


def tune(runner, args: argparse.Namespace) -> list[dict]:
    """``--tune``: the grid's table and best row, printed as
    ``main_ddpir.py:85-108`` prints them."""
    cfg = runner.cfg
    pts = []
    for tok in args.tune.split(","):
        lam, _, zet = tok.partition(":")
        pts.append((float(lam), float(zet) if zet else None))
    res = runner.tune_operating_point(
        pts, index=args.tune_index,
        indices=(range(args.tune_index, args.tune_index + args.tune_images)
                 if args.tune_images > 1 else None))
    print(f"{'lambda':>8} {'zeta':>6} {'PSNR':>8}" + ("    SSIM" if cfg.calc_SSIM else ""))
    for row in res["results"]:
        print(f"{row['lambda_']:>8.3f} {row['zeta']:>6.2f} {row['psnr']:>8.3f}"
              + (f"  {row['ssim']:.4f}" if "ssim" in row else ""))
    best = res["best"]
    print(f"best: lambda={best['lambda_']:g} zeta={best['zeta']:g} "
          f"({best['psnr']:.3f} dB) — {len(pts)} candidates, "
          f"{args.tune_images} batch(es)")
    if args.json:
        json.dump(res["results"], sys.stdout, indent=2, default=float)
        print()
    return res["results"]


if __name__ == "__main__":
    main()
