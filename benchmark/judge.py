"""Whether what the timed path produced is correct.

After the window has closed and the program's state is freed, a sample of
the finished requests, drawn from the seed, is restored again by the plain
reference (``reference/``: float32 UNet with TF32 off, float64 trajectory)
from the same inputs and noise draws, and compared with the program's
outputs:

* ``rmse_worst``: over the sampled images, the largest root-mean-square
  difference between the program's restored image and the reference's, in
  [0, 1] units;
* ``nonfinite``: images of the window (every one of them) with a value that
  is not finite; limit 0.

The sample takes ``sample.requests`` of the window's finished requests: the
first, the last (in the offline cells the batch dispatched while the one
before it was still on the card) and the rest drawn from the seed among
those between; in each, one row from each of ``sample.rows`` equal blocks
of the batch.  The reference restores the whole sample as one batch.  The
limits are in ``limits/<cell>.json``.
"""

from __future__ import annotations

import random

import numpy as np
import torch

from benchmark import traffic as gen
from benchmark.reference import diffpir
from benchmark.reference.unet import GuidedUNet, Precision
from benchmark.weights import key_seed, state_dict

__all__ = ["draw_sample", "reference_outputs", "in_batches", "compare", "verdict",
           "Reference"]


def draw_sample(traffic: dict, seed: int, finished: list[int]) -> list[tuple[int, list[int]]]:
    """[(request, rows)] from the seed: of the ``finished`` requests the first,
    the last and ``sample.requests`` - 2 drawn between them; one row from
    each of ``sample.rows`` blocks of each."""
    spec = traffic["sample"]
    rng = random.Random(key_seed(seed, "sample"))
    order = sorted(finished)
    if len(order) <= spec["requests"]:
        chosen = order
    else:
        middle = rng.sample(order[1:-1], spec["requests"] - 2)
        chosen = [order[0]] + sorted(middle) + [order[-1]]
    block = traffic["batch"] // spec["rows"]
    return [(r, [s * block + rng.randrange(block) for s in range(spec["rows"])])
            for r in chosen]


class Reference:
    """The reference model of a configuration for one seed, in ``precision``
    ("fp32" or, for the control, "fp8"), on ``device``."""

    def __init__(self, config: dict, seed: int, device, precision: str = "fp32"):
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        with torch.device("meta"):
            self.unet = GuidedUNet(config, Precision(precision))
        self.unet.load_state_dict(state_dict(config, seed, device), assign=True)
        self.unet.eval()
        self.device = torch.device(device)

    def restore(self, traffic: dict, seed: int, sample) -> dict:
        """The reference's restore of every sampled row, as one batch;
        {request: (n, H, W, C)}."""
        reqs, idx = [], []
        for r, rows in sample:
            reqs.append(gen.make_request(traffic, seed, r, self.device))
            idx.append(torch.tensor(rows, device=self.device))

        def rows_of(key):
            return torch.cat([q[key][i] for q, i in zip(reqs, idx)])

        def noise(i, which, shape):
            full = (traffic["batch"],) + tuple(shape[1:])
            return torch.cat([q["noise"](i, 0, which, full)[j] for q, j in zip(reqs, idx)])

        # without cuDNN: its fp32 algorithm for the ffhq model's 3x3
        # convolutions of 256 or 384 channels at 128 px is an FFT with one
        # complex GEMM a frequency, 240 ms a b6 call; PyTorch's own
        # convolution (cuBLAS products) runs the whole forward in 0.1 s
        cudnn = torch.backends.cudnn.enabled
        torch.backends.cudnn.enabled = False
        try:
            with torch.no_grad():
                out = diffpir.restore(self.unet, traffic, rows_of("y"), rows_of("mask"),
                                      rows_of("kernel"), noise).cpu().numpy()
        finally:
            torch.backends.cudnn.enabled = cudnn
        split = np.cumsum([len(rows) for _, rows in sample])[:-1]
        return {r: part for (r, _), part in zip(sample, np.split(out, split))}


def reference_outputs(ref: Reference, traffic: dict, seed: int, sample) -> dict:
    return ref.restore(traffic, seed, sample)


def in_batches(partial: dict, sample, batch: int) -> dict:
    """``reference_outputs``' sampled rows placed in whole float32 batches
    (the other rows zero), as the program's outputs are held."""
    out = {}
    for r, rows in sample:
        full = np.zeros((batch,) + partial[r].shape[1:], np.float32)
        full[rows] = partial[r]
        out[r] = full
    return out


def compare(outputs: dict, sample, expected: dict) -> dict:
    """The numbers compared: ``rmse_worst`` over the sample and
    ``nonfinite`` over every output."""
    worst = 0.0
    for r, rows in sample:
        got = outputs[r][rows].astype(np.float64)
        diff = got - expected[r]
        rmse = np.sqrt((diff ** 2).reshape(len(rows), -1).mean(axis=1))
        worst = max(worst, float(np.nan_to_num(rmse, nan=np.inf).max()))
    nonfinite = sum(int((~np.isfinite(o)).reshape(o.shape[0], -1).any(axis=1).sum())
                    for o in outputs.values())
    return {"rmse_worst": worst, "nonfinite": float(nonfinite)}


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): each number at most its limit."""
    shown = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    ok = all(np.isfinite(v["value"]) and v["value"] <= v["limit"] for v in shown.values())
    return ok, shown
