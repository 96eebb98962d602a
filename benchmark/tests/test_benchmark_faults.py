"""A run with the timed path broken underneath has to come out not correct.

Each test drives ``benchmark.run.run`` on the CPU (the card checks are
``main``'s) at the tiny configuration, with one fault planted in the
program: a step that returns its state unchanged, half of each batch left
out (filled with the mean of the rest), every answer altered where it is
produced.  The cells run on one chip, so no exchange between chips can be
left out.  The unbroken run, and the fp8 control in the program's place,
are the two ends they are held between."""

import numpy as np
import pytest
import torch

from benchmark import judge
from benchmark import run as bench_run

SEED = 3_000_000_019
SECONDS = 0.5


def _run(cell):
    return bench_run.run(cell, SEED, SECONDS, False, "cpu")


@pytest.mark.parametrize("traffic", ["tiny_inpaint", "tiny_sr"])
def test_unbroken_run_is_correct(traffic, tiny_cell):
    res = _run(tiny_cell(traffic))
    assert res["correct"], res["compared"]
    assert list(res)[-1] == "compared"
    assert res["attempted"] >= tiny_cell(traffic).traffic["batch"]
    assert set(res["metrics"]) >= {"images_per_s", "setup_s"}


@pytest.mark.parametrize("traffic", ["tiny_inpaint", "tiny_sr"])
def test_step_returning_its_state_unchanged_is_caught(traffic, tiny_cell, monkeypatch):
    from diffpir_tpu_torch import sampler

    monkeypatch.setattr(sampler, "diffpir_step", lambda den, prox, x, *a, **k: x)
    res = _run(tiny_cell(traffic))
    assert not res["correct"], res["compared"]


@pytest.mark.parametrize("traffic", ["tiny_inpaint", "tiny_sr"])
def test_half_the_batch_left_out_is_caught(traffic, tiny_cell, monkeypatch):
    from diffpir_tpu_torch.runner import Runner

    restore = Runner.restore

    def half(self, y, mask, lambda_, zeta, seed, noise=None, kernel=None, init=None):
        b = y.shape[0] // 2
        out = restore(self, y[:b], mask[:b], lambda_, zeta, seed,
                      noise=lambda i, u, which, shape: noise(i, u, which, shape)[:b]
                      if shape[0] == 2 * b else noise(i, u, which, shape),
                      kernel=None if kernel is None else kernel[:b], init=init)
        return torch.cat([out, out.mean(dim=0, keepdim=True).expand_as(out)], dim=0)

    monkeypatch.setattr(Runner, "restore", half)
    res = _run(tiny_cell(traffic))
    assert not res["correct"], res["compared"]


@pytest.mark.parametrize("traffic", ["tiny_inpaint", "tiny_sr"])
def test_answers_altered_where_produced_are_caught(traffic, tiny_cell, monkeypatch):
    # the runner is imported before the sampler is patched: imported after,
    # it would bind the altered function, and keep it past this test
    import diffpir_tpu_torch.runner as runner_mod
    from diffpir_tpu_torch import sampler

    sample = sampler.diffpir_sample

    def altered(*a, **k):
        return sample(*a, **k) + 0.05

    monkeypatch.setattr(sampler, "diffpir_sample", altered)
    monkeypatch.setattr(runner_mod, "diffpir_sample", altered)
    res = _run(tiny_cell(traffic))
    assert not res["correct"], res["compared"]


@pytest.mark.parametrize("traffic", ["tiny_deblur", "tiny_inpaint", "tiny_sr"])
def test_fp8_control_is_not_correct(traffic, tiny_cell):
    """The reference computed in float8 e4m3, in the program's place, fails
    the limit that the bf16 program meets."""
    cell = tiny_cell(traffic)
    t = cell.traffic
    finished = list(range(3))
    sample = judge.draw_sample(t, SEED, finished)
    ref = judge.Reference(cell.config, SEED, "cpu")
    expected = judge.reference_outputs(ref, t, SEED, sample)
    ctl = judge.Reference(cell.config, SEED, "cpu", precision="fp8")
    got = judge.in_batches(judge.reference_outputs(ctl, t, SEED, sample), sample, t["batch"])
    correct, shown = judge.verdict(judge.compare(got, sample, expected),
                                   cell.limits["limits"])
    assert not correct, shown
    assert np.isfinite(shown["rmse_worst"]["value"])
