"""Bundles of ``test_mode`` 1-4 (``inference.test_mode`` around every UNet
call of the step: pad to a modulo, the recursive split, the x8 ensemble and
both) against ``Runner.restore_batch``, for inpainting and deblurring, and
their step programs' operator counts: one node per kernel call of a
forward times the step's UNet calls.  At 32 px the split pads; the 96 px
case splits into four 64 px quadrants (x8 applies the same split to its
stacked variants).  Bit for bit on the CPU, as every
bundle (``tests/test_torch_export_modes.py``); two torch threads."""

import numpy as np
import pytest
import torch

from diffpir_tpu_torch.export import expected_report, load_bundle, program_report, save_bundle
from diffpir_tpu_torch.runner import Runner

from test_torch_export import B, _batch, _cfg

# (test_mode, task, observation size, UNet calls a step)
CASES = [(1, "inpaint", 32, 1), (1, "deblur", 32, 1), (2, "inpaint", 96, 4),
         (2, "deblur", 32, 1), (3, "inpaint", 32, 1), (3, "deblur", 32, 1),
         (4, "inpaint", 32, 1), (4, "deblur", 32, 1)]


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=CASES,
                ids=[f"mode{m}-{task}-{h}px" for m, task, h, _ in CASES])
def case(request, tmp_path_factory):
    mode, task, h, calls = request.param
    runner = Runner(_cfg(task, test_mode=mode, iter_num=2 if h > 32 else 3), device="cpu")
    batch = _batch(task, np.random.default_rng(mode), h=h)
    path = save_bundle(runner, str(tmp_path_factory.mktemp(f"tm{mode}{task}") / "b"),
                       batch=B, height=h, width=h, kernel_hw=tuple(batch.kernel.shape[1:]),
                       platforms=("cpu",), allow_random_weights=True)
    return runner, batch, load_bundle(path, device="cpu"), calls


def test_test_mode_bundle_equals_runner(case):
    runner, batch, loaded, _ = case
    want = runner.restore_batch(batch, seed=5)
    got = loaded(batch.img_L, kernel=batch.kernel, mask=batch.mask, seed=5)
    assert got.shape == want.shape == batch.img_H.shape
    np.testing.assert_array_equal(got, want)


def test_test_mode_step_counts_every_forward(case):
    runner, _, loaded, calls = case
    rep = program_report(loaded.programs["step"])
    assert loaded.manifest["test_mode"] == runner.cfg.test_mode
    assert (rep["groupnorm_silu"], rep["legacy_qkv_attention"]) == (45 * calls, 4 * calls)
    assert rep["plain_nodes"] == 0
    assert all(rep[k] == v for k, v in expected_report(runner, calls).items())
