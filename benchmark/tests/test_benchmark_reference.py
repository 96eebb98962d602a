"""The plain reference against the port's plain route, fp32, on the CPU at
the tiny configuration: the same seeded state dict, the same inputs and
noise draws."""

import numpy as np
import pytest
import torch

from benchmark import drive, judge
from benchmark.reference.unet import GuidedUNet
from benchmark.weights import state_dict

SEED = 2 ** 31 + 12345


def test_unet_forward_matches_the_ports_plain_route(data):
    from diffpir_tpu_torch.models.convert import convert_state_dict
    from diffpir_tpu_torch.models.unet import UNet
    from diffpir_tpu_torch.models.zoo import TINY_TEST_CONFIG

    cfg = data("tiny")
    sd = state_dict(cfg, SEED, "cpu")
    ref = GuidedUNet(cfg)
    ref.load_state_dict(sd)
    port = UNet(TINY_TEST_CONFIG, dtype=torch.float32, kernels="plain")
    port.load_state_dict(convert_state_dict(sd))
    g = torch.Generator().manual_seed(1)
    x = torch.randn((2, 64, 64, 3), generator=g)
    t = torch.tensor([999, 17])
    with torch.no_grad():
        want = ref(x.permute(0, 3, 1, 2), t).permute(0, 2, 3, 1)
        got = port(x, t.int())
    assert want.abs().max() > 0.1
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


# fp32 restores: the trajectories agree to rounding.  Deblurring's bar is
# wider: the port solves the FFT prox in complex64, and a Gaussian PSF's
# spectrum falls below float32's rounding at high frequencies, where at the
# first steps (tau ~ 1e-7) that rounding is divided by tau; the reference
# solves in complex128.
TOL = {"tiny_deblur": 1e-3, "tiny_sr": 1e-5, "tiny_inpaint": 1e-5}


@pytest.mark.parametrize("traffic", sorted(TOL))
def test_restore_matches_the_ports_plain_route(traffic, tiny_cell):
    cell = tiny_cell(traffic, dtype="float32")
    prog = drive.Program(cell.config, cell.traffic, SEED, "cpu")
    out = prog.fetch(prog.restore(prog.request(3)))
    sample = [(3, list(range(cell.traffic["batch"])))]
    ref = judge.Reference(cell.config, SEED, "cpu")
    expected = judge.reference_outputs(ref, cell.traffic, SEED, sample)
    assert np.ptp(expected[3]) > 0.1
    numbers = judge.compare({3: out}, sample, expected)
    assert numbers["nonfinite"] == 0
    assert numbers["rmse_worst"] <= TOL[traffic]
