"""Gradients through the port's sharded paths on two gloo ranks on the CPU
(one group for the module, two threads a rank; what the ranks run is
``tests/test_torch_parallel_ranks.py::grad_suite2``).

The convention (``parallel/collectives.py``): a replicated tensor carries
its whole gradient on every rank, a rank's block its block's.  So the
gradient of a scalar that every rank computes alike equals the unsharded
gradient: through each collective alone (all_reduce_sum with axis_block,
all_gather, grad_all_reduce, the halo rows of a 3x3 convolution) and
through the tiny UNet under model = 2 and under space = 2, fp32 at 1e-5.
DPS_y0, which differentiates through the UNet at every step, restores
under both axes within 5e-4 of the unsharded restore
(``runner.DRYRUN_ATOL``: the first step multiplies the UNet's rounding by
156), and so does its bundle over the space axis, whose step program holds
one backward node per kernel node."""

import pytest

from diffpir_tpu_torch.parallel.multihost import spawn
from diffpir_tpu_torch.runner import DRYRUN_ATOL

GRAD_ATOL = 1e-5


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    work = tmp_path_factory.mktemp("mesh_grad2")
    return spawn("tests.test_torch_parallel_ranks:grad_suite2", 2, [str(work)],
                 timeout=600)


@pytest.mark.parametrize("name", ["axis_block+all_reduce_sum", "all_gather",
                                  "grad_all_reduce", "halo_rows"])
def test_collective_gradient_equals_unsharded(group, name):
    for rank in group:
        assert rank["collectives"][name] <= GRAD_ATOL, rank["collectives"]


@pytest.mark.parametrize("axis", ["model", "space"])
def test_unet_gradient_equals_unsharded(group, axis):
    for rank in group:
        assert rank["unet"]["scale"] > 1e-3          # a gradient worth comparing
        assert rank["unet"][axis] <= GRAD_ATOL, rank["unet"]


@pytest.mark.parametrize("axis", ["model", "space"])
def test_dps_y0_restore_under_axis_matches_unsharded(group, axis):
    res = group[0]
    assert res["dps deblur shape"] == [2, 32, 32, 3]
    assert res[f"dps deblur {axis}"] <= DRYRUN_ATOL, res


def test_dps_y0_space_bundle_matches_unsharded(group):
    res = group[0]
    assert res["dps bundle space"] <= DRYRUN_ATOL, res
    rep = res["dps bundle space report"]
    for op in ("groupnorm_partial_stats", "groupnorm_apply_stats", "groupnorm_merge_stats"):
        assert rep[op] == rep[op + "_backward"] == 45, rep
    assert rep["legacy_qkv_attention"] == rep["legacy_qkv_attention_backward"] == 4
    assert rep["groupnorm_silu"] == 0 and rep["plain_nodes"] == 0
    assert rep["collectives"] > 0
