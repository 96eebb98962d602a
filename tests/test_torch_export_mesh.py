"""Mesh bundles of the port on four gloo ranks on the CPU (one group for the
module, one thread a rank; what the ranks run is
``tests/test_torch_parallel_ranks.py::export_suite4``): a (4,) data bundle,
a (2, 2) data x model bundle (its programs hold the model axis's
collectives as operators), a dynamic-point (4,) data bundle, a (2, 2) data
x space bundle (the halves of the sharded GroupNorm, the halo rows and the
row blocks as operators) and a DPS_y0 deblur bundle over (2, 2) data x
model (its recorded gradient runs through the collectives), each loaded
and run on the group against the unsharded runner (the dry run's
mesh-bundle stage, ``dryrun_restore(4, bundle=True)``, runs in
``test_torch_parallel.py``'s group, which already ran the dry run).  Bar: 5e-4 (``runner.DRYRUN_ATOL``; see
``tests/test_torch_parallel.py``: on this CPU a batch of 4 already rounds
differently from a batch of 1, which the first step multiplies by 156)."""

import numpy as np
import pytest

from diffpir_tpu_torch.export import load_bundle, program_report
from diffpir_tpu_torch.parallel.multihost import spawn
from diffpir_tpu_torch.runner import DRYRUN_ATOL


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    work = tmp_path_factory.mktemp("export_mesh4")
    (res,) = spawn("tests.test_torch_parallel_ranks:export_suite4", 4, [str(work)],
                   threads=1, timeout=900)[:1]
    return res, work


@pytest.mark.parametrize("name", ["data", "dataxmodel", "data_dynamic", "dataxspace",
                                  "dps_dataxmodel"])
def test_mesh_bundle_matches_unsharded(group, name):
    res = group[0]
    assert res[f"{name} shape"] == [4, 32, 32, 3]
    assert res[name] <= DRYRUN_ATOL, res


def test_mesh_manifest_records_geometry_and_specs(group):
    res = group[0]
    assert res["data mesh"]["shape"] == [4] and res["data mesh"]["axis_names"] == ["data"]
    m = res["dataxmodel mesh"]
    assert m["shape"] == [2, 2] and m["axis_names"] == ["data", "model"]
    specs = m["param_specs"]
    assert any("model" in s for s in specs) and any(not any(s) for s in specs)
    assert all(not any(s) for s in res["data mesh"]["param_specs"])


def test_model_axis_program_holds_the_collectives(group):
    """The data x model bundle's step program: the kernels and the model
    axis's all-reduces and blocks as operators, no rank's index inside."""
    # loading the bundle needs the group: read its archive
    from torch.export.pt2_archive._package import load_pt2

    step = load_pt2(str(group[1] / "dataxmodel" / "program.pt2")).exported_programs["step"]
    rep = program_report(step)
    assert rep["groupnorm_silu"] == 45 and rep["legacy_qkv_attention"] == 4
    assert rep["plain_nodes"] == 0 and rep["collectives"] > 0


def test_space_and_dps_programs_hold_their_operators(group):
    """The space bundle's step: the GroupNorm halves and merge at every
    GroupNorm call, the collectives, no groupnorm_silu and no plain node;
    the DPS_y0 model-axis bundle's: one backward node per kernel node."""
    res = group[0]
    space = res["dataxspace report"]
    assert (space["groupnorm_partial_stats"] == space["groupnorm_apply_stats"]
            == space["groupnorm_merge_stats"] == 45)
    assert space["groupnorm_silu"] == 0 and space["legacy_qkv_attention"] == 4
    assert space["collectives"] > 0 and space["plain_nodes"] == 0
    assert res["dataxspace mesh"]["axis_names"] == ["data", "space"]
    dps = res["dps_dataxmodel report"]
    assert dps["groupnorm_silu"] == dps["groupnorm_silu_backward"] == 45
    assert dps["legacy_qkv_attention"] == dps["legacy_qkv_attention_backward"] == 4
    assert dps["plain_nodes"] == 0 and dps["collectives"] > 0


def test_mesh_bundle_refuses_a_smaller_group(group):
    with pytest.raises(RuntimeError, match="bundle was exported for a"):
        load_bundle(str(group[1] / "data"), device="cpu")
