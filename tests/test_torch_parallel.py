"""The port's device mesh on four gloo ranks on the CPU (one group for the
module, two threads a rank): restores under dp, dp x tp and dp x sp against
the unsharded port, the tp = 2 and sp = 2 UNet forwards against JAX's
unsharded forward, the sharded train step, and the JAX package's mesh dry
run.  The JAX package gets its mesh from 8 virtual devices
(``tests/conftest.py``); the port from ranks (``parallel.multihost.spawn``).

Bars.  The UNet forwards: 1e-5 from JAX, and 1e-6 of the output's largest
magnitude from the unsharded port (the reordered sums of the all-reduces,
the merged GroupNorm statistics and the halo convolutions cost a few ulps).
Restores: 5e-4 from the unsharded port.  The first step, at t = 999,
multiplies the UNet's rounding by sqrt(1/alphabar - 1) = 156, and on this
CPU the rounding of a batch of 4 already differs from that of a batch of 1
(dp alone, which shares nothing, lands 1e-4 - 2e-4 away); a fault in the
plumbing (rows, noise, gathers) moves values by far more."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffpir_tpu.models import zoo as jzoo
from diffpir_tpu.models.unet import UNet as JUNet
from diffpir_tpu_torch.models import zoo as tzoo
from diffpir_tpu_torch.parallel.multihost import spawn
from diffpir_tpu_torch.train.loop import dryrun_train_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY32 = os.path.join(ROOT, "assets", "demo", "tiny_demo32.flax.npz")
RESTORE_ATOL = 5e-4


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """One 4-rank group runs every case of the module (tests/test_torch_parallel_ranks.py)."""
    work = tmp_path_factory.mktemp("mesh4")
    rng = np.random.default_rng(0)
    np.savez(work / "fwd.npz", x=rng.standard_normal((2, 32, 32, 3)).astype(np.float32),
             t=np.array([999, 10], np.int64))
    res = spawn("tests.test_torch_parallel_ranks:suite4", 4, [str(work)], timeout=600)
    return res, work


@pytest.mark.parametrize("task", ["inpaint", "deblur", "sr"])
@pytest.mark.parametrize("mesh", ["data", "dataxmodel", "dataxspace"])
def test_sharded_restore_matches_unsharded(group, task, mesh):
    res = group[0][0]
    assert res[f"{task} shape"] == [4, 64, 64, 3]
    assert res[f"{task} {mesh}"] <= RESTORE_ATOL, res


@pytest.fixture(scope="module")
def unsharded_forwards(group):
    """The JAX package's (compiled once) and the port's unsharded forwards
    of the tiny_demo32 prior on the group's inputs."""
    with np.load(group[1] / "fwd.npz") as z:
        x, t = z["x"], z["t"]
    flat = tzoo.load_params_npz(TINY32)
    jmodel = JUNet(jzoo.TINY_TEST_CONFIG, dtype=jnp.float32)
    params = jzoo._unflatten({k: jnp.asarray(v) for k, v in flat.items()})
    ref = np.asarray(jax.jit(lambda p, x, t: jmodel.apply({"params": p}, x, t))(
        params, jnp.asarray(x), jnp.asarray(t, jnp.int32)))
    from diffpir_tpu_torch.models.unet import UNet

    model = UNet(tzoo.TINY_TEST_CONFIG)
    model.load_state_dict(tzoo.flax_to_torch(flat))
    with torch.no_grad():
        own = model.eval()(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    return ref, own


@pytest.mark.parametrize("axes", ["dataxmodel", "dataxspace"])
def test_sharded_forward_matches_jax_and_unsharded(group, unsharded_forwards, axes):
    """tp = 2 and sp = 2: the tiny UNet from the tiny_demo32 prior's JAX
    parameters, carried across, sharded on the ranks."""
    got = np.load(group[1] / f"fwd.npz.{axes}.npy")
    ref, own = unsharded_forwards
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, own, rtol=0, atol=1e-6 * np.abs(own).max())


def test_uneven_heights_under_space_raise(group):
    assert "must stay even" in group[0][0]["uneven"], group[0][0]["uneven"]


def test_dryrun_train_step_matches_one_rank(group):
    ref = dryrun_train_step(1)
    for res in group[0]:
        assert abs(res["train_loss"] - ref) <= 1e-5, (res["train_loss"], ref)


def test_train_step_slices_match_one_rank_update(group):
    """After one step (AdamW with weight decay and clipping, EMA, the
    loss-second-moment sampler), each rank's slices of the parameters,
    moments and EMA equal the one-rank update's, and the sharded state is
    really sharded."""
    for res in group[0]:
        s = res["slices"]
        assert s["max_diff"] <= 1e-5, s
        assert s["sliced"] > s["n"] // 2, s
        assert abs(s["loss"] - s["ref_loss"]) <= 1e-5, s
        assert abs(s["grad_norm"] - s["ref_grad_norm"]) <= 1e-5 * s["ref_grad_norm"], s
        assert s["sampler"] <= 1e-5, s


def test_dryrun_restore_ran(group):
    """``dryrun_restore(4, bundle=True)``: the JAX package's dry run, its
    mesh-bundle stage (a dp bundle saved, loaded and run on the group
    against the live runner at ``DRYRUN_ATOL``) included."""
    assert all(r["dryrun_restore"] == "ok" for r in group[0])
