"""The port's tensor-parallel specs and mesh plumbing against the JAX
package (``parallel/tp.py``, ``Runner(mesh_shape=, mesh_axes=)``,
``Runner.lower_restore``), and one 8-rank gloo group on the CPU (two
threads a rank) for the dp x tp x sp inpaint and a dp x tp Runner restore
held against the JAX Runner's on the 8 virtual devices."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffpir_tpu import config as jconfig
from diffpir_tpu import data as jdata
from diffpir_tpu import runner as jrunner
from diffpir_tpu.models.unet import MODEL_ZOO_CONFIGS as J_ZOO
from diffpir_tpu.models.unet import UNet as JUNet
from diffpir_tpu.models.zoo import TINY_TEST_CONFIG as J_TINY
from diffpir_tpu.parallel import tp as jtp
from diffpir_tpu_torch.config import load_config
from diffpir_tpu_torch.models.unet import UNet
from diffpir_tpu_torch.models.zoo import MODEL_ZOO_CONFIGS, TINY_TEST_CONFIG, init_random_
from diffpir_tpu_torch.parallel import tp
from diffpir_tpu_torch.parallel.mesh import abstract_mesh, make_mesh
from diffpir_tpu_torch.parallel.multihost import spawn
from diffpir_tpu_torch.runner import Runner
from tests.test_torch_sampler import jax_noise

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEBLUR = os.path.join(ROOT, "configs", "demo64_deblur.yaml")
CASES = [("tiny", J_TINY, TINY_TEST_CONFIG, 64)] + [
    (name, J_ZOO[name], MODEL_ZOO_CONFIGS[name], 256) for name in sorted(J_ZOO)]


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _jax_shapes(jcfg, size):
    model = JUNet(jcfg, dtype=jnp.float32)
    return jax.eval_shape(lambda r: model.init(r, jnp.zeros((1, size, size, 3)),
                                               jnp.zeros((1,), jnp.int32)),
                          jax.random.PRNGKey(0))["params"]


def _port_state(cfg):
    with torch.device("meta"):
        return UNet(cfg).state_dict()


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


_LEAF = {"kernel": "weight", "scale": "weight", "embedding": "weight", "bias": "bias"}


def _as_port(path, spec, ndim):
    """A JAX leaf's PartitionSpec in the port's layout (conv HWIO -> OIHW,
    dense (in, out) -> (out, in)); P() stays ()."""
    s = tuple(spec)
    if s:
        s = s + (None,) * (ndim - len(s))
        if path[-1] == "kernel" and ndim == 4:
            s = (s[3], s[2], s[0], s[1])
        elif path[-1] == "kernel" and ndim == 2:
            s = (s[1], s[0])
    return path[:-1] + (_LEAF[path[-1]],), s


@pytest.fixture(scope="module")
def shapes():
    return {name: (_jax_shapes(jcfg, size), _port_state(cfg))
            for name, jcfg, cfg, size in CASES}


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_specs_and_report_equal_jax(shapes, name, n):
    """Leaf for leaf the same Megatron layout as the JAX package's specs,
    and the same parameter counts."""
    jcfg, cfg = {c[0]: c[1:3] for c in CASES}[name]
    jparams, state = shapes[name]
    jspecs = dict(_leaves(jtp.unet_tp_specs(jparams, jcfg, n)))
    want = dict(_as_port(p, jspecs[p], len(leaf.shape)) for p, leaf in _leaves(jparams))
    got = dict(_leaves(tp.unet_tp_specs(state, cfg, n)))
    assert got == want
    assert tp.tp_param_report(state, cfg, n) == jtp.tp_param_report(jparams, jcfg, n)


def test_fallback_replicates_on_indivisible(shapes):
    """The tiny config's 4 heads do not split 8 ways: its attention blocks
    replicate, as tests/test_tp.py holds the JAX package's."""
    specs = tp.unet_tp_specs(shapes["tiny"][1], TINY_TEST_CONFIG, 8)
    attn = [v for v in specs.values() if "qkv" in v]
    assert attn
    for s in attn:
        assert s["qkv"]["weight"] == () and s["proj"]["weight"] == ()


def test_shard_unet_params_slices_and_keeps_names():
    mesh = abstract_mesh((2, 4), ("data", "model"), coords={"data": 1, "model": 3})
    with torch.device("meta"):
        full = UNet(TINY_TEST_CONFIG)
        model = tp.shard_unet_params(UNet(TINY_TEST_CONFIG), mesh)
    assert set(model.state_dict()) == set(full.state_dict())
    blk = model.input_blocks_1_0
    assert blk.conv1.weight.shape[0] == full.input_blocks_1_0.conv1.weight.shape[0] // 4
    assert blk.conv2.weight.shape[1] == full.input_blocks_1_0.conv2.weight.shape[1] // 4
    assert blk.emb_proj.weight.shape[1] == full.input_blocks_1_0.emb_proj.weight.shape[1] // 4
    assert blk.norm2.num_groups == 8 and blk.tp is not None
    assert model.middle_block_1.qkv.weight.shape[0] == 3 * 64 // 4  # 64 channels, 4 heads


def test_shard_takes_this_ranks_slices():
    """Rank (data 0, model 1) of 2: conv1's second half of Cout, emb_proj's
    second half of its input, conv2's second half of Cin."""
    # seeded weights: a UNet's conv weights start uninitialised, and memory
    # that holds a NaN pattern would fail torch.equal on equal bits
    full = init_random_(UNet(TINY_TEST_CONFIG), 0)
    sd = {k: v.clone() for k, v in full.state_dict().items()}
    model = UNet(TINY_TEST_CONFIG)
    model.load_state_dict(sd)
    tp.shard_unet_params(model, abstract_mesh((1, 2), ("data", "model"),
                                              coords={"data": 0, "model": 1}))
    c = sd["input_blocks_1_0.conv1.weight"].shape[0] // 2
    e = sd["input_blocks_1_0.emb_proj.weight"].shape[1] // 2
    assert torch.equal(model.input_blocks_1_0.conv1.weight, sd["input_blocks_1_0.conv1.weight"][c:])
    assert torch.equal(model.input_blocks_1_0.emb_proj.weight,
                       sd["input_blocks_1_0.emb_proj.weight"][:, e:])
    assert torch.equal(model.input_blocks_1_0.conv2.weight,
                       sd["input_blocks_1_0.conv2.weight"][:, c:])
    assert torch.equal(model.input_blocks_1_0.conv2.bias, sd["input_blocks_1_0.conv2.bias"])


def test_flagship_553m_lower_restore_under_2x4():
    """The 553M 256x256_diffusion_uncond restore traced on the meta device
    under dp x tp = 2 x 4, as rank 0: nothing is allocated; over 90 % of
    the parameters are sharded, so a rank holds about a quarter of them; each
    NFE all-reduces over model, and the restored batch is gathered over
    data."""
    cfg = load_config(None, overrides=dict(
        task="deblur", model_name="256x256_diffusion_uncond", iter_num=2, iter_num_U=1,
        batch_size=8, noise_level_img=0.05, seed=0, dtype="bfloat16", save_E=False,
        save_L=False, mesh_shape=(2, 4)))
    runner = Runner(cfg, abstract_params=True)
    assert runner.weights_provenance == "abstract"
    assert runner.mesh.shape == {"data": 2, "model": 4} and runner.mesh.abstract
    rep = tp.tp_param_report(_port_state(MODEL_ZOO_CONFIGS["256x256_diffusion_uncond"]),
                             MODEL_ZOO_CONFIGS["256x256_diffusion_uncond"], 4)
    assert rep["total"] > 500e6 and rep["fraction"] > 0.9
    rec = runner.lower_restore(batch=8, height=256, width=256, kernel_hw=(25, 25))
    full_bytes = rep["total"] * 2
    assert full_bytes / 4 < rec["param_bytes"] < full_bytes / 3
    # one UNet forward a step but the last (its result is never used)
    assert rec["nfe"] == runner._plan(cfg.lambda_).n_steps - 1 >= 1
    per = {(c["op"], c["axis"]): c for c in rec["collectives_per_nfe"]}
    # conv2 and emb_proj of each sharded ResBlock, proj of each attention block
    assert per[("all_reduce", "model")]["count"] > 60
    assert set(per) == {("all_reduce", "model")}
    out = {(c["op"], c["axis"]): c for c in rec["collectives_outside_unet"]}
    assert out[("all_gather", "data")]["bytes"] == 4 * 256 * 256 * 3 * 4
    assert min(rec["activation_peak_bytes"]) == 0 and len(rec["activation_peak_bytes"]) == 6
    with pytest.raises(RuntimeError, match="abstract"):
        runner.restore_batch(jdata.Batch(
            img_H=np.zeros((8, 256, 256, 3), np.uint8),
            img_L=np.zeros((8, 256, 256, 3), np.float32),
            kernel=np.ones((8, 1, 1), np.float32), mask=np.ones((8, 256, 256, 3), np.float32),
            names=[str(i) for i in range(8)]))


def test_space_lowering_records_halos_and_merged_statistics():
    cfg = load_config(None, overrides=dict(
        task="inpaint", model_name="tiny_test", iter_num=2, batch_size=2, dtype="float32",
        save_E=False, save_L=False, mesh_shape=(2, 4), mesh_axes=("data", "space")))
    rec = Runner(cfg, abstract_params=True).lower_restore(2, 64, 64)
    per = {(c["op"], c["axis"]) for c in rec["collectives_per_nfe"]}
    assert per == {("all_gather", "space")}
    # 16 rows a rank at 64 px: 4 levels of 16, 8, 4 and 2 rows
    assert sorted(rec["activation_peak_bytes"]) == [0, 1, 2, 3]


def test_mesh_axes_validation():
    """As tests/test_sp.py:116-125 holds the JAX package's config."""
    with pytest.raises(ValueError, match="mesh_axes entries"):
        load_config(None, overrides=dict(mesh_shape=(2, 4), mesh_axes=("data", "pipeline")))
    with pytest.raises(ValueError, match="must match mesh_shape"):
        load_config(None, overrides=dict(mesh_shape=(2, 4), mesh_axes=("data",)))
    with pytest.raises(ValueError, match="unique"):
        load_config(None, overrides=dict(mesh_shape=(2, 4), mesh_axes=("space", "space")))


def test_no_group_means_no_mesh():
    """One process: make_mesh refuses a shape that needs more ranks, and a
    Runner asked for a mesh runs without one, as JAX on one device."""
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        make_mesh((2,))
    assert make_mesh().shape == {"data": 1}
    cfg = load_config(None, overrides=dict(
        task="inpaint", model_name="tiny_test", dtype="float32", mesh_shape=(2, 2),
        save_E=False, save_L=False))
    assert Runner(cfg, device="cpu", use_mesh=True).mesh is None


@pytest.fixture(scope="module")
def group8(tmp_path_factory):
    """The 8-rank group, fed the JAX package's draws for a deblur restore."""
    work = tmp_path_factory.mktemp("mesh8")
    over = dict(cwd=ROOT, save_E=False, save_L=False, model_name="tiny_demo32",
                testset_name="demo32", iter_num=4, ty_init=True)
    jcfg = jconfig.load_config(DEBLUR, over)
    np.random.seed(jcfg.seed)
    batch = jdata.make_batches(jdata.prepare_images(jcfg), 2)[0]
    seed = 3
    k_init, k_samp = jax.random.split(jax.random.PRNGKey(seed))
    steps = jax_noise(k_samp)
    shape = batch.img_H.shape
    draws = {"init": np.array(jax.random.normal(k_init, shape, jnp.float32))}
    for i in range(over["iter_num"] + 1):
        for which in ("n1", "n2"):
            draws[f"{which}_{i}_0"] = steps(i, 0, which, shape).numpy()
    np.savez(work / "jax_deblur.npz", config=DEBLUR, iter_num=over["iter_num"],
             img_L=batch.img_L, mask=batch.mask, kernel=batch.kernel, **draws)
    res = spawn("tests.test_torch_parallel_ranks:suite8", 8, [str(work)], timeout=600)
    jcfg_mesh = jconfig.load_config(DEBLUR, dict(over, mesh_shape=(2, 4),
                                                 mesh_axes=("data", "model")))
    ref = jrunner.Runner(jcfg_mesh, use_mesh=True).restore_batch(batch, seed=seed)
    return res, np.load(work / "port_deblur.npy"), ref


def test_dp_tp_sp_inpaint_matches_unsharded(group8):
    assert group8[0][0]["dp x tp x sp"] <= 5e-4, group8[0][0]


def test_dp_tp_deblur_matches_jax_runner_on_its_mesh(group8):
    """The port's dp x tp (2 x 4) restore against the JAX Runner's on the
    same mesh of virtual devices, both fed the JAX draws, within the bar
    tests/test_torch_tasks.py holds the two packages to."""
    _, got, ref = group8
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)
