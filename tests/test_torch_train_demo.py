"""The port's demo trainer (``diffpir_tpu_torch.train.demo``) against
``scripts/train_demo.py``: ``synth_batch`` draws the same images bit for
bit, and a short run on the CPU writes an EMA ``.flax.npz`` that the JAX
package's zoo loads into an equal forward.

Run as a script, this file prints the JAX package's values that
``chip_smoke.py``'s phase ``train`` holds the port to, computed on the CPU
in fp32:

    python tests/test_torch_train_demo.py

* the first-step mean ``mse``, ``vb`` and ``loss`` of the DEMO256 recipe on
  its trained prior (``assets/demo/demo256.flax.npz``), for the batch, ``t``
  and noise that ``train_inputs`` makes (in chunks of two images: each
  image's terms depend on that image alone);
* the loss ratio (mean of the last 20 steps over the first 20) of
  ``scripts/train_demo.py --cpu --arch tiny --image-size 32 --steps 200
  --batch 64 --dataset-size 512`` (logged every step), for information: the
  two packages draw differently.
"""

import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# the smoke's DEMO256 step: pool size and seed, batch, and fit's first draw
# of indices (pool_seed 0, as scripts/train_demo.py leaves it)
POOL_SIZE, POOL_SEED, BATCH = 64, 7, 16
TINY_ARGS = ["--arch", "tiny", "--image-size", "32", "--steps", "200", "--batch",
             "64", "--dataset-size", "512", "--save-interval", "10"]



@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Parallel test workers each start one PyTorch thread per core, which
    oversubscribes the cores; two threads for this module."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)

def load_script():
    spec = importlib.util.spec_from_file_location(
        "train_demo_script", os.path.join(ROOT, "scripts", "train_demo.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def train_inputs(synth_batch):
    """(batch, t, noise) of the smoke's first DEMO256 step: the pool of
    POOL_SIZE rich 256-px images from ``default_rng(POOL_SEED)``, fit's
    first indices from ``default_rng(0)``, then t and the noise from
    another ``default_rng(0)``."""
    pool = synth_batch(np.random.default_rng(POOL_SEED), POOL_SIZE, 256, rich=True)
    idx = np.random.default_rng(0).integers(0, POOL_SIZE, (1, BATCH))[0]
    rng = np.random.default_rng(0)
    t = rng.integers(0, 1000, BATCH).astype(np.int32)
    noise = rng.standard_normal((BATCH, 256, 256, 3), dtype=np.float32)
    return pool[idx], t, noise


def loss_ratio(losses) -> float:
    return float(np.mean(losses[-20:]) / np.mean(losses[:20]))


def read_losses(csv_path: str) -> list[float]:
    import csv

    with open(csv_path) as f:
        rows = list(csv.DictReader(f))
    return [float(r["loss"]) for r in sorted(rows, key=lambda r: int(r["step"]))]


def _jax_reference() -> None:
    import glob
    import tempfile

    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from diffpir_tpu.diffusion import Diffusion, ModelMeanType, ModelVarType
    from diffpir_tpu.models import zoo
    from diffpir_tpu.models.unet import UNet
    from diffpir_tpu.schedule import NoiseSchedule

    script = load_script()
    batch, t, noise = train_inputs(script.synth_batch)
    model = UNet(zoo.DEMO256_CONFIG, dtype=jnp.float32)
    params = zoo.load_params_npz(os.path.join(ROOT, "assets", "demo", "demo256.flax.npz"))
    diff = Diffusion(NoiseSchedule.linear(1e-4, 0.02, 1000), ModelMeanType.EPSILON,
                     ModelVarType.LEARNED_RANGE)

    @jax.jit
    def terms(x0, tv, nz):
        fn = lambda x, tt: model.apply({"params": params}, x, tt)  # noqa: E731
        return diff.training_losses(fn, x0, tv, None, noise=nz)

    parts = [terms(batch[i:i + 2], t[i:i + 2], noise[i:i + 2])
             for i in range(0, BATCH, 2)]
    for k in ("mse", "vb", "loss"):
        v = np.concatenate([np.asarray(p[k]) for p in parts])
        print(f"JAX demo256 first step mean {k} = {float(v.mean())!r}", flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        env = dict(os.environ, DIFFPIR_LOG_FORMAT="csv", TMPDIR=tmp, HOME=tmp)
        subprocess.run([sys.executable, os.path.join(ROOT, "scripts", "train_demo.py"),
                        "--cpu", "--out", os.path.join(tmp, "tiny.flax.npz")] + TINY_ARGS,
                       env=env, check=True, cwd=ROOT)
        (csv_path,) = glob.glob(os.path.join(tmp, "diffpir-*", "progress.csv"))
        losses = read_losses(csv_path)
    print(f"JAX tiny from scratch: {len(losses)} steps, loss first 20 "
          f"{np.mean(losses[:20])!r}, last 20 {np.mean(losses[-20:])!r}, ratio "
          f"{loss_ratio(losses)!r}", flush=True)


@pytest.mark.parametrize("rich,img", [(False, 32), (True, 48)])
def test_synth_batch_matches_the_script(rich, img):
    from diffpir_tpu_torch.train.demo import synth_batch

    ref = load_script().synth_batch(np.random.default_rng(3), 5, img, rich=rich)
    got = synth_batch(np.random.default_rng(3), 5, img, rich=rich)
    assert got.dtype == ref.dtype and np.array_equal(got, ref)


def test_demo_cli_writes_an_npz_the_jax_zoo_loads(tmp_path):
    """Three steps at 16 px on the CPU; the EMA npz loads in the JAX zoo
    into the tree JAX's UNet declares and gives the forward the port's UNet
    gives with the same file (1e-4)."""
    import jax
    import jax.numpy as jnp

    from diffpir_tpu.models import zoo as jzoo
    from diffpir_tpu.models.unet import UNet as JUNet
    from diffpir_tpu_torch.models import zoo as tzoo
    from diffpir_tpu_torch.models.unet import UNet as TUNet
    from diffpir_tpu_torch.train import demo
    from diffpir_tpu_torch.utils import kvlogger

    out = str(tmp_path / "tiny.flax.npz")
    kvlogger.reset()
    kvlogger.configure(str(tmp_path / "log"), ["csv"])
    try:
        demo.main(["--cpu", "--arch", "tiny", "--image-size", "16", "--steps", "3",
                   "--batch", "4", "--dataset-size", "8", "--save-interval", "2",
                   "--out", out])
    finally:
        kvlogger.reset()
    params = jzoo.load_params_npz(out)
    jmodel = JUNet(jzoo.TINY_TEST_CONFIG, dtype=jnp.float32)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 16, 16, 3)), jnp.zeros((1,), jnp.int32))
    assert (jax.tree_util.tree_map(lambda a: (a.shape, a.dtype), shapes["params"])
            == jax.tree_util.tree_map(lambda a: (a.shape, a.dtype), params))
    x = np.random.default_rng(0).standard_normal((2, 16, 16, 3)).astype(np.float32)
    t = np.array([3, 700], np.int32)
    ref = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x), jnp.asarray(t)))
    tmodel = TUNet(tzoo.TINY_TEST_CONFIG)
    tmodel.load_state_dict(tzoo.flax_to_torch(tzoo.load_params_npz(out)))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)
    rows = read_losses(str(tmp_path / "log" / "progress.csv"))
    assert len(rows) == 3 and all(np.isfinite(rows))  # logged every step


if __name__ == "__main__":
    _jax_reference()
