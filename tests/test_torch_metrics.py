"""The port's LPIPS (``diffpir_tpu_torch/metrics.py``) against the JAX
package's (``diffpir_tpu/metrics.py``) on the same seeded random VGG16 and
``lin`` weights, and ``Runner.evaluate`` with ``calc_LPIPS`` and
``calc_FID`` against the JAX Runner's on the same restored batch."""

import os

import numpy as np
import pytest
import torch

from diffpir_tpu import config as jconfig
from diffpir_tpu import metrics as jmetrics
from diffpir_tpu import runner as jrunner
from diffpir_tpu.inception import expected_conv_shapes
from diffpir_tpu_torch import config as tconfig
from diffpir_tpu_torch import metrics as tmetrics
from diffpir_tpu_torch import runner as trunner

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INPAINT32 = os.path.join(ROOT, "configs", "demo32_inpaint.yaml")
# fp32 VGG16 in XLA and in PyTorch, summed in other orders
LPIPS_RTOL = 1e-5
# FID of 2 against 2 images from features 1e-5 apart: the Fréchet distance
# of rank-deficient covariances moves by up to ~1e-4 of its value
FID_RTOL = 1e-3

# channel plan of VGG16's convs (torchvision indexing) and the tapped stages
_CH = {0: (3, 64), 2: (64, 64), 5: (64, 128), 7: (128, 128), 10: (128, 256),
       12: (256, 256), 14: (256, 256), 17: (256, 512), 19: (512, 512),
       21: (512, 512), 24: (512, 512), 26: (512, 512), 28: (512, 512)}
_TAP_CH = (64, 128, 256, 512, 512)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _lpips_weights(seed=0, scale=0.05):
    """``tests/test_lpips_local.py``'s recipe: torchvision and lpips keys."""
    rng = np.random.default_rng(seed)
    flat = {}
    for i, (cin, cout) in _CH.items():
        flat[f"features.{i}.weight"] = (
            rng.standard_normal((cout, cin, 3, 3)).astype(np.float32) * scale)
        flat[f"features.{i}.bias"] = rng.standard_normal((cout,)).astype(np.float32) * scale
    for k, c in enumerate(_TAP_CH):
        flat[f"lin{k}.model.1.weight"] = np.abs(
            rng.standard_normal((1, c, 1, 1)).astype(np.float32)) * scale
    return flat


@pytest.fixture(scope="module")
def lpips_files(tmp_path_factory):
    flat = _lpips_weights()
    d = tmp_path_factory.mktemp("lpips")
    npz, pt = str(d / "lpips_vgg.npz"), str(d / "lpips_vgg.pt")
    np.savez(npz, **flat)
    torch.save({k: torch.from_numpy(v) for k, v in flat.items()}, pt)
    return npz, pt


def _pair(seed, b, hw):
    rng = np.random.default_rng(seed)
    a = rng.uniform(-1, 1, (b, hw, hw, 3)).astype(np.float32)
    return a, np.clip(a + rng.normal(0, 0.2, a.shape), -1, 1).astype(np.float32)


@pytest.fixture(scope="module")
def jax_lpips(lpips_files):
    """JAX's LPIPS, built once per module (XLA compiles it once per shape)."""
    return jmetrics.lpips_from_weights(lpips_files[0])


@pytest.mark.parametrize("hw", [32, 64])
def test_lpips_from_weights_matches_jax(lpips_files, jax_lpips, hw):
    """From the .npz and from the .pt state dict, against JAX's."""
    a, b = _pair(hw, 2, hw)
    want = jax_lpips(a, b)
    for path in lpips_files:
        fn = tmetrics.lpips_from_weights(path, device="cpu")
        got = fn(a, b)
        assert got > 0.0 and fn(a, a) < 1e-6
        np.testing.assert_allclose(got, want, rtol=LPIPS_RTOL)


def test_make_lpips_routes_as_jax_does(lpips_files, jax_lpips):
    npz, _ = lpips_files
    a, b = _pair(5, 1, 32)
    got = tmetrics.make_lpips(weights_path=npz, device="cpu")(a, b)
    np.testing.assert_allclose(got, jax_lpips(a, b), rtol=LPIPS_RTOL)
    # without weights: the lpips package when it can build its network, else
    # None; both packages give the same answer here
    jfn, tfn = jmetrics.make_lpips(), tmetrics.make_lpips()
    assert (jfn is None) == (tfn is None)
    assert tmetrics.psnr_y_batch(a, b) == jmetrics.psnr_y_batch(a, b)


@pytest.mark.parametrize("broken", ["missing_conv", "bad_shape", "missing_lin"])
def test_malformed_lpips_files_raise_as_jax_does(tmp_path, broken):
    flat = _lpips_weights(1)
    if broken == "missing_conv":
        del flat["features.19.bias"]
        match = "missing VGG16 key"
    elif broken == "bad_shape":
        flat["features.5.weight"] = flat["features.5.weight"][:, :, :1]
        match = "expected \\(O,I,3,3\\)"
    else:
        del flat["lin3.model.1.weight"]
        match = "missing LPIPS head"
    path = str(tmp_path / "bad.npz")
    np.savez(path, **flat)
    with pytest.raises(ValueError, match=match):
        jmetrics.lpips_from_weights(path)
    with pytest.raises(ValueError, match=match):
        tmetrics.lpips_from_weights(path, device="cpu")


def test_runner_evaluate_lpips_and_fid_match_the_jax_runner(lpips_files, tmp_path,
                                                            monkeypatch):
    """Both Runners score the same restored batch of two test images (the
    JAX Runner's, 4 NFE, handed to the port's ``restore_batch``): LPIPS and
    FID through each ``evaluate``, and the port's LPIPS against its direct
    function."""
    rng = np.random.default_rng(0)
    flat = {}
    for prefix, (cout, cin, kh, kw) in expected_conv_shapes().items():
        flat[f"{prefix}.conv.weight"] = (rng.standard_normal((cout, cin, kh, kw))
                                         * (1.5 / np.sqrt(cin * kh * kw))).astype(np.float32)
        flat[f"{prefix}.bn.weight"] = rng.uniform(0.7, 1.3, cout).astype(np.float32)
        flat[f"{prefix}.bn.bias"] = rng.standard_normal(cout).astype(np.float32) * 0.05
        flat[f"{prefix}.bn.running_mean"] = rng.standard_normal(cout).astype(np.float32) * 0.05
        flat[f"{prefix}.bn.running_var"] = rng.uniform(0.7, 1.3, cout).astype(np.float32)
    fid_path = str(tmp_path / "inception.npz")
    np.savez(fid_path, **flat)
    over = dict(iter_num=4, cwd=ROOT, save_E=False, save_L=False, calc_LPIPS=True,
                lpips_weights=lpips_files[0], calc_FID=True, fid_weights=fid_path)

    restored = []
    jr = jrunner.Runner(jconfig.load_config(INPAINT32, over), use_mesh=False)
    orig = jr.restore_batch

    def record(*a, **kw):
        out = orig(*a, **kw)
        restored.append(np.asarray(out))
        return out

    monkeypatch.setattr(jr, "restore_batch", record)
    from diffpir_tpu_torch.utils.image import list_images

    paths = list_images(os.path.join(ROOT, "testsets", "demo32"))[:2]
    want = jr.evaluate(paths=paths)

    tr = trunner.Runner(tconfig.load_config(INPAINT32, over), device="cpu")
    outs = iter(restored)
    monkeypatch.setattr(tr, "restore_batch",
                        lambda *a, **kw: torch.from_numpy(next(outs).copy()))
    got = tr.evaluate(paths=paths)
    assert got["n_images"] == want["n_images"] == 2
    assert got["psnr"] == pytest.approx(want["psnr"], rel=1e-12)
    np.testing.assert_allclose(got["lpips"], want["lpips"], rtol=LPIPS_RTOL)
    np.testing.assert_allclose(got["fid"], want["fid"], rtol=FID_RTOL)

    # the results equal the direct functions on the same batch
    from diffpir_tpu_torch.data import make_batches, prepare_images

    np.random.seed(tr.cfg.seed)
    batch = make_batches(prepare_images(tr.cfg, paths), tr.cfg.batch_size)[0]
    x0, gt = restored[0], batch.img_H.astype(np.float32) / 255.0
    direct = tmetrics.lpips_from_weights(lpips_files[0], device="cpu")(x0 * 2 - 1, gt * 2 - 1)
    assert got["lpips"] == pytest.approx(direct, rel=1e-6)
