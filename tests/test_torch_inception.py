"""The port's InceptionV3 pool3 features and FID (``diffpir_tpu_torch/inception.py``)
against the JAX package's (``diffpir_tpu/inception.py``), on the same seeded
random weights in the torchvision ``inception_v3`` layout."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.image import resize as jax_resize

from diffpir_tpu import inception as jinc
from diffpir_tpu_torch import inception as tinc
from diffpir_tpu_torch import metrics as tmetrics
from diffpir_tpu_torch.ops.resize import bilinear_matrix, bilinear_resize

# fp32 features after 94 conv layers, summed in other orders by XLA and by
# PyTorch: relative 1e-4 of the largest feature
FEATURE_RTOL = 1e-4
# jax.image.resize on this CPU is 1.22e-5 from a float64 contraction of the
# same weights at 320 -> 299 (the port's einsums 1.05e-7), so the two
# packages are held at 2e-5 and the port alone at 1e-6 of float64
RESIZE_ATOL = 2e-5
RESIZE_F64_ATOL = 1e-6
# the float64 statistics on the same features
STATS_TOL = 1e-10


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """Seeded random weights (``tests/test_fid_local.py``'s recipe)."""
    rng = np.random.default_rng(0)
    flat = {}
    for prefix, (cout, cin, kh, kw) in jinc.expected_conv_shapes().items():
        flat[f"{prefix}.conv.weight"] = (
            rng.standard_normal((cout, cin, kh, kw))
            * (1.5 / np.sqrt(cin * kh * kw))).astype(np.float32)
        flat[f"{prefix}.bn.weight"] = rng.uniform(0.7, 1.3, cout).astype(np.float32)
        flat[f"{prefix}.bn.bias"] = rng.standard_normal(cout).astype(np.float32) * 0.05
        flat[f"{prefix}.bn.running_mean"] = (
            rng.standard_normal(cout).astype(np.float32) * 0.05)
        flat[f"{prefix}.bn.running_var"] = rng.uniform(0.7, 1.3, cout).astype(np.float32)
    path = tmp_path_factory.mktemp("fid") / "inception_rand.npz"
    np.savez(path, **flat)
    return str(path), flat


@pytest.fixture(scope="module")
def extractors(weights):
    """Each package's extractor without the resize, built once per module."""
    path, _ = weights
    return (jinc.inception_pool3_from_weights(path, resize_input=False),
            tinc.inception_pool3_from_weights(path, resize_input=False, device="cpu"))


def _images(seed, b, h, w):
    return np.random.default_rng(seed).random((b, h, w, 3)).astype(np.float32)


def test_tables_and_bn_folding_are_the_jax_packages(weights):
    _, flat = weights
    assert tinc.expected_conv_shapes() == jinc.expected_conv_shapes()
    assert tinc.N_FEATURES == jinc.N_FEATURES
    for name, shp in list(tinc.expected_conv_shapes().items())[::9]:
        tw, tb = tinc._fold_bn(flat, name, shp)
        jw, jb = jinc._fold_bn(flat, name, shp)
        np.testing.assert_array_equal(tw, jw.transpose(3, 2, 0, 1))
        np.testing.assert_array_equal(tb, jb.reshape(-1))


def test_pool3_features_match_jax(extractors):
    jfeat, tfeat = extractors
    x = _images(1, 2, 84, 96)
    want = jfeat(x)
    got = tfeat(x)
    assert got.shape == (2, tinc.N_FEATURES) and got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=0, atol=FEATURE_RTOL * np.abs(want).max())


@pytest.mark.parametrize("n_in", [64, 320, 299])
def test_resize_matches_jax_image_resize_up_and_down(n_in):
    """64 -> 299 interpolates, 320 -> 299 antialiases as jax.image.resize does
    when it shrinks (F.interpolate would not, without antialias=True)."""
    x = _images(n_in, 2, n_in, n_in)
    want = np.asarray(jax_resize(jnp.asarray(x), (2, 299, 299, 3), "bilinear"))
    got = bilinear_resize(torch.from_numpy(x), (299, 299)).numpy()
    m = torch.from_numpy(bilinear_matrix(n_in, 299))
    np.testing.assert_allclose(got, want, rtol=0, atol=RESIZE_ATOL)
    m64 = m.double().numpy()
    exact = np.einsum("bhwc,hH,wW->bHWc", x.astype(np.float64), m64, m64,
                      optimize=True)
    np.testing.assert_allclose(got, exact, rtol=0, atol=RESIZE_F64_ATOL)


def test_feature_stats_and_frechet_distance_match_in_float64():
    rng = np.random.default_rng(3)
    a = rng.standard_normal((40, 16))
    b = rng.standard_normal((40, 16)) @ rng.standard_normal((16, 16)) * 0.3 + 0.1
    for x in (a, b):
        for got, want in zip(tinc.feature_stats(x), jinc.feature_stats(x)):
            np.testing.assert_allclose(got, want, rtol=0, atol=STATS_TOL)
    sa, sb = tinc.feature_stats(a), tinc.feature_stats(b)
    got = tinc.frechet_distance(*sa, *sb)
    want = jinc.frechet_distance(*sa, *sb)
    assert abs(got - want) <= STATS_TOL * max(1.0, abs(want))
    assert abs(tinc.frechet_distance(*sa, *sa)) < 1e-8
    with pytest.raises(ValueError, match="N>=2"):
        tinc.feature_stats(a[:1])


def test_scorer_equals_the_one_shot_fid(weights, extractors, monkeypatch):
    """The streaming ``FidScorer`` and the one-shot ``fid_from_weights`` on the
    same features (the module's extractor, without the resize, stands in for
    the one they build)."""
    path, _ = weights
    monkeypatch.setattr(tinc, "inception_pool3_from_weights",
                        lambda *a, **kw: extractors[1])
    a, b = _images(11, 2, 84, 84), _images(12, 2, 84, 84)
    scorer = tinc.FidScorer(path, device="cpu")
    scorer.add(a[:1], b[:1])
    scorer.add(a[1:], b[1:])
    oneshot = tinc.fid_from_weights(path, device="cpu")(a, b, batch=1)
    np.testing.assert_allclose(scorer.score(), oneshot, rtol=1e-12)
    assert oneshot > 0.0
    # the facade re-exports the FID names lazily, as the JAX package's does
    assert tmetrics.FidScorer is tinc.FidScorer
    assert tmetrics.fid_from_weights is tinc.fid_from_weights


def test_malformed_weights_raise_as_jax_does(weights, tmp_path):
    _, flat = weights
    broken = dict(flat)
    del broken["Mixed_6b.branch7x7_2.bn.running_var"]
    p = tmp_path / "broken.npz"
    np.savez(p, **broken)
    for fn in (jinc.inception_pool3_from_weights,
               lambda q: tinc.inception_pool3_from_weights(q, device="cpu")):
        with pytest.raises(ValueError, match="missing key"):
            fn(str(p))
    bad = dict(flat)
    bad["Conv2d_1a_3x3.conv.weight"] = bad["Conv2d_1a_3x3.conv.weight"][:, :, :2]
    np.savez(p, **bad)
    for fn in (jinc.inception_pool3_from_weights,
               lambda q: tinc.inception_pool3_from_weights(q, device="cpu")):
        with pytest.raises(ValueError, match="expected"):
            fn(str(p))


def test_calc_fid_without_weights_raises(tmp_path):
    """Runner.evaluate refuses calc_FID without fid_weights, as JAX's does."""
    from diffpir_tpu_torch.config import load_config
    from diffpir_tpu_torch.runner import Runner

    over = dict(calc_FID=True, save_E=False, save_L=False, iter_num=2,
                model_name="tiny_test")
    runner = Runner(load_config("configs/demo32_inpaint.yaml", over), device="cpu")
    with pytest.raises(ValueError, match="fid_weights"):
        runner.evaluate()
