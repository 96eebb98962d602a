"""The port's MATLAB-exact resizer (``diffpir_tpu_torch/ops/resize.py``)
against the JAX package's, on the same seeded numpy images."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from diffpir_tpu.ops import resize as jrs
from diffpir_tpu_torch.ops import resize as trs

# fp32 contractions of [0, 1] images with normalised weights: the two
# libraries sum in other orders, a few fp32 ulps apart
ATOL = 1e-6


def _img(seed, b, h, w, c=3):
    return np.random.default_rng(seed).random((b, h, w, c)).astype(np.float32)


@pytest.mark.parametrize("kernel", ["cubic", "cubic_torch", "linear", "box",
                                    "lanczos2", "lanczos3"])
@pytest.mark.parametrize("n_in,n_out,scale,aa", [
    (64, 32, 0.5, True), (64, 16, 0.25, True), (48, 16, 1 / 3, True),
    (16, 32, 2.0, False), (16, 64, 4.0, True), (20, 60, 3.0, False)])
def test_resize_matrix_is_a_copy(kernel, n_in, n_out, scale, aa):
    np.testing.assert_array_equal(trs.resize_matrix(n_in, n_out, scale, kernel, aa),
                                  jrs.resize_matrix(n_in, n_out, scale, kernel, aa))


@pytest.mark.parametrize("hw,scale,kernel,aa", [
    ((64, 64), 1 / 2, "cubic", True),          # sr blur/cubic x2 observation
    ((64, 64), 1 / 4, "cubic", True),
    ((48, 36), 1 / 3, "cubic", True),
    ((32, 32), 2.0, "cubic_torch", False),     # sr classical init, sr init
    ((16, 24), 4.0, "cubic_torch", False),
])
def test_resize2d_matches_jax(hw, scale, kernel, aa):
    x = _img(hw[0], 2, *hw)
    ref = np.asarray(jrs.resize2d(jnp.asarray(x), scale, kernel=kernel, antialiasing=aa))
    got = trs.resize2d(torch.from_numpy(x), scale, kernel=kernel, antialiasing=aa)
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)


def test_resize2d_out_shape_and_dtype():
    x = _img(3, 1, 40, 30)
    ref = np.asarray(jrs.resize2d(jnp.asarray(x), out_shape=(20, 15)))
    got = trs.resize2d(torch.from_numpy(x), out_shape=(20, 15))
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)
    half = trs.resize2d(torch.from_numpy(x).to(torch.bfloat16), 0.5)
    assert half.dtype == torch.bfloat16 and tuple(half.shape) == (1, 20, 15, 3)


@pytest.mark.parametrize("hw,scale,kernel,aa", [
    ((64, 64), 1 / 2, "cubic", True),          # the cubic SR prox's down
    ((32, 32), 1 / 4, "cubic", True),
    ((16, 16), 2.0, "cubic_torch", False),     # the sr init's up
    ((8, 12), 4.0, "cubic_torch", False),
])
def test_resizer2d_matches_jax(hw, scale, kernel, aa):
    x = _img(7, 2, *hw)
    jres = jrs.Resizer2D(hw, scale, kernel, aa)
    tres = trs.Resizer2D(hw, scale, kernel, aa)
    assert tres.out_hw == jres.out_hw
    ref = np.asarray(jres(jnp.asarray(x)))
    got = tres(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)
    # a second call reuses the matrices it holds
    np.testing.assert_array_equal(tres(torch.from_numpy(x)).numpy(), got.numpy())
