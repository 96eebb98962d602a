"""The port's boundary tools (``diffpir_tpu_torch/ops/boundary.py``) against
the JAX package's (``diffpir_tpu/ops/boundary.py``) on the same seeded numpy
inputs: both are numpy and ``scipy.fftpack``, so every function is held bit
for bit."""

import numpy as np
import pytest

from diffpir_tpu.ops import boundary as jb
from diffpir_tpu_torch.ops import boundary as tb


def _eq(got, want):
    assert type(got) is type(want)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape,position", [((9, 12), "corner"), ((9, 11), "center"),
                                            ((5, 7), "corner")])
def test_zero_pad(shape, position):
    img = np.random.default_rng(0).random((5, 7))
    _eq(tb.zero_pad(img, shape, position), jb.zero_pad(img, shape, position))


@pytest.mark.parametrize("shape,position,match", [
    ((4, 7), "corner", "smaller"), ((0, 7), "corner", "negative"),
    ((8, 11), "center", "parity")])
def test_zero_pad_refusals(shape, position, match):
    img = np.ones((5, 7))
    for mod in (jb, tb):
        with pytest.raises(ValueError, match=match):
            mod.zero_pad(img, shape, position)


@pytest.mark.parametrize("ksize,shape", [((5, 7), (16, 20)), ((3, 3), None),
                                         ((1, 9), (8, 32))])
def test_psf2otf_and_otf2psf(ksize, shape):
    k = np.random.default_rng(sum(ksize)).random(ksize)
    otf = tb.psf2otf(k, shape)
    _eq(otf, jb.psf2otf(k, shape))
    _eq(tb.otf2psf(otf, ksize), jb.otf2psf(otf, ksize))
    _eq(tb.otf2psf(otf), jb.otf2psf(otf))
    np.testing.assert_allclose(np.real(tb.otf2psf(otf, ksize)), k, atol=1e-10)
    _eq(tb.psf2otf(np.zeros((3, 3)), (8, 8)), jb.psf2otf(np.zeros((3, 3)), (8, 8)))


def test_opt_fft_size():
    n = [1, 7, 111, 255, 256, 500, 1023, 2047, 2049]
    _eq(tb.opt_fft_size(n), jb.opt_fft_size(n))


@pytest.mark.parametrize("hw", [(3, 3), (3, 9), (9, 3), (12, 17)])
def test_solve_min_laplacian(hw):
    img = np.random.default_rng(hw[0] * 31 + hw[1]).random(hw)
    _eq(tb.solve_min_laplacian(img.copy()), jb.solve_min_laplacian(img.copy()))


@pytest.mark.parametrize("channels", [None, 3])
def test_wrap_boundary_liu(channels):
    rng = np.random.default_rng(5)
    img = rng.random((24, 20) if channels is None else (24, 20, channels))
    target = (32, 30)
    got = tb.wrap_boundary_liu(img.copy(), target)
    _eq(got, jb.wrap_boundary_liu(img.copy(), target))
    assert got.shape[:2] == target
    np.testing.assert_array_equal(got[:24, :20], img)
