"""The port's FFT prox (``diffpir_tpu_torch/ops/fft_prox.py``) against the JAX
package's, on the same seeded numpy inputs, and both against fp64 solves at
the small taus of early trajectory steps."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from diffpir_tpu.ops import fft_prox as jfp
from diffpir_tpu.ops.degrade import blur_circular, fspecial_gaussian
from diffpir_tpu_torch.ops import degrade as tdeg
from diffpir_tpu_torch.ops import fft_prox as tfp

# [0, 1] images; complex64 FFTs of <= 48x48 images in two FFT libraries
# round differently by a few 1e-7
ATOL = 1e-5


def _inputs(seed, sf, n, c=3, b=2, ksize=7):
    rng = np.random.default_rng(seed)
    k = rng.random((b, ksize, ksize))
    k = (k / k.sum(axis=(1, 2), keepdims=True)).astype(np.float32)
    y = rng.random((b, n, n, c)).astype(np.float32)
    x0 = rng.random((b, n * sf, n * sf, c)).astype(np.float32)
    return y, k, x0


def test_fspecial_gaussian_is_a_copy():
    for size, sigma in ((5, 1.2), (3, 0.6), (25, 1.6)):
        np.testing.assert_array_equal(tdeg.fspecial_gaussian(size, sigma),
                                      fspecial_gaussian(size, sigma))


@pytest.mark.parametrize("sf", [1, 2, 3, 4])
@pytest.mark.parametrize("tau", [1e-3, 0.05, 2.0])
def test_prox_solve_matches_jax(sf, tau):
    y, k, x0 = _inputs(sf, sf, 12)
    ref = np.asarray(jfp.prox_solve(jnp.asarray(x0),
                                    jfp.precompute(jnp.asarray(y), jnp.asarray(k), sf),
                                    tau))
    op = tfp.precompute(torch.from_numpy(y), torch.from_numpy(k), sf)
    got = tfp.prox_solve(torch.from_numpy(x0), op, tau).numpy()
    assert got.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


def test_prox_solve_per_sample_tau():
    y, k, x0 = _inputs(5, 2, 8)
    tau = np.array([1e-3, 0.3], np.float32)
    ref = np.asarray(jfp.prox_solve(jnp.asarray(x0),
                                    jfp.precompute(jnp.asarray(y), jnp.asarray(k), 2),
                                    jnp.asarray(tau)))
    op = tfp.precompute(torch.from_numpy(y), torch.from_numpy(k), 2)
    got = tfp.prox_solve(torch.from_numpy(x0), op, torch.from_numpy(tau)).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


def test_precompute_spectra_match_jax():
    y, k, _ = _inputs(6, 3, 8)
    jop = jfp.precompute(jnp.asarray(y), jnp.asarray(k), 3)
    top = tfp.precompute(torch.from_numpy(y), torch.from_numpy(k), 3)
    assert top.sf == 3
    for name in ("FB", "FBC", "F2B", "FBFy"):
        got, ref = getattr(top, name).numpy(), np.asarray(getattr(jop, name))
        assert got.shape == ref.shape, name
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0, err_msg=name)


def test_updown_and_alias_mean_match_jax():
    rng = np.random.default_rng(1)
    x = rng.random((2, 4, 4, 3)).astype(np.float32)
    for sf in (1, 3):
        up = tfp.upsample_zeros(torch.from_numpy(x), sf).numpy()
        np.testing.assert_array_equal(up, np.asarray(jfp.upsample_zeros(jnp.asarray(x), sf)))
        np.testing.assert_array_equal(tfp.downsample_strided(torch.from_numpy(up), sf).numpy(), x)
    a = rng.random((2, 12, 12, 3)).astype(np.float32)
    # a mean of 9 values in [0, 1]: the two libraries sum in other orders
    np.testing.assert_allclose(tfp.alias_block_mean(torch.from_numpy(a), 3).numpy(),
                               np.asarray(jfp.alias_block_mean(jnp.asarray(a), 3)),
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("psf,shape", [
    (np.ones((3, 1, 1), np.float32), (8, 8)),                 # batched identity PSFs
    (np.full((2, 3, 1), 1 / 3, np.float32), (8, 8)),          # 1-pixel-wide kernels
    (np.full((2, 1, 4), 1 / 4, np.float32), (8, 6)),          # 1-pixel-tall, even width
    (np.full((2, 5, 5, 1), 1 / 25, np.float32), (10, 10)),    # 4-D with a channel axis
    (fspecial_gaussian(5, 1.2).astype(np.float32), (16, 16)),  # one 2-D kernel
])
def test_psf_to_otf_matches_jax(psf, shape):
    ref = np.asarray(jfp.psf_to_otf(jnp.asarray(psf), shape))
    got = tfp.psf_to_otf(torch.from_numpy(psf), shape).numpy()
    assert got.dtype == np.complex64 and got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


def _exact_sf1(y, k, x0, tau):
    n, ks = x0.shape[1], k.shape[0]
    otf = np.fft.fft2(np.roll(np.pad(k.astype(np.float64), ((0, n - ks), (0, n - ks))),
                              (-(ks // 2), -(ks // 2)), axis=(0, 1)))[None, :, :, None]
    Fy = np.fft.fft2(y.astype(np.float64), axes=(1, 2))
    F0 = np.fft.fft2(x0.astype(np.float64), axes=(1, 2))
    return np.real(np.fft.ifft2((np.conj(otf) * Fy + tau * F0) /
                                (np.abs(otf) ** 2 + tau), axes=(1, 2)))


def _exact_dense(y, k, x0, tau, sf):
    n_hr = x0.shape[1]
    N = n_hr * n_hr
    Hmat = np.zeros((y[0].size, N))
    for j in range(N):
        e = np.zeros((1, n_hr, n_hr, 1), np.float32)
        e.flat[j] = 1.0
        col = np.asarray(jfp.downsample_strided(
            blur_circular(jnp.asarray(e), jnp.asarray(k)[None]), sf))
        Hmat[:, j] = col.flatten()
    A = Hmat.astype(np.float64)
    return np.linalg.solve(A.T @ A + tau * np.eye(N),
                           A.T @ y.flatten().astype(np.float64)
                           + tau * x0.flatten().astype(np.float64)).reshape(x0.shape)


@pytest.mark.parametrize("tau", [1e-5, 1e-4])
def test_small_tau_sf1_error_within_twice_jax(tau):
    """tests/test_fft_prox.py's sf=1 small-tau case: against the fp64 solve
    the port's error is at most 2x the JAX package's."""
    rng = np.random.default_rng(7)
    n = 16
    k = fspecial_gaussian(5, 1.2).astype(np.float32)
    x0 = rng.random((1, n, n, 3)).astype(np.float32)
    y = np.asarray(blur_circular(jnp.asarray(rng.random((1, n, n, 3)).astype(np.float32)),
                                 jnp.asarray(k)[None]))
    exact = _exact_sf1(y, k, x0, tau)
    ref = np.asarray(jfp.prox_solve(jnp.asarray(x0),
                                    jfp.precompute(jnp.asarray(y), jnp.asarray(k)[None], 1),
                                    tau))
    got = tfp.prox_solve(torch.from_numpy(x0),
                         tfp.precompute(torch.from_numpy(y), torch.from_numpy(k)[None], 1),
                         tau).numpy()
    err_jax, err_port = np.abs(ref - exact).max(), np.abs(got - exact).max()
    assert err_port <= 2 * err_jax, (err_port, err_jax)


@pytest.mark.parametrize("tau", [1e-5, 1e-3])
def test_small_tau_sf2_error_within_twice_jax(tau):
    """tests/test_fft_prox.py's sf=2 small-tau case (dense fp64 normal
    equations): the port's error is at most 2x the JAX package's."""
    rng = np.random.default_rng(11)
    sf, n = 2, 8
    k = fspecial_gaussian(3, 0.6).astype(np.float32)
    x0 = rng.random((1, n * sf, n * sf, 1)).astype(np.float32)
    y = rng.random((1, n, n, 1)).astype(np.float32)
    exact = _exact_dense(y, k, x0, tau, sf)
    ref = np.asarray(jfp.prox_solve(jnp.asarray(x0),
                                    jfp.precompute(jnp.asarray(y), jnp.asarray(k)[None], sf),
                                    tau))
    got = tfp.prox_solve(torch.from_numpy(x0),
                         tfp.precompute(torch.from_numpy(y), torch.from_numpy(k)[None], sf),
                         tau).numpy()
    err_jax, err_port = np.abs(ref - exact).max(), np.abs(got - exact).max()
    assert err_port <= 2 * err_jax, (err_port, err_jax)
