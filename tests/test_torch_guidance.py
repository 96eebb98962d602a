"""Gradient guidance in the port against the JAX package: the DPS forward
blur, the Frobenius residual and the first-order prox against
``jax.value_and_grad``, DPS_y0 and DPS_yt trajectories fed JAX's draws, and
the ``autograd.Function``s around both CUDA kernels.

The Functions' forwards launch CUDA kernels, which this box cannot run; the
tests substitute the plain forward for the launch (``_launch``, the seam)
and hold the Functions' gradients to autograd of the plain version, fp32 at
atol 1e-6.  ``torch.autograd.gradcheck`` in float64 does not apply: both
plain versions compute their statistics or softmax in fp32 whatever the
input type, as the kernels do."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffpir_tpu import diffusion as jdiff
from diffpir_tpu import guidance as jguid
from diffpir_tpu import schedule as jsched
from diffpir_tpu.ops import degrade as jdeg
from diffpir_tpu_torch import guidance as tguid
from diffpir_tpu_torch import sampler as tsampler
from diffpir_tpu_torch import schedule as tsched
from diffpir_tpu_torch.diffusion import Diffusion as TDiffusion
from diffpir_tpu_torch.kernels import attention as kat
from diffpir_tpu_torch.kernels import groupnorm as kgn
from diffpir_tpu_torch.kernels._common import wants_grad
from diffpir_tpu_torch.models import unet as unet_mod
from diffpir_tpu_torch.ops import degrade as tdeg
from tests.test_torch_modes import jax_draws, models  # noqa: F401  (fixture)

ATOL = 1e-4
GRAD_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _psf(rng, b, kh, kw):
    k = rng.uniform(size=(b, kh, kw)).astype(np.float32)
    return k / k.sum(axis=(1, 2), keepdims=True)


@pytest.mark.parametrize("b,h,w,kh,kw,shared", [
    (2, 16, 16, 5, 5, False), (3, 20, 12, 7, 7, False), (1, 32, 32, 15, 15, False),
    (2, 16, 16, 3, 3, True), (2, 16, 18, 4, 4, False)],
    ids=["5x5", "7x7-rect", "15x15", "shared-3x3", "even-4x4"])
def test_blur_reflect_matches_jax(b, h, w, kh, kw, shared):
    rng = np.random.default_rng(kh * 10 + b)
    x = rng.uniform(size=(b, h, w, 3)).astype(np.float32)
    k = _psf(rng, 1 if shared else b, kh, kw)
    k = k[0] if shared else k
    ref = np.asarray(jdeg.blur_reflect(jnp.asarray(x), jnp.asarray(k)))
    got = tdeg.blur_reflect(torch.from_numpy(x), torch.from_numpy(k)).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


def _ops(task, rng, b=2, h=32, sf=2):
    """(JAX op, port op, measurement in [0, 1], kernel) for ``task``."""
    if task == "deblur":
        k = _psf(rng, b, 7, 7)
        jop = jguid.make_degrade_op("deblur", kernel=jnp.asarray(k))
        top = tguid.make_degrade_op("deblur", kernel=torch.from_numpy(k))
        y = rng.uniform(size=(b, h, h, 3)).astype(np.float32)
        return jop, top, y, y
    jop = jguid.make_degrade_op("sr", hr_hw=(h, h), sf=sf)
    top = tguid.make_degrade_op("sr", hr_hw=(h, h), sf=sf)
    y = rng.uniform(size=(b, h // sf, h // sf, 3)).astype(np.float32)
    return jop, top, y, 2 * y - 1


@pytest.mark.parametrize("task", ["deblur", "sr"])
def test_residual_and_grad_prox_match_jax_value_and_grad(task):
    rng = np.random.default_rng(1 if task == "deblur" else 2)
    jop, top, _, meas = _ops(task, rng)
    x0 = rng.uniform(-1, 1, size=(2, 32, 32, 3)).astype(np.float32)
    jnorm, jgrad = jax.value_and_grad(
        lambda v: jguid.frobenius_residual(jop, v, jnp.asarray(meas)))(jnp.asarray(x0))
    tnorm, tgrad = tguid._value_and_grad(
        lambda v: tguid.frobenius_residual(top, v, torch.from_numpy(meas)),
        torch.from_numpy(x0))
    np.testing.assert_allclose(float(tnorm), float(jnorm), rtol=GRAD_RTOL)
    np.testing.assert_allclose(tgrad.numpy(), np.asarray(jgrad), rtol=GRAD_RTOL,
                               atol=GRAD_RTOL * float(np.abs(jgrad).max()))
    for tau in (0.7, np.array([0.3, 2.0], np.float32)):
        jt = jnp.asarray(tau).reshape(-1, 1, 1, 1) if np.ndim(tau) else tau
        tt = tsampler.per_sample(tau, torch.from_numpy(x0)) if np.ndim(tau) else tau
        ref = np.asarray(jguid.make_grad_prox(jop, jnp.asarray(meas))(jnp.asarray(x0), jt))
        got = tguid.make_grad_prox(top, torch.from_numpy(meas))(torch.from_numpy(x0), tt)
        np.testing.assert_allclose(got.numpy(), ref, rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * float(np.abs(ref).max()))


@pytest.mark.parametrize("mode,task,per_sample", [
    ("DPS_y0", "deblur", False), ("DPS_yt", "deblur", False),
    ("DPS_y0", "sr", False), ("DPS_yt", "sr", True)],
    ids=["y0-deblur", "yt-deblur", "y0-sr", "yt-sr-per-sample"])
def test_dps_sample_matches_jax(models, mode, task, per_sample):  # noqa: F811
    """Three steps (t = 499, 292, 133).  At t = 999 x0 = 156 x - 156 eps, so the
    UNet's ~1e-5 agreement becomes ~3e-4 in x0 before its clamp to [-1, 1],
    and the few pixels that close to the bound take the clamp's other
    gradient branch in one package: a discontinuity of the function both
    packages compute, not a difference between them."""
    rng = np.random.default_rng(5)
    jop, top, y, _ = _ops(task, rng)
    x_init = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    key = jax.random.PRNGKey(13)
    lam = np.array([20.0, 80.0], np.float32) if per_sample else 50.0
    plan_kw = dict(iter_num=5, lambda_=1.0 if per_sample else lam, sigma_y=0.05,
                   rho_mode="xprev", t_start=900)
    jsch = jsched.NoiseSchedule.linear(1e-4, 0.02, 1000)
    ref = jguid.dps_sample(
        jdiff.Diffusion(jsch), models["jfn"], jop, jsched.build_plan(jsch, **plan_kw),
        jnp.asarray(x_init), key, mode=mode, task=task, y=jnp.asarray(y),
        lambda_=jnp.asarray(lam))
    tsch = tsched.NoiseSchedule.linear(1e-4, 0.02, 1000)
    got = tguid.dps_sample(
        TDiffusion(tsch), tsampler.model_fn(models["tden"]), top,
        tsched.build_plan(tsch, **plan_kw), torch.from_numpy(x_init),
        noise=jax_draws(key), mode=mode, task=task, y=torch.from_numpy(y), lambda_=lam)
    assert not got.requires_grad
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


# --- the autograd.Functions, through the seam -------------------------------

def _plain_gn_launch(x, scale, bias, fs, fb, num_groups, eps, do_silu):
    return kgn.groupnorm_silu_plain(x, scale, bias, fs, fb, num_groups=num_groups,
                                    eps=eps, do_silu=do_silu)


@pytest.mark.parametrize("film,silu,which", [
    (True, True, "all"), (False, True, "all"), (False, False, "x"),
    (True, False, "film"), (True, True, "x")])
def test_groupnorm_function_gradients_equal_plain_autograd(monkeypatch, film, silu,
                                                           which):
    monkeypatch.setattr(kgn, "_launch", _plain_gn_launch)
    gen = torch.Generator().manual_seed(3)
    b, c = 2, 64
    x = torch.randn((b, 6, 5, c), generator=gen)
    scale = 1.0 + 0.2 * torch.randn(c, generator=gen)
    bias = 0.2 * torch.randn(c, generator=gen)
    fs = 0.3 * torch.randn((b, c), generator=gen) if film else None
    fb = 0.3 * torch.randn((b, c), generator=gen) if film else None
    ins = [x, scale, bias, fs, fb]
    wants = {"all": [True] * 5, "x": [True, False, False, False, False],
             "film": [False, False, False, True, True]}[which]
    grad_out = torch.randn((b, 6, 5, c), generator=gen)

    def grads(fn):
        leaves = [None if t is None else t.clone().requires_grad_(w)
                  for t, w in zip(ins, wants)]
        y = fn(*leaves)
        wanted = [t for t in leaves if t is not None and t.requires_grad]
        return y, torch.autograd.grad(y, wanted, grad_out)

    y_fn, g_fn = grads(lambda *a: kgn.GroupNormSiLUFunction.apply(*a, 32, 1e-5, silu))
    y_pl, g_pl = grads(lambda *a: kgn.groupnorm_silu_plain(*a, do_silu=silu))
    assert y_fn.grad_fn is not None and len(g_fn) == len(g_pl) > 0
    torch.testing.assert_close(y_fn, y_pl, rtol=0, atol=0)
    for a, r in zip(g_fn, g_pl):
        torch.testing.assert_close(a, r, rtol=0, atol=1e-6)


@pytest.mark.parametrize("heads,ch,t", [(4, 16, 16), (2, 32, 64), (1, 64, 8)])
def test_attention_function_gradient_equals_plain_autograd(monkeypatch, heads, ch, t):
    monkeypatch.setattr(kat, "_launch", kat.legacy_qkv_attention_plain)
    gen = torch.Generator().manual_seed(heads)
    qkv = torch.randn((2, t, 3 * heads * ch), generator=gen)
    grad_out = torch.randn((2, t, heads * ch), generator=gen)
    a = qkv.clone().requires_grad_()
    (g_fn,) = torch.autograd.grad(kat.LegacyQKVAttentionFunction.apply(a, heads), a,
                                  grad_out)
    p = qkv.clone().requires_grad_()
    (g_pl,) = torch.autograd.grad(kat.legacy_qkv_attention_plain(p, heads), p, grad_out)
    torch.testing.assert_close(g_fn, g_pl, rtol=0, atol=1e-6)


def test_unet_gradient_through_the_functions_equals_plain(monkeypatch, models):  # noqa: F811
    """The gradient of an x0-like residual, ||c1 x - c2 eps(x)||, through a
    whole UNet with every GroupNorm and attention in its Function equals
    autograd of the plain UNet; the same gradient with those branches
    detached (what an undifferentiable launch gives: only the c1 x term is
    left) does not."""
    monkeypatch.setattr(kgn, "_launch", _plain_gn_launch)
    monkeypatch.setattr(kat, "_launch", kat.legacy_qkv_attention_plain)
    model = models["tden"].model
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 32, 32, 3)).astype(np.float32))
    t = torch.tensor([500, 500], dtype=torch.int32)

    def grad_with(gn, attn):
        monkeypatch.setattr(unet_mod, "groupnorm_silu", gn)
        monkeypatch.setattr(unet_mod, "legacy_qkv_attention", attn)
        xv = x.clone().requires_grad_()
        eps = model(xv, t)[..., :3]
        (g,) = torch.autograd.grad((1.7 * xv - 0.9 * eps).square().sum().sqrt(), xv)
        return g

    plain = grad_with(kgn.groupnorm_silu_plain, kat.legacy_qkv_attention_plain)
    via_fn = grad_with(
        lambda x, s, b, fs=None, fb=None, *, num_groups=32, eps=1e-5, do_silu=True:
        kgn.GroupNormSiLUFunction.apply(x, s, b, fs, fb, num_groups, eps, do_silu),
        kat.LegacyQKVAttentionFunction.apply)
    detached = grad_with(
        lambda *a, **k: kgn.groupnorm_silu_plain(*a, **k).detach(),
        lambda q, h: kat.legacy_qkv_attention_plain(q, h).detach())
    torch.testing.assert_close(via_fn, plain, rtol=0, atol=1e-6)
    rel = float((detached - plain).norm() / plain.norm())
    assert rel > 0.1, rel


def test_functions_are_entered_only_when_a_gradient_is_asked_for():
    x = torch.randn(3)
    assert not wants_grad(x, None)
    assert wants_grad(None, x.clone().requires_grad_())
    with torch.no_grad():
        assert not wants_grad(x.clone().requires_grad_())
    # on a CPU tensor the wrappers run the plain versions: inside the
    # Function where a gradient is asked for (its backward is the one an
    # exported program's operator records), bare otherwise
    xg = torch.randn((1, 4, 4, 32), requires_grad=True)
    y = kgn.groupnorm_silu(xg, torch.ones(32), torch.zeros(32))
    assert "GroupNormSiLUFunction" in type(y.grad_fn).__name__
    torch.testing.assert_close(y, kgn.groupnorm_silu_plain(xg, torch.ones(32),
                                                           torch.zeros(32)), rtol=0, atol=0)
    with torch.no_grad():
        assert kgn.groupnorm_silu(xg, torch.ones(32), torch.zeros(32)).grad_fn is None
    q = torch.randn((1, 16, 3 * 2 * 8), requires_grad=True)
    assert "LegacyQKVAttentionFunction" in type(kat.legacy_qkv_attention(q, 2).grad_fn).__name__
