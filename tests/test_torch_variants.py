"""The port's UNet variants (``diffpir_tpu_torch/models/variants.py``) and
their guided-diffusion conversions against the JAX package's
(``diffpir_tpu/models/variants.py``, ``diffpir_tpu/models/convert.py``), on
the same seeded random weights carried over by ``zoo.flax_to_torch``; the
classifier's gradient and a classifier-guided ``p_sample`` against JAX's;
and head widths outside the tuned kernels through the plain attention
against the Pallas kernel in interpret mode."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffpir_tpu import diffusion as jdiff
from diffpir_tpu import schedule as jsched
from diffpir_tpu.models import convert as jconvert
from diffpir_tpu.models import zoo as jzoo
from diffpir_tpu.models import variants as jvar
from diffpir_tpu.models.unet import UNetConfig as JCfg
from diffpir_tpu.pallas.attention import legacy_qkv_attention as pallas_attention
from diffpir_tpu_torch import diffusion as tdiff
from diffpir_tpu_torch import schedule as tsched
from diffpir_tpu_torch.kernels import attention as tattn
from diffpir_tpu_torch.models import convert as tconvert
from diffpir_tpu_torch.models import variants as tvar
from diffpir_tpu_torch.models import zoo as tzoo
from diffpir_tpu_torch.models.unet import UNetConfig as TCfg

# fp32 forwards of small random-weight models in both packages (JAX at
# Precision.HIGHEST): 1e-5 of the output's scale
FWD_RTOL = 1e-5
# the classifier's d log p(y|x) / dx: relative L2 against jax.grad
GRAD_RTOL = 1e-4
# one guided ancestral step: the means differ by the gradient's error times
# the step's variance
STEP_ATOL = 1e-5
# plain attention against the Pallas kernel in interpret mode, fp32
ATTN_ATOL = 2e-5

ENC = dict(image_size=16, in_channels=3, model_channels=32, out_channels=10,
           num_res_blocks=1, attention_resolutions=(2,), channel_mult=(1, 2),
           num_heads=4, num_head_channels=16, dropout=0.0,
           use_scale_shift_norm=True, resblock_updown=True)
SR = dict(image_size=16, in_channels=6, model_channels=32, out_channels=6,
          num_res_blocks=1, attention_resolutions=(2,), channel_mult=(1, 2),
          num_heads=4, num_head_channels=16, dropout=0.0)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict) else {key: v})
    return out


def _random_flat(jmodel, seed, *args):
    """Every parameter random (the inits zero some layers, which would hide
    the ones before them); GroupNorm scales around 1."""
    shapes = _flat(jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), *args)["params"])
    rng = np.random.default_rng(seed)
    return {k: (0.15 * rng.standard_normal(v.shape)).astype(np.float32)
            + (1.0 if k.endswith("scale") else 0.0) for k, v in shapes.items()}


def _params(flat):
    return jzoo._unflatten({k: jnp.asarray(v) for k, v in flat.items()})


def _inputs(seed, b, hw, c):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hw, hw, c)).astype(np.float32),
            np.array([3, 871][:b], np.int32))


def _encoder_pair(pool, seed, **over):
    cfg = {**ENC, **over}
    jm = jvar.EncoderUNet(JCfg(**cfg), pool=pool)
    x, t = _inputs(seed, 2, cfg["image_size"], cfg["in_channels"])
    flat = _random_flat(jm, seed, jnp.asarray(x), jnp.asarray(t))
    tm = tvar.EncoderUNet(TCfg(**cfg), pool=pool)
    tm.load_state_dict(tzoo.flax_to_torch(flat))
    return jm, flat, tm, x, t


@pytest.mark.parametrize("pool,over", [
    ("attention", {}), ("adaptive", {}), ("spatial", {}), ("spatial_v2", {}),
    ("attention", dict(resblock_updown=False)),
    ("spatial", dict(resblock_updown=False, conv_resample=False))])
def test_encoder_heads_match_jax(pool, over):
    jm, flat, tm, x, t = _encoder_pair(pool, 1, **over)
    ref = np.asarray(jm.apply({"params": _params(flat)}, jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    assert got.shape == ref.shape == (2, ENC["out_channels"])
    np.testing.assert_allclose(got, ref, rtol=0, atol=FWD_RTOL * np.abs(ref).max())


def test_superres_unet_matches_jax():
    jm = jvar.SuperResUNet(JCfg(**SR))
    x, t = _inputs(2, 2, 16, 3)
    low = np.random.default_rng(3).random((2, 8, 8, 3)).astype(np.float32)
    flat = _random_flat(jm, 2, jnp.asarray(x), jnp.asarray(t), jnp.asarray(low))
    ref = np.asarray(jm.apply({"params": _params(flat)}, jnp.asarray(x), jnp.asarray(t),
                              jnp.asarray(low)))
    tm = tvar.SuperResUNet(TCfg(**SR))
    tm.load_state_dict(tzoo.flax_to_torch(flat))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(low)).numpy()
    assert got.shape == ref.shape == (2, 16, 16, 6)
    np.testing.assert_allclose(got, ref, rtol=0, atol=FWD_RTOL * np.abs(ref).max())
    # the flat parameters come back as they went in
    back = tzoo.torch_to_flax(tm.state_dict())
    assert back.keys() == flat.keys()
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k])


def _logp_fns(jm, flat, tm, y):
    params = _params(flat)

    def jlogp(v, tt):
        logits = jm.apply({"params": params}, v, tt)
        return jax.nn.log_softmax(logits, axis=-1)[jnp.arange(v.shape[0]), y].sum()

    def tgrad(v, tt):
        with torch.enable_grad():
            v = v.detach().requires_grad_()
            lp = torch.log_softmax(tm(v, tt), dim=-1)[torch.arange(v.shape[0]),
                                                      torch.from_numpy(np.asarray(y))]
            (g,) = torch.autograd.grad(lp.sum(), v)
        return g

    return jlogp, tgrad


def test_classifier_gradient_matches_jax_grad():
    jm, flat, tm, x, t = _encoder_pair("attention", 4)
    y = np.array([1, 7])
    jlogp, tgrad = _logp_fns(jm, flat, tm, y)
    ref = np.asarray(jax.grad(jlogp)(jnp.asarray(x), jnp.asarray(t)))
    got = tgrad(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
    assert rel <= GRAD_RTOL, rel


def test_classifier_guided_p_sample_matches_jax():
    """JAX's p_sample(cond_fn=) against the port's with JAX's draw handed in:
    the same step, shifted by the guidance."""
    jm, flat, tm, x, _ = _encoder_pair("attention", 5)
    y = np.array([2, 9])
    jlogp, tgrad = _logp_fns(jm, flat, tm, y)
    mean, var = jdiff.ModelMeanType.EPSILON, jdiff.ModelVarType.LEARNED_RANGE
    jd = jdiff.Diffusion(jsched.NoiseSchedule.linear(1e-4, 0.02, 1000), mean, var)
    td = tdiff.Diffusion(tsched.NoiseSchedule.linear(1e-4, 0.02, 1000),
                         tdiff.ModelMeanType.EPSILON, tdiff.ModelVarType.LEARNED_RANGE)
    t = np.array([400, 400], np.int32)
    key = jax.random.PRNGKey(3)
    noise = np.array(jax.random.normal(key, x.shape, jnp.float32))

    def jmodel(v, tt):
        return jnp.concatenate([jnp.tanh(v), jnp.sin(v)], axis=-1)

    def tmodel(v, tt):
        return torch.cat([torch.tanh(v), torch.sin(v)], dim=-1)

    jcond = lambda v, tt: 10.0 * jax.grad(jlogp)(v, tt)
    tcond = lambda v, tt: 10.0 * tgrad(v, tt)
    ref = np.asarray(jd.p_sample(jmodel, jnp.asarray(x), jnp.asarray(t), key,
                                 cond_fn=jcond)["sample"])
    ref_free = np.asarray(jd.p_sample(jmodel, jnp.asarray(x), jnp.asarray(t), key)["sample"])
    got = td.p_sample(tmodel, torch.from_numpy(x), torch.from_numpy(t),
                      torch.from_numpy(noise), cond_fn=tcond)["sample"].numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=STEP_ATOL)
    assert np.abs(ref - ref_free).max() > 100 * STEP_ATOL  # the guidance moved it


@pytest.mark.parametrize("pool", ["attention", "adaptive", "spatial", "spatial_v2"])
def test_classifier_state_dict_conversion_matches_jax(pool):
    """The guided-diffusion keys of each head through both converters give
    the same parameters, and the port's round trip is bit-equal."""
    _, flat, tm, _, _ = _encoder_pair(pool, 6)
    sd = tconvert.to_guided_state_dict(tm.state_dict())
    jparams = {k: np.asarray(v) for k, v in _flat(jconvert.convert_state_dict(
        {k: v.numpy() for k, v in sd.items()})).items()}
    assert tzoo.flax_to_torch(jparams).keys() == tm.state_dict().keys()
    for k, v in tzoo.flax_to_torch(jparams).items():
        np.testing.assert_array_equal(v.numpy(), tm.state_dict()[k].numpy(), err_msg=k)
    back = tconvert.convert_state_dict(sd)
    assert back.keys() == tm.state_dict().keys()
    for k, v in tm.state_dict().items():
        assert torch.equal(back[k], v), k
    if pool == "attention":   # guided-diffusion stores the embedding (C, T+1)
        pe = tm.state_dict()["out_pool.positional_embedding"]
        assert sd["out.2.positional_embedding"].shape == pe.T.shape
    with pytest.raises(ValueError, match="unmapped"):
        tconvert.convert_state_dict({**sd, "out.9.weight": torch.zeros(3)})


def test_superres_state_dict_conversion_round_trips():
    tm = tvar.SuperResUNet(TCfg(**SR))
    tzoo.init_random_(tm, 0)
    sd = tconvert.to_guided_state_dict(tm.state_dict(), prefix="unet.")
    assert sd["input_blocks.0.0.weight"].shape[1] == 6
    jparams = {k: np.asarray(v) for k, v in _flat(jconvert.convert_state_dict(
        {k: v.numpy() for k, v in sd.items()})).items()}
    back = tconvert.convert_state_dict(sd, prefix="unet.")
    assert back.keys() == tm.state_dict().keys()
    for k, v in tm.state_dict().items():
        assert torch.equal(back[k], v), k
    jsd = tzoo.flax_to_torch(jparams)   # the JAX converter's UNet parameters
    assert {"unet." + k for k in jsd} == back.keys()
    for k, v in jsd.items():
        np.testing.assert_array_equal(v.numpy(), back["unet." + k].numpy(), err_msg=k)


@pytest.mark.parametrize("ch,heads,t", [(24, 4, 64), (96, 2, 64), (7, 3, 33)])
def test_other_head_widths_plain_attention_matches_pallas(ch, heads, t):
    """Widths the generic CUDA kernel runs: the plain version (what the
    wrapper runs on the CPU) against the Pallas kernel in interpret mode."""
    qkv = np.random.default_rng(ch).standard_normal((2, t, 3 * heads * ch)).astype(np.float32)
    ref = np.asarray(pallas_attention(jnp.asarray(qkv), heads))
    got = tattn.legacy_qkv_attention(torch.from_numpy(qkv), heads).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATTN_ATOL)
    assert ch in tattn.KERNEL_HEAD_CHANNELS


def test_head_widths_above_the_kernel_limit_are_refused():
    """The kernel has no width limit now (256 was the last before attn_wide):
    wider heads are taken, and only a shape that does not split into heads
    is refused."""
    for ch in (257, 320, 512, 1024):
        assert tattn.check_inputs(torch.zeros((1, 4, 3 * 2 * ch)), 2) == ch
        assert ch in tattn.KERNEL_HEAD_CHANNELS
    assert 256 in tattn.KERNEL_HEAD_CHANNELS and 0 not in tattn.KERNEL_HEAD_CHANNELS
    with pytest.raises(ValueError, match="3\\*heads\\*ch"):
        tattn.check_inputs(torch.zeros((1, 4, 3 * 2 * 257 + 1)), 2)
