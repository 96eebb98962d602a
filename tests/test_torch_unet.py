"""The port's UNet with weights carried over by ``flax_to_torch`` against the
JAX package's ``UNet.apply``, in fp32."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffpir_tpu.models import zoo as jzoo
from diffpir_tpu.models.unet import UNet as JUNet
from diffpir_tpu.models.unet import UNetConfig as JUNetConfig
from diffpir_tpu_torch.kernels import LAUNCHES
from diffpir_tpu_torch.models import zoo as tzoo
from diffpir_tpu_torch.models.unet import UNet as TUNet
from diffpir_tpu_torch.models.unet import UNetConfig as TUNetConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY32 = os.path.join(ROOT, "assets", "demo", "tiny_demo32.flax.npz")
# fp32 end to end in both (the JAX side at Precision.HIGHEST): the bar of the
# JAX package's own checkpoint converter (README.md, converter parity)
ATOL = 1e-4

# narrow flagship topology: 6-level channel_mult, attention at ds16 (and the
# middle block), 32-channel heads; C/32 = 1, 2 and 4
NARROW_FLAGSHIP = dict(image_size=64, model_channels=32, out_channels=6,
                       num_res_blocks=1, attention_resolutions=(16,),
                       channel_mult=(1, 1, 2, 2, 4, 4), num_heads=4,
                       num_head_channels=32, dropout=0.0)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict) else {key: v})
    return out


def _param_shapes(jcfg):
    shapes = jax.eval_shape(JUNet(jcfg, dtype=jnp.float32).init,
                            jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct((1, 64, 64, jcfg.in_channels),
                                                 jnp.float32),
                            jax.ShapeDtypeStruct((1,), jnp.int32))["params"]
    return _flat(shapes)


def _compare(jcfg, tcfg, flat, size, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, size, size, jcfg.in_channels)).astype(np.float32)
    t = np.array([3, 871], np.int32)
    params = jzoo._unflatten({k: jnp.asarray(v) for k, v in flat.items()})
    jmodel = JUNet(jcfg, dtype=jnp.float32)
    ref = np.asarray(jax.jit(lambda p, a, b: jmodel.apply({"params": p}, a, b))(
        params, jnp.asarray(x), jnp.asarray(t)))
    model = TUNet(tcfg)
    model.load_state_dict(tzoo.flax_to_torch(flat))
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
    return model, x, t, got


def test_tiny_demo32_trained_weights_match_jax():
    flat = tzoo.load_params_npz(TINY32)
    _compare(jzoo.TINY_TEST_CONFIG, tzoo.TINY_TEST_CONFIG, flat, 32, 0)


def test_narrow_flagship_topology_random_weights_match_jax():
    jcfg = JUNetConfig(**NARROW_FLAGSHIP)
    # every parameter random (the training init zeroes the output convs,
    # which would hide the layers before them)
    rng = np.random.default_rng(1)
    flat = {k: (0.2 * rng.standard_normal(v.shape)).astype(np.float32)
            + (1.0 if k.endswith("scale") else 0.0)
            for k, v in _param_shapes(jcfg).items()}
    model, x, t, got = _compare(jcfg, TUNetConfig(**NARROW_FLAGSHIP), flat, 64, 2)
    assert np.abs(got).max() > 1e-2
    # both routes run the plain versions on the CPU, so they agree exactly
    # and launch nothing
    plain = TUNet(TUNetConfig(**NARROW_FLAGSHIP), kernels="plain")
    plain.load_state_dict(model.state_dict())
    LAUNCHES.clear()
    with torch.no_grad():
        again = plain(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    np.testing.assert_array_equal(again, got)
    assert sum(LAUNCHES.values()) == 0


def test_heads_from_num_heads_random_weights_match_jax():
    """num_head_channels = -1 (guided-diffusion's default, its LSUN
    checkpoints): each attention layer splits into num_heads heads of C /
    num_heads channels, here one head of 128 channels at ds16 and in the
    middle block (a width of attn_bf16_any and attn_f32_any on the card)."""
    cfg = dict(NARROW_FLAGSHIP, num_heads=1, num_head_channels=-1)
    jcfg = JUNetConfig(**cfg)
    tcfg = TUNetConfig(**cfg)
    assert tcfg.heads_for(128) == jcfg.heads_for(128) == 1
    rng = np.random.default_rng(3)
    flat = {k: (0.2 * rng.standard_normal(v.shape)).astype(np.float32)
            + (1.0 if k.endswith("scale") else 0.0)
            for k, v in _param_shapes(jcfg).items()}
    model, _, _, got = _compare(jcfg, tcfg, flat, 64, 4)
    assert np.abs(got).max() > 1e-2
    assert {m.num_heads for m in model.modules() if hasattr(m, "num_heads")} == {1}


def test_flax_to_torch_layouts():
    flat = {"a_0/conv1/kernel": np.arange(2 * 3 * 4 * 5, dtype=np.float32).reshape(2, 3, 4, 5),
            "a_0/emb_proj/kernel": np.arange(6, dtype=np.float32).reshape(2, 3),
            "a_0/norm1/scale": np.ones(4, np.float16),
            "a_0/norm1/bias": np.zeros(4, np.float32)}
    sd = tzoo.flax_to_torch(flat)
    assert sd["a_0.conv1.weight"].shape == (5, 4, 2, 3)
    assert sd["a_0.conv1.weight"][1, 2, 0, 1] == flat["a_0/conv1/kernel"][0, 1, 2, 1]
    assert sd["a_0.emb_proj.weight"].shape == (3, 2)
    assert sd["a_0.norm1.weight"].dtype == torch.float32
    # the class embedding's table is a weight; an unknown leaf raises
    emb = tzoo.flax_to_torch({"label_emb/embedding": np.zeros((3, 4), np.float32)})
    assert emb["label_emb.weight"].shape == (3, 4)
    with pytest.raises(KeyError):
        tzoo.flax_to_torch({"a_0/norm1/gamma": np.zeros(4, np.float32)})


def test_every_named_config_builds_with_jax_parameter_names():
    for name in ("tiny_test", "demo64_hq", "demo256", "diffusion_ffhq_10m"):
        jcfg, tcfg = jzoo.model_config_for(name), tzoo.model_config_for(name)
        assert tcfg == TUNetConfig(**{f: getattr(jcfg, f) for f in
                                      TUNetConfig.__dataclass_fields__})
        flat = {k: np.zeros(v.shape, np.float32)
                for k, v in _param_shapes(jcfg).items()}
        model = TUNet(tcfg)
        model.load_state_dict(tzoo.flax_to_torch(flat))  # strict: names and shapes
        assert sum(p.numel() for p in model.parameters()) == sum(
            v.size for v in flat.values())
