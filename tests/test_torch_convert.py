"""The port's guided-diffusion checkpoint converter (``models/convert.py``)
and the zoo's ``.pt`` route against the JAX package: seeded JAX parameters
go out through the JAX package's ``flax_to_torch_state_dict`` (the
guided-diffusion layout of a published ``.pt``), into the port through
``convert_state_dict``, and the port's forward must equal the JAX UNet's."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffpir_tpu.models import convert as jconvert
from diffpir_tpu.models import zoo as jzoo
from diffpir_tpu.models.unet import UNet as JUNet
from diffpir_tpu_torch.models import convert as tconvert
from diffpir_tpu_torch.models import zoo as tzoo
from diffpir_tpu_torch.models.unet import UNet as TUNet
from diffpir_tpu_torch.models.unet import UNetConfig as TUNetConfig

# fp32 end to end in both (the JAX side at Precision.HIGHEST): the bar of the
# JAX package's own checkpoint converter
ATOL = 1e-4

# 256x256_diffusion_uncond's topology (two ResBlocks a level, attention at
# ds 8, 16 and 32, 64-channel heads) at 1/8 of its width and heads of 16
NARROW_UNCOND = dataclasses.replace(
    jzoo.MODEL_ZOO_CONFIGS["256x256_diffusion_uncond"], image_size=64,
    model_channels=32, num_head_channels=16)
CONFIGS = {
    "tiny_test": jzoo.TINY_TEST_CONFIG,
    "narrow_uncond": NARROW_UNCOND,
    "conv_resample": dataclasses.replace(jzoo.TINY_TEST_CONFIG, resblock_updown=False),
    # resampling without weights: average pooling down, nearest up
    "pool_resample": dataclasses.replace(jzoo.TINY_TEST_CONFIG, resblock_updown=False,
                                         conv_resample=False),
    "class_conditional": dataclasses.replace(jzoo.TINY_TEST_CONFIG, num_classes=5),
}


def _port_config(jcfg):
    return TUNetConfig(**{f: getattr(jcfg, f) for f in TUNetConfig.__dataclass_fields__})


def _inputs(jcfg, size=64):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, size, size, jcfg.in_channels)).astype(np.float32)
    t = np.array([7, 912], np.int32)
    y = np.array([1, 4], np.int32) if jcfg.num_classes else None
    return x, t, y


def _seeded_params(jcfg, x, t, y):
    """Every parameter random (the training init zeroes the output convs,
    which would hide the layers before them)."""
    module = JUNet(jcfg, dtype=jnp.float32)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), jnp.asarray(x),
                            jnp.asarray(t), None if y is None else jnp.asarray(y))["params"]
    rng = np.random.default_rng(1)
    return module, jax.tree_util.tree_map(
        lambda s: (0.2 * rng.standard_normal(s.shape)).astype(np.float32), shapes)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_converted_checkpoint_forward_matches_jax(name):
    jcfg = CONFIGS[name]
    x, t, y = _inputs(jcfg)
    module, params = _seeded_params(jcfg, x, t, y)
    ref = np.asarray(jax.jit(module.apply)({"params": params}, jnp.asarray(x),
                                           jnp.asarray(t),
                                           None if y is None else jnp.asarray(y)))
    guided = jconvert.flax_to_torch_state_dict(params)
    model = TUNet(_port_config(jcfg))
    model.load_state_dict(tconvert.convert_state_dict(guided))  # strict
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(t),
                    None if y is None else torch.from_numpy(y).long()).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
    assert np.abs(got).max() > 1e-2

    # the port's inverse gives back the guided-diffusion dict bit for bit,
    # and converting that again gives back the port's
    back = tconvert.to_guided_state_dict(model.state_dict())
    assert sorted(back) == sorted(guided)
    for k, v in guided.items():
        np.testing.assert_array_equal(back[k].numpy(), np.asarray(v, np.float32), err_msg=k)
    again = tconvert.convert_state_dict(back)
    for k, v in model.state_dict().items():
        assert torch.equal(again[k], v), k


def test_unmapped_keys_raise():
    jcfg = jzoo.TINY_TEST_CONFIG
    model = tzoo.init_random_(TUNet(_port_config(jcfg)), 0)
    guided = tconvert.to_guided_state_dict(model.state_dict())
    for extra in ("input_blocks.1.0.in_layers.1.weight", "out.1.weight",
                  "middle_block.1.qkv.scale", "encoder.0.weight"):
        with pytest.raises(ValueError, match="unmapped checkpoint keys"):
            tconvert.convert_state_dict({**guided, extra: torch.zeros(4)})


def test_pt_checkpoint_resolves_in_the_jax_order(tmp_path):
    """``<zoo>/<name>.pt`` loads as "checkpoint"; an npz cache at least as
    new as it wins ("cache"); a newer .pt wins over a stale npz."""
    jcfg = jzoo.TINY_TEST_CONFIG
    src = tzoo.init_random_(TUNet(_port_config(jcfg)), 11)
    pt = tmp_path / "tiny_zoo_probe.pt"
    torch.save(tconvert.to_guided_state_dict(src.state_dict()), pt)
    res = tzoo.resolve_model("tiny_zoo_probe", str(tmp_path), device="cpu")
    assert res.provenance == "checkpoint"
    for k, v in src.state_dict().items():
        assert torch.equal(res.model.state_dict()[k], v), k

    # an npz cache (the JAX package's flat layout) of other weights
    other = tzoo.init_random_(TUNet(_port_config(jcfg)), 12)
    params = jconvert.convert_state_dict(
        {k: v.numpy() for k, v in tconvert.to_guided_state_dict(other.state_dict()).items()})
    npz = tmp_path / "tiny_zoo_probe.flax.npz"
    jzoo.save_params_npz(params, str(npz))
    os.utime(pt, (1_000_000, 1_000_000))
    os.utime(npz, (2_000_000, 2_000_000))
    res = tzoo.resolve_model("tiny_zoo_probe", str(tmp_path), device="cpu")
    assert res.provenance == "cache"
    assert torch.equal(res.model.out_conv.weight, other.out_conv.weight)
    os.utime(pt, (3_000_000, 3_000_000))
    res = tzoo.resolve_model("tiny_zoo_probe", str(tmp_path), device="cpu")
    assert res.provenance == "checkpoint"
    assert torch.equal(res.model.out_conv.weight, src.out_conv.weight)
    # the JAX zoo reads the same files in the same order
    assert jzoo.resolve_model("tiny_zoo_probe", str(tmp_path)).provenance == "checkpoint"


def test_class_labels_are_required_exactly_with_num_classes():
    cond = TUNet(_port_config(CONFIGS["class_conditional"]))
    plain = TUNet(_port_config(jzoo.TINY_TEST_CONFIG))
    x, t = torch.zeros((1, 32, 32, 3)), torch.zeros((1,), dtype=torch.int32)
    with pytest.raises(ValueError, match="class labels"):
        cond(x, t)
    with pytest.raises(ValueError, match="class labels"):
        plain(x, t, torch.zeros((1,), dtype=torch.long))
