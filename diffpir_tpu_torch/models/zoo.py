"""Model zoo: UNet configurations by name, and weights for them.

Port of ``diffpir_tpu/models/zoo.py``.  Weights are looked for in the JAX
package's order (``diffpir_tpu/models/zoo.py:134-214``):

1. ``<model_zoo>/<name>.flax.npz``, the JAX package's converted cache, unless
   a newer ``<model_zoo>/<name>.pt`` sits beside it (provenance "cache");
2. ``<model_zoo>/<name>.pt``, a guided-diffusion checkpoint converted in
   memory by ``models.convert`` ("checkpoint");
3. ``assets/demo/<name>.flax.npz``, a repo-trained demo prior ("demo");
4. seeded random weights (``init_random_``), with a warning ("random").

The flat npz files are carried into a PyTorch state dict in memory by
``flax_to_torch``; ``torch_to_flax`` and ``save_params_npz`` write the same
layout back (the trainer's EMA export).  Unlike the JAX package, the port
writes no converted cache anywhere; both carry the variants of
``models/variants.py`` too.  ``init_train_`` is the JAX package's training
initialisation, matched in distribution.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Dict, NamedTuple

import numpy as np
import torch

from diffpir_tpu_torch import resolve_device
from diffpir_tpu_torch.models.convert import load_torch_checkpoint
from diffpir_tpu_torch.models.unet import UNet, UNetConfig

__all__ = ["MODEL_ZOO_CONFIGS", "TINY_TEST_CONFIG", "DEMO_HQ_CONFIG",
           "DEMO256_CONFIG", "TINY_GRAY_CONFIG", "model_config_for",
           "load_params_npz", "save_params_npz", "flax_to_torch", "torch_to_flax",
           "init_random_", "init_train_", "resolve_model", "ResolvedModel",
           "weights_path", "create_model_and_diffusion"]

log = logging.getLogger(__name__)

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Hard-coded per-checkpoint configs (reference ``main_ddpir.py:219-230``).
MODEL_ZOO_CONFIGS = {
    "diffusion_ffhq_10m": UNetConfig(
        model_channels=128, num_res_blocks=1, attention_resolutions=(16,), dropout=0.1
    ),
    "256x256_diffusion_uncond": UNetConfig(
        model_channels=256, num_res_blocks=2, attention_resolutions=(8, 16, 32), dropout=0.0
    ),
}

# Tiny fixture model for tests and smoke runs without checkpoints.
TINY_TEST_CONFIG = UNetConfig(
    image_size=64, model_channels=32, out_channels=6, num_res_blocks=1,
    attention_resolutions=(8,), channel_mult=(1, 1, 2, 2), num_heads=4,
    num_head_channels=16, dropout=0.0,
)

# Wider demo prior (~29M params) of the demo64 tasks.
DEMO_HQ_CONFIG = UNetConfig(
    image_size=64, model_channels=128, out_channels=6, num_res_blocks=2,
    attention_resolutions=(8,), channel_mult=(1, 2, 2), num_heads=4,
    num_head_channels=32, dropout=0.0,
)

# 256-px demo prior (~54M params): the ffhq flagship topology (6-level
# channel_mult, attention at ds16 and in the ds32 middle block, 64-channel
# heads) at 96 instead of 128 base channels.
DEMO256_CONFIG = UNetConfig(
    image_size=256, model_channels=96, out_channels=6, num_res_blocks=1,
    attention_resolutions=(16,), channel_mult=(1, 1, 2, 2, 4, 4), num_heads=4,
    num_head_channels=64, dropout=0.0,
)

TINY_GRAY_CONFIG = dataclasses.replace(TINY_TEST_CONFIG, in_channels=1,
                                       out_channels=2)

_DEMO_CONFIGS = {"demo64_hq": DEMO_HQ_CONFIG, "demo256": DEMO256_CONFIG,
                 "tiny_gray": TINY_GRAY_CONFIG}


def model_config_for(model_name: str) -> UNetConfig:
    if model_name in MODEL_ZOO_CONFIGS:
        return MODEL_ZOO_CONFIGS[model_name]
    if model_name in _DEMO_CONFIGS:
        return _DEMO_CONFIGS[model_name]
    for k, c in _DEMO_CONFIGS.items():
        # checkpoint variants of a demo architecture share its config
        if model_name.startswith(k):
            return c
    if model_name.startswith("tiny"):
        return TINY_TEST_CONFIG
    raise KeyError(f"unknown model {model_name!r}; known: "
                   f"{sorted(MODEL_ZOO_CONFIGS) + sorted(_DEMO_CONFIGS) + ['tiny*']}")


def load_params_npz(path: str) -> Dict[str, np.ndarray]:
    """Flat ``{"a/b/leaf": array}`` parameters of a JAX-package npz; float
    storage below fp32 (the demo priors ship fp16) is upcast to fp32."""
    with np.load(path) as z:
        flat = {}
        for k in z.files:
            v = z[k]
            if v.dtype.kind == "f" and v.dtype.itemsize < 4:
                v = v.astype(np.float32)
            flat[k] = v
        return flat


def flax_to_torch(flat_params: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """JAX-package parameters -> a state dict of the port's ``UNet``,
    ``SuperResUNet`` or ``EncoderUNet``.

    conv kernel HWIO -> weight OIHW; dense kernel (in, out) -> weight
    (out, in); GroupNorm scale and the class embedding's table -> weight;
    biases and the attention pool's (T+1, C) ``positional_embedding`` as they
    are.  Module paths keep their names, ``/`` becoming ``.``.
    """
    sd = {}
    for key, v in flat_params.items():
        *path, leaf = key.split("/")
        v = np.asarray(v, np.float32)
        if leaf == "kernel" and v.ndim == 4:
            v = v.transpose(3, 2, 0, 1)
        elif leaf == "kernel" and v.ndim == 2:
            v = v.T
        elif leaf not in ("scale", "bias", "embedding", "positional_embedding"):
            raise KeyError(f"unexpected parameter {key!r}")
        name = {"bias": "bias", "positional_embedding": leaf}.get(leaf, "weight")
        sd[".".join(path + [name])] = torch.from_numpy(np.ascontiguousarray(v))
    return sd


def torch_to_flax(state_dict: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The inverse of ``flax_to_torch``: a state dict of the port's ``UNet``
    -> flat ``{"a/b/leaf": fp32 array}`` parameters in the JAX package's
    layout (conv weight OIHW -> kernel HWIO, dense weight -> kernel (in,
    out), GroupNorm weight -> scale, ``label_emb`` weight -> embedding)."""
    flat = {}
    for key, v in state_dict.items():
        *path, name = key.split(".")
        v = np.array(v.detach().float().cpu(), copy=True)
        if name in ("bias", "positional_embedding"):
            leaf = name  # the attention pool's (T+1, C) embedding as it is
        elif path[-1] == "label_emb":
            leaf = "embedding"
        elif v.ndim == 4:
            leaf, v = "kernel", v.transpose(2, 3, 1, 0)
        elif v.ndim == 2:
            leaf, v = "kernel", v.T
        elif v.ndim == 1:
            leaf = "scale"
        else:
            raise KeyError(f"unexpected parameter {key!r} of shape {v.shape}")
        flat["/".join(path + [leaf])] = np.ascontiguousarray(v)
    return flat


def save_params_npz(flat_params: Dict[str, np.ndarray], path: str) -> None:
    """Write flat parameters as the JAX package's ``save_params_npz`` does
    (one array per ``"a/b/leaf"`` key), readable by both zoos."""
    np.savez(path, **flat_params)


# layers the JAX package zero-initialises for training
# (``diffpir_tpu/models/unet.py:158, 217, 264, 439``)
_ZERO_INIT = ("conv2", "proj", "out_conv")


def init_train_(model: UNet, seed: int) -> UNet:
    """The JAX package's training initialisation, matched in distribution:
    conv and dense weights lecun-normal (a normal truncated at two standard
    deviations, scaled to variance 1/fan_in), zero for each ResBlock's
    ``conv2``, each attention ``proj`` and ``out_conv``; biases 0; GroupNorm
    scale 1; the class embedding N(0, 1/features) as flax's ``Embed``."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in sorted(model.named_parameters()):
            *path, leaf = name.split(".")
            if leaf == "bias" or path[-1] in _ZERO_INIT:
                p.zero_()
            elif path[-1] == "label_emb":
                p.copy_(torch.randn(p.shape, generator=gen) / np.sqrt(p.shape[1]))
            elif p.ndim == 1:
                p.fill_(1.0)
            else:
                fan_in = int(np.prod(p.shape[1:]))
                std = np.sqrt(1.0 / fan_in) / 0.87962566103423978
                w = torch.empty(p.shape)
                torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
                p.copy_(w * std)
    return model


def init_random_(model: UNet, seed: int) -> UNet:
    """Seeded random weights: every conv and dense weight ~ N(0, 1/fan_in),
    biases 0, GroupNorm scale 1 and shift 0.  Unlike a training init, no
    layer is zero-initialised, so every layer reaches the output."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in sorted(model.named_parameters()):
            if name.endswith("bias"):
                p.zero_()
            elif p.ndim == 1:
                p.fill_(1.0)
            else:
                fan_in = int(np.prod(p.shape[1:]))
                w = torch.randn(p.shape, generator=gen) / np.sqrt(fan_in)
                p.copy_(w)
    return model


_DEMO_DIR = os.path.join(_REPO, "assets", "demo")


def weights_path(model_name: str, model_zoo: str = "model_zoo"):
    """The file ``resolve_model`` loads ``model_name``'s weights from, or
    None for random weights: ``<model_zoo>/<name>.flax.npz`` unless a newer
    ``<model_zoo>/<name>.pt`` sits beside it, then the ``.pt``, then the demo
    prior under ``assets/demo`` (``diffpir_tpu/models/zoo.py:134``)."""
    npz_path = os.path.join(model_zoo, f"{model_name}.flax.npz")
    pt_path = os.path.join(model_zoo, f"{model_name}.pt")
    # the cache holds only while it is at least as new as the checkpoint
    if os.path.exists(npz_path) and not (
            os.path.exists(pt_path)
            and os.path.getmtime(pt_path) > os.path.getmtime(npz_path)):
        return npz_path
    if os.path.exists(pt_path):
        return pt_path
    demo_path = os.path.join(_DEMO_DIR, f"{model_name}.flax.npz")
    return demo_path if os.path.exists(demo_path) else None


class ResolvedModel(NamedTuple):
    """The model, ready on its device, and where its weights came from:
    "cache" (``<model_zoo>/<name>.flax.npz``), "checkpoint"
    (``<model_zoo>/<name>.pt``), "demo" (a prior under ``assets/demo``) or
    "random"."""

    model: UNet
    provenance: str


def resolve_model(model_name: str, model_zoo: str = "model_zoo", *,
                  dtype: torch.dtype = torch.float32,
                  device: torch.device | str | None = None, kernels: str = "cuda",
                  init_seed: int = 0) -> ResolvedModel:
    """The model ``model_name`` with its weights, on ``device``: by default
    the current CUDA card (raises when there is none); the CPU only when
    ``device="cpu"`` is asked for.  Its parameters are frozen
    (``requires_grad`` off), so a gradient taken through it (DPS_y0) tracks
    activations only."""
    if device is None:
        device = resolve_device(cpu=False)
    cfg = model_config_for(model_name)
    model = UNet(cfg, dtype=dtype, kernels=kernels)
    path = weights_path(model_name, model_zoo)
    if path is not None and path.endswith(".pt"):
        model.load_state_dict(load_torch_checkpoint(path))
        provenance = "checkpoint"
    elif path is not None:
        model.load_state_dict(flax_to_torch(load_params_npz(path)))
        provenance = ("demo" if path == os.path.join(_DEMO_DIR, f"{model_name}.flax.npz")
                      else "cache")
    else:
        log.warning("no weights for %r under %s or assets/demo — using RANDOM "
                    "weights (restorations will be meaningless)", model_name,
                    model_zoo)
        init_random_(model, init_seed)
        provenance = "random"
    return ResolvedModel(model.to(device).eval().requires_grad_(False), provenance)


def create_model_and_diffusion(model_name: str, model_zoo: str = "model_zoo", *,
                               num_timesteps: int = 1000,
                               noise_schedule: str = "linear",
                               timestep_respacing=None,
                               dtype: torch.dtype = torch.float32,
                               device: torch.device | str | None = None,
                               kernels: str = "cuda"):
    """(model, Diffusion, timestep_map): the counterpart of the JAX package's
    factory (``diffpir_tpu/models/zoo.py:233``; reference
    ``script_util.create_model_and_diffusion``), whose (module, params) pair
    is one module here.  ``timestep_respacing``: None, "ddimN" or section
    counts (``schedule.space_timesteps``); learned-range epsilon diffusion,
    as the published checkpoints."""
    from diffpir_tpu_torch.diffusion import Diffusion, ModelMeanType, ModelVarType
    from diffpir_tpu_torch.schedule import NoiseSchedule, space_timesteps

    model, _prov = resolve_model(model_name, model_zoo, dtype=dtype, device=device,
                                 kernels=kernels)
    sched = NoiseSchedule.named(noise_schedule, num_timesteps)
    timestep_map = None
    if timestep_respacing:
        keep = space_timesteps(num_timesteps, timestep_respacing)
        sched, timestep_map = sched.respaced(sorted(keep))
    diffusion = Diffusion(sched, ModelMeanType.EPSILON, ModelVarType.LEARNED_RANGE)
    return model, diffusion, timestep_map
