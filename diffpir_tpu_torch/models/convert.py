"""Guided-diffusion ``.pt`` checkpoints onto the port's ``UNet``.

Port of ``diffpir_tpu/models/convert.py`` for the diffusion UNet.  The
published DiffPIR checkpoints (``diffusion_ffhq_10m.pt``,
``256x256_diffusion_uncond.pt``; ``model_zoo/README.md``) are raw state dicts
of guided-diffusion's ``UNetModel``.  ``convert_state_dict`` maps them key by
key onto the port's module names (``input_blocks.{i}.{j}`` ->
``input_blocks_{i}_{j}``, ``in_layers.0`` -> ``norm1``, ...), which are the
JAX package's names too.  Both sides are PyTorch, so weights keep their
layout except the attention's ``qkv`` and ``proj_out``: guided-diffusion
stores them as Conv1d ``(O, I, 1)``, the port as Linear ``(O, I)``.  The
legacy [head][q|k|v][ch] channel order of ``qkv`` is kept as it is, which is
the order ``kernels.attention`` reads.  A key that maps nowhere raises.

The classifier's output heads (``EncoderUNetModel``, reference
``unet.py:822-853``; ``diffpir_tpu/models/convert.py:88-127``) map onto
``models.variants.EncoderUNet``: the attention pool's ``out.2.*`` (the
positional embedding stored (C, T+1) becomes (T+1, C), ``qkv_proj`` and
``c_proj`` Conv1d become Linear), the adaptive head's 1x1 ``out.3`` conv
becomes a Linear, and the spatial heads' Linears ``out.{0,2,3}`` and
spatial_v2's GroupNorm ``out.1`` keep their layout; a spatial head is told
apart by ``out.0.weight`` being 2-D.  ``SuperResModel``'s keys are the
UNet's; ``prefix="unet."`` places them under ``SuperResUNet.unet``.

``to_guided_state_dict`` is the inverse (round trips in the tests and the
smoke).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

__all__ = ["convert_state_dict", "load_torch_checkpoint", "to_guided_state_dict"]

# guided-diffusion sub-path -> the port's submodule (None: the block's own
# weight, a resampling conv without a ResBlock: Downsample `.op`, Upsample
# `.conv`, reference unet.py:98,131)
_RESBLOCK_MAP = {
    ("in_layers", "0"): "norm1",
    ("in_layers", "2"): "conv1",
    ("emb_layers", "1"): "emb_proj",
    ("out_layers", "0"): "norm2",
    ("out_layers", "3"): "conv2",
    ("skip_connection",): "skip",
}
_ATTN_MAP = {
    ("norm",): "norm",
    ("qkv",): "qkv",
    ("proj_out",): "proj",
}
_SAMPLER_MAP = {("op",): None, ("conv",): None}
_CONV1D = ("qkv", "proj", "qkv_proj", "c_proj")
_LEAVES = ("weight", "bias")


def _tensor(v) -> torch.Tensor:
    if not torch.is_tensor(v):
        v = torch.from_numpy(np.array(v, np.float32))  # a writable copy
    return v.detach().float()


def _block(parts: list[str]) -> tuple[str, tuple[str, ...]]:
    """(port module name, remaining sub-path) of a block key's parts."""
    if parts[0] == "middle_block":
        return f"middle_block_{parts[1]}", tuple(parts[2:-1])
    return f"{parts[0]}_{parts[1]}_{parts[2]}", tuple(parts[3:-1])


def _out_head(parts: list[str], spatial: bool) -> str | None:
    """The port's name of an ``out.*`` key, for every head family: the
    diffusion UNet (0 GroupNorm, 2 conv), the classifier's attention pool
    (0 GroupNorm, 2 ``AttentionPool2d``), adaptive (0 GroupNorm, 3 1x1
    conv), spatial (0, 2 Linear) and spatial_v2 (0 Linear, 1 GroupNorm, 3
    Linear)."""
    leaf = parts[-1]
    if len(parts) == 3 and parts[1] == "2" and leaf == "positional_embedding":
        return "out_pool.positional_embedding"
    if leaf not in _LEAVES:
        return None
    if len(parts) == 4 and parts[1] == "2" and parts[2] in ("qkv_proj", "c_proj"):
        return f"out_pool.{parts[2]}.{leaf}"
    if len(parts) != 3:
        return None
    if spatial:
        if parts[1] in ("0", "2", "3"):
            return f"out_{parts[1]}.{leaf}"
        return f"out_norm.{leaf}" if parts[1] == "1" else None
    if parts[1] == "0":
        return f"out_norm.{leaf}"
    return f"out_conv.{leaf}" if parts[1] in ("2", "3") else None


def convert_state_dict(state_dict: Mapping[str, object],
                       prefix: str = "") -> Dict[str, torch.Tensor]:
    """A guided-diffusion ``UNetModel``, ``SuperResModel`` or
    ``EncoderUNetModel`` state dict (tensors or numpy arrays) -> a state dict
    of the port's ``UNet`` or ``EncoderUNet`` (``SuperResUNet`` with
    ``prefix="unet."``), fp32."""
    out: Dict[str, torch.Tensor] = {}
    unmapped = []
    spatial = "out.0.weight" in state_dict and np.ndim(state_dict["out.0.weight"]) == 2
    for key, value in state_dict.items():
        parts = key.split(".")
        leaf, head = parts[-1], parts[0]
        name = None
        if head == "out":
            name = _out_head(parts, spatial)
        elif leaf not in _LEAVES:
            pass
        elif head == "time_embed" and len(parts) == 3:
            name = f"time_embed_{parts[1]}.{leaf}"
        elif head == "label_emb" and len(parts) == 2:
            name = f"label_emb.{leaf}"
        elif head in ("input_blocks", "output_blocks", "middle_block") and len(parts) >= 3:
            module, rest = _block(parts)
            if not rest and head == "input_blocks":
                name = f"{module}.{leaf}"  # the input stem, a bare conv
            for table in (_RESBLOCK_MAP, _ATTN_MAP, _SAMPLER_MAP):
                if rest in table:
                    sub = table[rest]
                    name = f"{module}.{sub}.{leaf}" if sub else f"{module}.{leaf}"
                    break
        if name is None:
            unmapped.append(key)
            continue
        t = _tensor(value)
        if leaf == "weight" and t.ndim == 3 and name.split(".")[-2] in _CONV1D:
            t = t[:, :, 0]  # Conv1d (O, I, 1) -> Linear (O, I)
        elif leaf == "weight" and key.startswith("out.3.") and t.ndim == 4:
            t = t[:, :, 0, 0]  # the adaptive head's 1x1 conv -> Linear
        elif leaf == "positional_embedding":
            t = t.T  # (C, T+1) -> (T+1, C)
        out[prefix + name] = t.contiguous()
    if unmapped:
        raise ValueError(f"unmapped checkpoint keys: {unmapped[:10]}"
                         f" (+{max(0, len(unmapped) - 10)} more)")
    return out


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """Read a guided-diffusion ``.pt`` state dict (tensors only:
    ``weights_only=True``) and convert it for the port's ``UNet``."""
    return convert_state_dict(torch.load(path, map_location="cpu", weights_only=True))


_INVERSE = {sub: rest for table in (_RESBLOCK_MAP, _ATTN_MAP) for rest, sub in table.items()}


def to_guided_state_dict(state_dict: Mapping[str, torch.Tensor],
                         prefix: str = "") -> Dict[str, torch.Tensor]:
    """The port's ``UNet``, ``EncoderUNet`` or (``prefix="unet."``)
    ``SuperResUNet`` state dict -> guided-diffusion's layout (the inverse of
    ``convert_state_dict``), fp32 on the CPU."""
    out: Dict[str, torch.Tensor] = {}
    spatial_v2 = f"{prefix}out_3.weight" in state_dict
    adaptive = (f"{prefix}out_conv.weight" in state_dict
                and state_dict[f"{prefix}out_conv.weight"].ndim == 2)
    for key, value in state_dict.items():
        if not key.startswith(prefix):
            raise ValueError(f"{key!r} does not start with {prefix!r}")
        *path, leaf = key[len(prefix):].split(".")
        t = value.detach().float().cpu().contiguous()
        module = path[0]
        if module.startswith("time_embed_"):
            name = f"time_embed.{module.rsplit('_', 1)[1]}"
        elif module == "out_pool":
            name = "out.2" if len(path) == 1 else f"out.2.{path[1]}"
            if leaf == "positional_embedding":
                t = t.T.contiguous()  # (T+1, C) -> (C, T+1)
            elif leaf == "weight":
                t = t[:, :, None]  # Linear (O, I) -> Conv1d (O, I, 1)
        elif module == "out_conv" and adaptive:
            name = "out.3"  # the adaptive head's Linear -> 1x1 conv
            if leaf == "weight":
                t = t[:, :, None, None]
        elif module in ("out_0", "out_2", "out_3"):
            name = f"out.{module[-1]}"
        elif module in ("label_emb", "out_norm", "out_conv"):
            name = {"label_emb": "label_emb", "out_norm": "out.1" if spatial_v2 else "out.0",
                    "out_conv": "out.2"}[module]
        else:
            if module.startswith("middle_block_"):
                name = "middle_block." + module.rsplit("_", 1)[1]
            else:
                head, i, j = module.rsplit("_", 2)
                name = f"{head}.{i}.{j}"
            if len(path) == 2:
                name += "." + ".".join(_INVERSE[path[1]])
                if path[1] in _CONV1D and leaf == "weight":
                    t = t[:, :, None]  # Linear (O, I) -> Conv1d (O, I, 1)
            elif module != "input_blocks_0_0":
                # a resampling conv without a ResBlock: Downsample keeps it
                # as `.op`, Upsample as `.conv`
                name += ".op" if module.startswith("input_blocks") else ".conv"
        out[f"{name}.{leaf}"] = t
    return out
