"""UNet variants: super-resolution conditioning and the classifier half.

Port of ``diffpir_tpu/models/variants.py`` (reference ``guided_diffusion/
unet.py``):

* ``SuperResUNet`` == ``SuperResModel`` (``unet.py:666-680``): the low-res
  image, resized bilinearly to x's size as ``jax.image.resize`` does, is
  concatenated to x on channels (``cfg.in_channels`` is twice the image's).
* ``EncoderUNet`` == ``EncoderUNetModel`` (``unet.py:683-894``): the
  downsampling half and the middle block with a pooling head, the noisy
  classifier of classifier guidance.  Heads: ``attention`` (``AttentionPool2d``),
  ``adaptive`` (GroupNorm, SiLU, global mean, a dense layer), ``spatial`` and
  ``spatial_v2`` (the spatial mean after every input block, downsamples
  included, and after the middle block, through an MLP).
* ``AttentionPool2d`` (``unet.py:22-51``): a mean token prepended, a learned
  positional embedding, one "new order" ([q|k|v][head][ch]) attention pass in
  einsums with an fp32 softmax, the first token projected out.

Both are built from the UNet's own ``ResBlock``, ``AttentionBlock`` and
``GroupNorm32``, so on a CUDA tensor every GroupNorm and every legacy-layout
attention launches the port's CUDA kernels (inside their
``autograd.Function`` when a gradient is asked for, as classifier guidance
does).  Module names are the JAX package's, so ``models.zoo.flax_to_torch``
and ``models.convert`` carry weights across by name.  The heads' dense
layers and the positional embedding are fp32, as the JAX package's
``param_dtype``; the heads other than ``attention`` compute in fp32.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from diffpir_tpu_torch.models.unet import (AttentionBlock, Conv, Dense, GroupNorm32,
                                           Resample, ResBlock, UNet, UNetConfig,
                                           _avgpool2x, _check_route,
                                           timestep_embedding)
from diffpir_tpu_torch.ops.resize import bilinear_resize

__all__ = ["SuperResUNet", "EncoderUNet", "AttentionPool2d", "POOLS"]

POOLS = ("attention", "adaptive", "spatial", "spatial_v2")


class AttentionPool2d(nn.Module):
    """CLIP-style attention pooling of (B, H, W, C) to (B, output_dim)."""

    def __init__(self, tokens: int, channels: int, num_head_channels: int,
                 output_dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        if channels % num_head_channels:
            raise ValueError(f"{channels} channels do not split into heads of "
                             f"{num_head_channels}")
        self.num_head_channels = num_head_channels
        self.dtype = dtype
        self.positional_embedding = nn.Parameter(
            torch.randn(tokens + 1, channels) / channels ** 0.5)
        self.qkv_proj = Dense(channels, 3 * channels)
        self.c_proj = Dense(channels, output_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        t = h * w
        xs = x.reshape(b, t, c)
        xs = torch.cat([xs.mean(dim=1, keepdim=True), xs], dim=1)
        xs = xs + self.positional_embedding[None].to(xs.dtype)
        qkv = self.qkv_proj(xs.to(self.dtype))
        heads, ch = c // self.num_head_channels, self.num_head_channels
        q, k, v = (u.reshape(b, t + 1, heads, ch) for u in qkv.chunk(3, dim=-1))
        scale = 1.0 / math.sqrt(math.sqrt(ch))
        logits = torch.einsum("bthc,bshc->bhts", q * scale, k * scale)
        wgt = torch.softmax(logits.float(), dim=-1).to(v.dtype)
        out = torch.einsum("bhts,bshc->bthc", wgt, v).reshape(b, t + 1, c)
        return self.c_proj(out)[:, 0]


class SuperResUNet(nn.Module):
    """UNet conditioned on an upsampled low-resolution image;
    ``cfg.in_channels`` is twice the image's channels.  The UNet is the
    submodule ``unet`` (parameters ``unet.*``, the JAX package's ``unet/``)."""

    def __init__(self, cfg: UNetConfig, dtype: torch.dtype = torch.float32,
                 kernels: str = "cuda", param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.unet = UNet(cfg, dtype=dtype, kernels=kernels, param_dtype=param_dtype)

    def forward(self, x: torch.Tensor, t: torch.Tensor, low_res: torch.Tensor,
                y: Optional[torch.Tensor] = None) -> torch.Tensor:
        upsampled = bilinear_resize(low_res, tuple(x.shape[1:3]))
        return self.unet(torch.cat([x, upsampled.to(x.dtype)], dim=-1), t, y)


class EncoderUNet(nn.Module):
    """The downsampling half of the UNet with a pooled classification head.

    forward(x: (B,H,W,C), t: (B,) timesteps) -> (B, cfg.out_channels) logits,
    in the compute dtype (``attention``) or fp32 (the other heads).
    """

    def __init__(self, cfg: UNetConfig, pool: str = "adaptive",
                 dtype: torch.dtype = torch.float32, kernels: str = "cuda",
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        if pool not in POOLS:
            raise ValueError(f"pool must be one of {POOLS}, got {pool!r}")
        self.cfg, self.pool, self.dtype = cfg, pool, dtype
        self.kernels = _check_route(kernels)
        mc = cfg.model_channels
        time_dim = mc * 4
        self.time_embed_0 = Dense(mc, time_dim)
        self.time_embed_2 = Dense(time_dim, time_dim)

        def res(name, cin, cout, **kw):
            setattr(self, name, ResBlock(
                cin, cout, time_dim, use_scale_shift_norm=cfg.use_scale_shift_norm,
                kernels=kernels, **kw))
            return name

        ch = int(cfg.channel_mult[0] * mc)
        self.input_blocks_0_0 = Conv(cfg.in_channels, ch)
        self._inputs: list[list[str]] = [["input_blocks_0_0"]]
        pooled = [ch]   # channels of each spatial mean the spatial heads take
        ds, idx = 1, 1
        for level, mult in enumerate(cfg.channel_mult):
            for _ in range(cfg.num_res_blocks):
                cout = int(mult * mc)
                names = [res(f"input_blocks_{idx}_0", ch, cout)]
                ch = cout
                if ds in cfg.attention_resolutions:
                    name = f"input_blocks_{idx}_1"
                    setattr(self, name, AttentionBlock(ch, cfg.heads_for(ch), kernels))
                    names.append(name)
                self._inputs.append(names)
                pooled.append(ch)
                idx += 1
            if level != len(cfg.channel_mult) - 1:
                # the UNet's downsample families (diffpir_tpu/models/unet.py:352-360)
                name = f"input_blocks_{idx}_0"
                if cfg.resblock_updown:
                    res(name, ch, ch, down=True)
                else:
                    setattr(self, name, Conv(ch, ch, 3, stride=2) if cfg.conv_resample
                            else Resample(_avgpool2x))
                self._inputs.append([name])
                pooled.append(ch)
                ds *= 2
                idx += 1
        self._middle = [res("middle_block_0", ch, ch), "middle_block_1",
                        res("middle_block_2", ch, ch)]
        self.middle_block_1 = AttentionBlock(ch, cfg.heads_for(ch), kernels)
        pooled.append(ch)

        heads = []
        if pool == "attention":
            self.out_norm = GroupNorm32(ch, fuse_silu=True, kernels=kernels)
            side = cfg.image_size // ds
            self.out_pool = AttentionPool2d(side * side, ch, cfg.num_head_channels,
                                            cfg.out_channels, dtype)
        elif pool == "adaptive":
            self.out_norm = GroupNorm32(ch, kernels=kernels)
            self.out_conv = Dense(ch, cfg.out_channels)
            heads = [self.out_conv]
        elif pool == "spatial_v2":
            self.out_0 = Dense(sum(pooled), 2048)
            self.out_norm = GroupNorm32(2048, kernels=kernels)
            self.out_3 = Dense(2048, cfg.out_channels)
            heads = [self.out_0, self.out_3]
        else:
            self.out_0 = Dense(sum(pooled), 2048)
            self.out_2 = Dense(2048, cfg.out_channels)
            heads = [self.out_0, self.out_2]
        for m in self.modules():
            if isinstance(m, (Conv, nn.Linear)) and not any(m is h for h in heads):
                m.to(dtype if param_dtype is None else param_dtype)

    def forward(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        spatial = self.pool.startswith("spatial")
        emb = timestep_embedding(t, self.cfg.model_channels).to(self.dtype)
        emb = self.time_embed_2(F.silu(self.time_embed_0(emb)))
        h = x.to(self.dtype)
        results = []
        for names in self._inputs:
            for name in names:
                layer = getattr(self, name)
                h = layer(h, emb) if isinstance(layer, ResBlock) else layer(h)
            if spatial:
                results.append(h.mean(dim=(1, 2)))
        for name in self._middle:
            layer = getattr(self, name)
            h = layer(h, emb) if isinstance(layer, ResBlock) else layer(h)

        if self.pool == "attention":
            return self.out_pool(self.out_norm(h.float()))
        if self.pool == "adaptive":
            h = F.silu(self.out_norm(h.float()))
            return self.out_conv(h.mean(dim=(1, 2)))
        results.append(h.float().mean(dim=(1, 2)))
        feats = torch.cat([r.float() for r in results], dim=-1)
        if self.pool == "spatial_v2":
            feats = self.out_norm(self.out_0(feats)[:, None, None, :].contiguous())
            return self.out_3(F.silu(feats[:, 0, 0, :]))
        return self.out_2(torch.relu(self.out_0(feats)))
