"""The guided-diffusion UNet in PyTorch, NHWC at every block boundary.

Port of ``diffpir_tpu/models/unet.py`` (reference
``guided_diffusion/unet.py:396-663``).  Module names follow the JAX package's
block names (``input_blocks_{i}_{j}``, ``middle_block_{k}``,
``output_blocks_{i}_{j}``, ``norm1/conv1/emb_proj/norm2/conv2/skip``,
``norm/qkv/proj``), so ``models.zoo.flax_to_torch`` maps its weights by name.
Numerics carried over:

* GroupNorm statistics in fp32, eps 1e-5; fp32 activations take the two-pass
  centred variance, bf16 the one-pass form clamped at 0 (``kernels.groupnorm``).
* FiLM ``h = norm(h) * (1 + scale) + shift`` with scale the FIRST half of the
  projection; ``emb_out`` is cast to the activation type first.
* Legacy QKV attention, layout [head][q|k|v][ch], q and k both scaled by
  ch^-1/4, softmax in fp32 (``kernels.attention``).
* Sinusoidal timestep embedding with cos first.
* The output head runs in the compute dtype.
* Convolution and dense weights are cast to the activation's type at each
  call, as flax's ``param_dtype=float32`` does, so fp32 master weights train
  a bf16 model; weights stored in the compute dtype make that cast a no-op.
* ``UNetConfig.use_remat`` recomputes each ResBlock and AttentionBlock in the
  backward pass (``torch.utils.checkpoint``, as the JAX package's
  ``nn.remat``); parameter names do not change.

Under a device mesh (``parallel/``) the same modules run sharded, and without
one they run exactly as before.  Tensor parallelism (``model`` axis,
``parallel/tp.py::shard_unet_params``): a sharded ResBlock makes C/n
channels in ``conv1``, normalises them with G/n groups, takes its channels
of the all-reduced FiLM vector, and all-reduces ``conv2``'s partial sums
before the bias; a sharded attention block runs heads/n heads and
all-reduces ``proj``.  Spatial parallelism (``space`` axis, ``UNet.set_mesh``):
the UNet keeps its rank's rows of the image height; every 3x3 convolution
first fetches its halo rows; GroupNorm merges its statistics over the axis;
attention gathers the tokens, runs on all of them and keeps its rows; the
output rows are gathered at the end.  Resampling stays local.  The row
slices are ``axis_block`` and every collective carries a gradient
(``parallel/collectives.py``), so DPS_y0 differentiates through a sharded
UNet; a replicated activation entering a layer that splits its output (a
column-parallel conv, the heads' qkv, the sharded GroupNorm's merged
statistics) goes through ``grad_all_reduce``.

Activations are (B, H, W, C) tensors, contiguous in that order, which is what
the GroupNorm and attention kernels take.  A convolution hands cuDNN the
NCHW view of the same memory (``channels_last``) with a ``channels_last``
weight, so no layout copy is made.  ``kernels="cuda"`` (the default) routes
every GroupNorm and attention through ``diffpir_tpu_torch.kernels``, which
launch the CUDA kernels for tensors on the card and run their plain versions
on the CPU; ``kernels="plain"`` calls the plain versions on any device, for
comparing the two on the card.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from diffpir_tpu_torch.kernels import groupnorm as _gn
from diffpir_tpu_torch.kernels.attention import (legacy_qkv_attention,
                                                 legacy_qkv_attention_plain)
from diffpir_tpu_torch.kernels.groupnorm import (groupnorm_silu,
                                                 groupnorm_silu_plain)
from diffpir_tpu_torch.parallel import collectives as _coll

__all__ = ["UNetConfig", "UNet", "GroupNorm32", "Conv", "Dense", "ResBlock",
           "AttentionBlock", "timestep_embedding", "KERNEL_ROUTES"]

KERNEL_ROUTES = ("cuda", "plain")


def timestep_embedding(t: torch.Tensor, dim: int,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal embeddings, [cos|sin] concat order (reference ``nn.py:103-121``)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


def _check_route(kernels: str) -> str:
    if kernels not in KERNEL_ROUTES:
        raise ValueError(f"kernels must be one of {KERNEL_ROUTES}, got {kernels!r}")
    return kernels


class GroupNorm32(nn.Module):
    """GroupNorm(32) in fp32 whatever the activation type, with optional FiLM
    and SiLU (reference ``nn.py:17-19, 93-100``)."""

    def __init__(self, channels: int, fuse_silu: bool = False,
                 kernels: str = "cuda", num_groups: int = 32):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.fuse_silu = fuse_silu
        self.num_groups = num_groups
        self.kernels = _check_route(kernels)
        self.space = None   # a mesh whose "space" axis splits the image height

    def forward(self, x: torch.Tensor,
                film: Optional[tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
        fs = fb = None
        if film is not None:
            fs, fb = (f.float().contiguous() for f in film)
        x = x.contiguous()
        cuda = self.kernels == "cuda"
        if self.space is not None:
            # the statistics span the shards: partial sums here, merged in
            # rank order over the axis, then the normalisation
            partial = (_gn.groupnorm_partial_stats if cuda
                       else _gn.groupnorm_partial_stats_plain)(x, self.num_groups)
            parts = _coll.all_gather(partial[None], self.space, "space")
            stats = _gn.merge_partial_stats(parts, x.dtype == torch.bfloat16)
            # every rank holds the merged statistics whole, and each rank's
            # rows add their share to the statistics' gradient
            stats = _coll.grad_all_reduce(stats, self.space, "space")
            apply = _gn.groupnorm_apply_stats if cuda else _gn.groupnorm_apply_stats_plain
            return apply(x, self.weight, self.bias, stats, fs, fb, do_silu=self.fuse_silu)
        fn = groupnorm_silu if cuda else groupnorm_silu_plain
        return fn(x, self.weight, self.bias, fs, fb,
                  num_groups=self.num_groups, do_silu=self.fuse_silu)


class Conv(nn.Module):
    """2-D convolution on NHWC activations (weight OIHW, stored channels_last)."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1):
        super().__init__()
        w = torch.empty(cout, cin, kernel, kernel)
        self.weight = nn.Parameter(w.contiguous(memory_format=torch.channels_last))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.stride = stride
        self.padding = kernel // 2
        self.space = None   # a mesh whose "space" axis splits the image height

    def forward(self, x: torch.Tensor, bias: bool = True) -> torch.Tensor:
        """``bias=False`` leaves the bias out (a row-parallel partial sum)."""
        b = self.bias.to(x.dtype) if bias else None
        k, pad = self.weight.shape[2], self.padding
        if self.space is not None and k > 1:
            # the rows this rank's outputs read from its neighbours' shards:
            # pad above, and below what the last window reaches past the shard
            below = max(0, k - 1 - pad - (self.stride - 1))
            x = _coll.halo_rows(x, self.space, "space", pad, below)
            y = F.conv2d(x.permute(0, 3, 1, 2), self.weight.to(x.dtype), b,
                         self.stride, (0, pad))
        else:
            y = F.conv2d(x.permute(0, 3, 1, 2), self.weight.to(x.dtype), b,
                         self.stride, pad)
        return y.permute(0, 2, 3, 1).contiguous()


class Dense(nn.Linear):
    """``nn.Linear`` whose weights are cast to the input's type at each call."""

    def forward(self, x: torch.Tensor, bias: bool = True) -> torch.Tensor:
        """``bias=False`` leaves the bias out (a row-parallel partial sum)."""
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype) if bias else None)


def _row_parallel(layer, x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """A row-parallel layer: this rank's partial product, the sum over the
    axis, then the bias once."""
    y = _coll.all_reduce_sum(layer(x, bias=False), mesh, axis)
    return y + layer.bias.to(y.dtype)


def _upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsampling (reference ``unet.py:100-110``)."""
    b, h, w, c = x.shape
    x = x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c)
    return x.reshape(b, h * 2, w * 2, c)


def _avgpool2x(x: torch.Tensor) -> torch.Tensor:
    b, h, w, c = x.shape
    return x.reshape(b, h // 2, 2, w // 2, 2, c).mean(dim=(2, 4))


class Upsample(Conv):
    """Nearest 2x then a 3x3 conv: the up step of ``resblock_updown=False``
    (reference ``unet.py:83-110``; its stride-2 down step is a ``Conv``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(_upsample2x(x))


class Resample(nn.Module):
    """A resampling step without weights (``conv_resample=False``)."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fn(x)


class ResBlock(nn.Module):
    """Residual block with FiLM conditioning and optional up/down sampling
    (reference ``unet.py:143-256``)."""

    def __init__(self, cin: int, cout: int, emb_dim: int, *,
                 use_scale_shift_norm: bool = True, up: bool = False,
                 down: bool = False, kernels: str = "cuda"):
        super().__init__()
        self.up, self.down = up, down
        self.use_scale_shift_norm = use_scale_shift_norm
        self.norm1 = GroupNorm32(cin, fuse_silu=True, kernels=kernels)
        self.conv1 = Conv(cin, cout)
        self.emb_proj = Dense(emb_dim, 2 * cout if use_scale_shift_norm else cout)
        self.norm2 = GroupNorm32(cout, fuse_silu=True, kernels=kernels)
        self.conv2 = Conv(cout, cout)
        self.skip = Conv(cin, cout, 1) if cin != cout else None
        self.tp = None            # (mesh, axis) once parallel/tp.py shards the block
        self.emb_sharded = False

    def set_tensor_parallel(self, mesh, axis: str, emb_sharded: bool) -> None:
        """Run as this rank's shard over ``axis`` (``parallel/tp.py`` has
        sliced the parameters): C/n channels from ``conv1``, G/n groups."""
        self.tp = (mesh, axis)
        self.emb_sharded = emb_sharded
        self.norm2.num_groups = 32 // mesh.axis_size(axis)

    def _film(self, emb: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """The FiLM vector; under tensor parallelism this rank's channels of
        each half of the full (B, 2C) vector (or of the full (B, C))."""
        e = F.silu(emb)
        if self.tp is None:
            return self.emb_proj(e).to(dtype)
        mesh, axis = self.tp
        if self.emb_sharded:
            full = _row_parallel(self.emb_proj, _coll.axis_block(e, mesh, axis), mesh, axis)
        else:
            full = self.emb_proj(e)
        full = full.to(dtype)
        halves = full.chunk(2, dim=-1) if self.use_scale_shift_norm else (full,)
        return torch.cat([_coll.axis_block(v, mesh, axis) for v in halves], dim=-1)

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        h = self.norm1(x)
        if self.up:
            h, x = _upsample2x(h), _upsample2x(x)
        elif self.down:
            h, x = _avgpool2x(h), _avgpool2x(x)
        if self.tp is not None:
            # a column-parallel conv: each rank's channels add their share to
            # the replicated input's gradient
            h = _coll.grad_all_reduce(h, *self.tp)
        h = self.conv1(h)
        emb_out = self._film(emb, h.dtype)
        if self.use_scale_shift_norm:
            scale, shift = emb_out.chunk(2, dim=-1)
            h = self.norm2(h, film=(scale, shift))
        else:
            h = self.norm2(h + emb_out[:, None, None, :])
        h = self.conv2(h) if self.tp is None else _row_parallel(self.conv2, h, *self.tp)
        if self.skip is not None:
            x = self.skip(x)
        return x + h


class AttentionBlock(nn.Module):
    """Global self-attention over spatial positions (reference ``unet.py:259-305``)."""

    def __init__(self, channels: int, num_heads: int, kernels: str = "cuda"):
        super().__init__()
        self.num_heads = num_heads
        self.kernels = _check_route(kernels)
        self.norm = GroupNorm32(channels, kernels=kernels)
        self.qkv = Dense(channels, 3 * channels)
        self.proj = Dense(channels, channels)
        self.tp = None      # (mesh, axis) once parallel/tp.py shards the heads
        self.space = None   # a mesh whose "space" axis splits the image height

    def set_tensor_parallel(self, mesh, axis: str, emb_sharded: bool = False) -> None:
        """Run heads/n heads as this rank's shard over ``axis``."""
        self.tp = (mesh, axis)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, hh, ww, c = x.shape
        h = self.norm(x).reshape(b, hh * ww, c)
        if self.tp is not None:
            h = _coll.grad_all_reduce(h, *self.tp)   # heads split: column-parallel
        qkv = self.qkv(h).contiguous()
        heads = self.num_heads
        if self.tp is not None:
            heads //= self.tp[0].axis_size(self.tp[1])
        if self.space is not None:
            # tokens are H-major, so the shards are contiguous token blocks:
            # attend over all of them and keep this rank's query rows
            qkv = _coll.all_gather(qkv, self.space, "space", dim=1)
        attn = (legacy_qkv_attention if self.kernels == "cuda"
                else legacy_qkv_attention_plain)
        a = attn(qkv, heads)
        if self.space is not None:
            a = _coll.axis_block(a, self.space, "space", dim=1).contiguous()
        a = self.proj(a) if self.tp is None else _row_parallel(self.proj, a, *self.tp)
        return x + a.reshape(b, hh, ww, c)


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    """Static architecture description (reference ``script_util.py:130-185`` defaults)."""

    image_size: int = 256
    in_channels: int = 3
    model_channels: int = 128
    out_channels: int = 6              # learn_sigma=True -> 6 (eps + var)
    num_res_blocks: int = 1
    attention_resolutions: Tuple[int, ...] = (16,)   # downsample rates with attention
    channel_mult: Tuple[int, ...] = (1, 1, 2, 2, 4, 4)
    num_heads: int = 4
    num_head_channels: int = 64
    num_classes: Optional[int] = None
    dropout: float = 0.0
    use_scale_shift_norm: bool = True
    resblock_updown: bool = True
    conv_resample: bool = True
    # recompute each ResBlock and AttentionBlock in the backward pass
    # (reference ``use_checkpoint``, ``guided_diffusion/unet.py:154-162``)
    use_remat: bool = False

    def heads_for(self, ch: int) -> int:
        if self.num_head_channels == -1:
            return self.num_heads
        if ch % self.num_head_channels:
            raise ValueError(f"{ch} channels do not split into heads of "
                             f"{self.num_head_channels}")
        return ch // self.num_head_channels


class UNet(nn.Module):
    """guided-diffusion UNet on NHWC tensors.

    forward(x: (B,H,W,C) in [-1,1], t: (B,) integer base timesteps,
            y: (B,) integer class labels, given exactly when the config has
            ``num_classes``) -> (B,H,W,out_channels) in the compute dtype.

    Convolution and dense weights are stored in ``param_dtype`` (by default
    the compute dtype, as inference wants) and cast to the compute dtype at
    each call; ``param_dtype=torch.float32`` gives the fp32 master weights
    of training, as the JAX package's ``param_dtype``.  GroupNorm parameters
    and the class embedding's table are always fp32.  With
    ``resblock_updown=False`` a level changes resolution by a stride-2 conv
    (down) and nearest upsampling followed by a conv (up), or without the
    convs when ``conv_resample=False``.
    """

    def __init__(self, cfg: UNetConfig, dtype: torch.dtype = torch.float32,
                 kernels: str = "cuda", param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.kernels = _check_route(kernels)
        mc = cfg.model_channels
        time_dim = mc * 4
        self.time_embed_0 = Dense(mc, time_dim)
        self.time_embed_2 = Dense(time_dim, time_dim)
        if cfg.num_classes is not None:
            self.label_emb = nn.Embedding(cfg.num_classes, time_dim)

        def res(name, cin, cout, **kw):
            setattr(self, name, ResBlock(
                cin, cout, time_dim, use_scale_shift_norm=cfg.use_scale_shift_norm,
                kernels=kernels, **kw))
            return name

        def attn(name, ch):
            setattr(self, name, AttentionBlock(ch, cfg.heads_for(ch), kernels))
            return name

        ch = int(cfg.channel_mult[0] * mc)
        self.input_blocks_0_0 = Conv(cfg.in_channels, ch)
        # each entry: the layers of one block, applied in order
        self._inputs: list[list[str]] = [["input_blocks_0_0"]]
        skip_chans = [ch]
        ds, idx = 1, 1
        for level, mult in enumerate(cfg.channel_mult):
            for _ in range(cfg.num_res_blocks):
                cout = int(mult * mc)
                names = [res(f"input_blocks_{idx}_0", ch, cout)]
                ch = cout
                if ds in cfg.attention_resolutions:
                    names.append(attn(f"input_blocks_{idx}_1", ch))
                self._inputs.append(names)
                skip_chans.append(ch)
                idx += 1
            if level != len(cfg.channel_mult) - 1:
                name = f"input_blocks_{idx}_0"
                if cfg.resblock_updown:
                    res(name, ch, ch, down=True)
                else:
                    setattr(self, name, Conv(ch, ch, 3, stride=2) if cfg.conv_resample
                            else Resample(_avgpool2x))
                self._inputs.append([name])
                skip_chans.append(ch)
                ds *= 2
                idx += 1

        self._middle = [res("middle_block_0", ch, ch), attn("middle_block_1", ch),
                        res("middle_block_2", ch, ch)]

        self._outputs: list[list[str]] = []
        idx = 0
        for level, mult in reversed(list(enumerate(cfg.channel_mult))):
            for i in range(cfg.num_res_blocks + 1):
                cout = int(mc * mult)
                names = [res(f"output_blocks_{idx}_0", ch + skip_chans.pop(), cout)]
                ch = cout
                j = 1
                if ds in cfg.attention_resolutions:
                    names.append(attn(f"output_blocks_{idx}_1", ch))
                    j = 2
                if level and i == cfg.num_res_blocks:
                    name = f"output_blocks_{idx}_{j}"
                    if cfg.resblock_updown:
                        res(name, ch, ch, up=True)
                    else:
                        setattr(self, name, Upsample(ch, ch) if cfg.conv_resample
                                else Resample(_upsample2x))
                    names.append(name)
                    ds //= 2
                self._outputs.append(names)
                idx += 1

        self.out_norm = GroupNorm32(ch, fuse_silu=True, kernels=kernels)
        self.out_conv = Conv(ch, cfg.out_channels)
        for m in self.modules():
            if isinstance(m, (Conv, nn.Linear)):
                m.to(dtype if param_dtype is None else param_dtype)
        self.space = None

    def set_mesh(self, mesh) -> "UNet":
        """Split the image height over ``mesh``'s ``space`` axis (when it has
        one of more than one rank): the forward then takes and returns whole
        images, and runs on this rank's rows in between.  Tensor parallelism
        is set by ``parallel/tp.py::shard_unet_params``."""
        space = mesh if mesh is not None and mesh.axis_size("space") > 1 else None
        self.space = space
        for m in self.modules():
            if isinstance(m, (Conv, GroupNorm32, AttentionBlock)):
                m.space = space
        return self

    def _layer(self, name: str, h: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        layer = getattr(self, name)
        args = (h, emb) if isinstance(layer, ResBlock) else (h,)
        if (self.cfg.use_remat and torch.is_grad_enabled()
                and isinstance(layer, (ResBlock, AttentionBlock))):
            return torch.utils.checkpoint.checkpoint(layer, *args, use_reentrant=False)
        return layer(*args)

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                y: Optional[torch.Tensor] = None) -> torch.Tensor:
        if (y is None) != (self.cfg.num_classes is None):
            raise ValueError("pass class labels y exactly when the model has "
                             "num_classes")
        emb = timestep_embedding(t, self.cfg.model_channels).to(self.dtype)
        emb = self.time_embed_2(F.silu(self.time_embed_0(emb)))
        if y is not None:
            emb = emb + self.label_emb(y).to(self.dtype)
        if self.space is not None:
            n = self.space.axis_size("space")
            depth = 2 ** (len(self.cfg.channel_mult) - 1)
            height = x.shape[1]
            if height % (n * depth):
                raise ValueError(
                    f"image height {height} over {n} space ranks: each rank's "
                    f"{height / n:g} rows must stay even down all "
                    f"{len(self.cfg.channel_mult)} levels (a multiple of {depth})")
            x = _coll.axis_block(x, self.space, "space", dim=1)
        h = x.to(self.dtype)
        hs = []
        for names in self._inputs:
            for name in names:
                h = self._layer(name, h, emb)
            hs.append(h)
        for name in self._middle:
            h = self._layer(name, h, emb)
        for names in self._outputs:
            h = torch.cat([h, hs.pop()], dim=-1)
            for name in names:
                h = self._layer(name, h, emb)
        out = self.out_conv(self.out_norm(h))
        if self.space is not None:
            out = _coll.all_gather(out, self.space, "space", dim=1)
        return out
