"""guided-diffusion's UNet in plain PyTorch, NCHW, float32.

The forward of ``UNetModel`` as guided-diffusion publishes it
(``guided_diffusion/unet.py``: ``ResBlock`` with scale-shift norm and
resblock up/down, ``AttentionBlock`` with ``QKVAttentionLegacy``,
``GroupNorm32``, ``timestep_embedding``), with the module names of its state
dict, so a published checkpoint, or the benchmark's seeded weights in the
same layout, loads with ``load_state_dict``.  Dropout is left out (inference).

``Precision`` rounds the operands of every convolution, linear layer and
attention product: ``Precision()`` keeps float32 (the reference), and
``Precision("fp8")`` rounds each operand to float8 e4m3 with a per-tensor
scale before the product, which is summed in float32 (the control).
GroupNorm, softmax and the residual sums stay in float32 either way.
This module imports nothing of the program under test.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ["Precision", "GuidedUNet", "timestep_embedding"]

FP8_MAX = 448.0   # largest finite float8 e4m3 value


class Precision:
    """How the operands of a product are rounded: "fp32" leaves them, "fp8"
    rounds them to float8 e4m3 with a per-tensor scale."""

    def __init__(self, kind: str = "fp32"):
        if kind not in ("fp32", "fp8"):
            raise ValueError(f"precision must be fp32 or fp8, got {kind!r}")
        self.kind = kind

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "fp32":
            return x
        scale = x.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
        return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t[:, None].float() * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


def _norm(channels: int) -> nn.GroupNorm:
    return nn.GroupNorm(32, channels)


def _group_norm(m: nn.GroupNorm, x: torch.Tensor) -> torch.Tensor:
    return F.group_norm(x.float(), m.num_groups, m.weight, m.bias, m.eps)


class _Ops:
    """Convolutions and linear layers whose operands ``prec`` rounds."""

    def __init__(self, prec: Precision):
        self.prec = prec

    def conv(self, m: nn.Module, x: torch.Tensor) -> torch.Tensor:
        q = self.prec
        if isinstance(m, nn.Conv1d):
            # the attention's 1x1 Conv1d as the product it is
            return torch.einsum("oi,bit->bot", q(m.weight[:, :, 0]), q(x)) + m.bias[:, None]
        return F.conv2d(q(x), q(m.weight), m.bias, m.stride, m.padding)

    def linear(self, m: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        return F.linear(self.prec(x), self.prec(m.weight), m.bias)


def _up(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2, mode="nearest")


def _down(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(x, kernel_size=2, stride=2)


class ResBlock(nn.Module):
    def __init__(self, ch: int, emb_ch: int, out_ch: int, *, scale_shift: bool,
                 up: bool = False, down: bool = False):
        super().__init__()
        self.in_layers = nn.Sequential(_norm(ch), nn.SiLU(), nn.Conv2d(ch, out_ch, 3, padding=1))
        self.emb_layers = nn.Sequential(nn.SiLU(),
                                        nn.Linear(emb_ch, 2 * out_ch if scale_shift else out_ch))
        self.out_layers = nn.Sequential(_norm(out_ch), nn.SiLU(), nn.Identity(),
                                        nn.Conv2d(out_ch, out_ch, 3, padding=1))
        self.skip_connection = nn.Identity() if out_ch == ch else nn.Conv2d(ch, out_ch, 1)
        self.scale_shift, self.up, self.down = scale_shift, up, down

    def forward(self, x, emb, ops: _Ops):
        h = F.silu(_group_norm(self.in_layers[0], x))
        if self.up:
            h, x = _up(h), _up(x)
        elif self.down:
            h, x = _down(h), _down(x)
        h = ops.conv(self.in_layers[2], h)
        e = ops.linear(self.emb_layers[1], F.silu(emb))[:, :, None, None]
        if self.scale_shift:
            scale, shift = e.chunk(2, dim=1)
            h = _group_norm(self.out_layers[0], h) * (1 + scale) + shift
        else:
            h = _group_norm(self.out_layers[0], h + e)
        h = ops.conv(self.out_layers[3], F.silu(h))
        skip = x if isinstance(self.skip_connection, nn.Identity) else ops.conv(
            self.skip_connection, x)
        return skip + h


class AttentionBlock(nn.Module):
    def __init__(self, ch: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.norm = _norm(ch)
        self.qkv = nn.Conv1d(ch, 3 * ch, 1)
        self.proj_out = nn.Conv1d(ch, ch, 1)

    def forward(self, x, emb, ops: _Ops):
        b, c, hh, ww = x.shape
        x = x.reshape(b, c, hh * ww)
        qkv = ops.conv(self.qkv, _group_norm(self.norm, x))
        # QKVAttentionLegacy: heads of [q|k|v] rows
        ch = c // self.num_heads
        q, k, v = qkv.reshape(b * self.num_heads, 3 * ch, hh * ww).split(ch, dim=1)
        scale = 1.0 / math.sqrt(math.sqrt(ch))
        p = ops.prec
        w = torch.einsum("bct,bcs->bts", p(q * scale), p(k * scale))
        w = torch.softmax(w.float(), dim=-1)
        a = torch.einsum("bts,bcs->bct", p(w), p(v)).reshape(b, c, hh * ww)
        return (x + ops.conv(self.proj_out, a)).reshape(b, c, hh, ww)


class _Seq(nn.ModuleList):
    """``TimestepEmbedSequential``: its layers in order."""

    def forward(self, h, emb, ops: _Ops):
        for layer in self:
            h = ops.conv(layer, h) if isinstance(layer, nn.Conv2d) else layer(h, emb, ops)
        return h


class GuidedUNet(nn.Module):
    """``UNetModel`` of guided-diffusion, from a benchmark configuration dict
    (``image_size``, ``in_channels``, ``model_channels``, ``out_channels``,
    ``num_res_blocks``, ``attention_ds``, ``channel_mult``, ``num_heads``,
    ``num_head_channels``, ``use_scale_shift_norm``, ``resblock_updown``).

    ``forward(x (B,C,H,W) float32, t (B,) integer timesteps)`` returns
    (B, out_channels, H, W) float32."""

    def __init__(self, cfg: dict, prec: Optional[Precision] = None):
        super().__init__()
        if not cfg["resblock_updown"]:
            raise ValueError("the reference builds resblock up/down UNets only")
        mc = cfg["model_channels"]
        emb_ch = 4 * mc
        ss = cfg["use_scale_shift_norm"]
        attn_ds = set(cfg["attention_ds"])
        self.model_channels = mc
        self.ops = _Ops(prec or Precision())

        def heads(c):
            return cfg["num_heads"] if cfg["num_head_channels"] == -1 else c // cfg["num_head_channels"]

        self.time_embed = nn.Sequential(nn.Linear(mc, emb_ch), nn.SiLU(), nn.Linear(emb_ch, emb_ch))
        ch = cfg["channel_mult"][0] * mc
        blocks = [_Seq([nn.Conv2d(cfg["in_channels"], ch, 3, padding=1)])]
        chans, ds = [ch], 1
        for level, mult in enumerate(cfg["channel_mult"]):
            for _ in range(cfg["num_res_blocks"]):
                layers = [ResBlock(ch, emb_ch, mult * mc, scale_shift=ss)]
                ch = mult * mc
                if ds in attn_ds:
                    layers.append(AttentionBlock(ch, heads(ch)))
                blocks.append(_Seq(layers))
                chans.append(ch)
            if level != len(cfg["channel_mult"]) - 1:
                blocks.append(_Seq([ResBlock(ch, emb_ch, ch, scale_shift=ss, down=True)]))
                chans.append(ch)
                ds *= 2
        self.input_blocks = nn.ModuleList(blocks)
        self.middle_block = _Seq([ResBlock(ch, emb_ch, ch, scale_shift=ss),
                                  AttentionBlock(ch, heads(ch)),
                                  ResBlock(ch, emb_ch, ch, scale_shift=ss)])
        outs = []
        for level, mult in list(enumerate(cfg["channel_mult"]))[::-1]:
            for i in range(cfg["num_res_blocks"] + 1):
                layers = [ResBlock(ch + chans.pop(), emb_ch, mc * mult, scale_shift=ss)]
                ch = mc * mult
                if ds in attn_ds:
                    layers.append(AttentionBlock(ch, heads(ch)))
                if level and i == cfg["num_res_blocks"]:
                    layers.append(ResBlock(ch, emb_ch, ch, scale_shift=ss, up=True))
                    ds //= 2
                outs.append(_Seq(layers))
        self.output_blocks = nn.ModuleList(outs)
        self.out = nn.Sequential(_norm(ch), nn.SiLU(),
                                 nn.Conv2d(ch, cfg["out_channels"], 3, padding=1))

    def forward(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        ops = self.ops
        emb = timestep_embedding(t, self.model_channels)
        emb = ops.linear(self.time_embed[2], F.silu(ops.linear(self.time_embed[0], emb)))
        h, hs = x.float(), []
        for block in self.input_blocks:
            h = block(h, emb, ops)
            hs.append(h)
        h = self.middle_block(h, emb, ops)
        for block in self.output_blocks:
            h = block(torch.cat([h, hs.pop()], dim=1), emb, ops)
        return ops.conv(self.out[2], F.silu(_group_norm(self.out[0], h)))
