"""Operations of one UNet forward, counted from shapes by the benchmark's own
reference model on the ``meta`` device (nothing is allocated or computed):
2 x multiply-adds of every convolution and linear layer, and the two
products of each attention block (2 T^2 C each).  Elementwise work,
GroupNorm and softmax are not counted, as ``FlopCounterMode`` does not."""

from __future__ import annotations

import torch
import torch.nn as nn

from benchmark.reference.unet import AttentionBlock, GuidedUNet, _Ops

__all__ = ["unet_flops"]


class _Counting(_Ops):
    """The reference's products, adding up their operations as they run."""

    def __init__(self, prec):
        super().__init__(prec)
        self.flops = 0.0

    def conv(self, m: nn.Module, x: torch.Tensor) -> torch.Tensor:
        out = super().conv(m, x)
        self.flops += 2.0 * out.numel() * m.weight[0].numel()
        return out

    def linear(self, m: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        out = super().linear(m, x)
        self.flops += 2.0 * out.numel() * m.in_features
        return out


def unet_flops(cfg: dict) -> float:
    """FLOPs of one forward of one image at the configuration's size."""
    size = cfg["image_size"]
    with torch.device("meta"):
        model = GuidedUNet(cfg)
    ops = model.ops = _Counting(model.ops.prec)

    def attention(m, args, out):
        b, c, hh, ww = args[0].shape
        ops.flops += 4.0 * b * (hh * ww) ** 2 * c

    handles = [m.register_forward_hook(attention) for m in model.modules()
               if isinstance(m, AttentionBlock)]
    try:
        with torch.no_grad():
            model(torch.empty((1, cfg["in_channels"], size, size), device="meta"),
                  torch.zeros((1,), dtype=torch.int64, device="meta"))
    finally:
        for h in handles:
            h.remove()
    return ops.flops
