"""Seeded weights in guided-diffusion's state-dict layout, made on the device.

One ``torch.randn`` over every parameter at once, from a ``torch.Generator``
on the device, then each tensor scaled where it lies in that buffer:
convolution and linear weights N(0, 1/fan_in), their biases N(0, 0.05^2),
GroupNorm scales 1 + N(0, 0.1^2) and shifts N(0, 0.1^2).  No layer is zero,
so every layer reaches the output.  The same seed gives the same weights to
the program and to the reference."""

from __future__ import annotations

import hashlib

import torch
import torch.nn as nn

from benchmark.reference.unet import GuidedUNet

__all__ = ["key_seed", "state_dict"]


def key_seed(*parts) -> int:
    """A 63-bit generator seed from any parts (the run's seed, a request,
    a step, a draw's name)."""
    digest = hashlib.blake2b(repr(parts).encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") >> 1


def state_dict(cfg: dict, seed: int, device, dtype=torch.float32) -> dict[str, torch.Tensor]:
    """The weights of ``cfg``'s UNet for ``seed``, as views of one buffer of
    ``dtype`` on ``device``."""
    with torch.device("meta"):
        model = GuidedUNet(cfg)
    norms = {f"{name}.{leaf}" for name, m in model.named_modules()
             if isinstance(m, nn.GroupNorm) for leaf in ("weight", "bias")}
    shapes = [(k, tuple(v.shape)) for k, v in model.state_dict().items()]
    total = sum(torch.Size(s).numel() for _, s in shapes)
    gen = torch.Generator(device=device).manual_seed(key_seed(seed, "weights"))
    flat = torch.randn(total, generator=gen, device=device, dtype=dtype)
    out, off = {}, 0
    with torch.no_grad():
        for name, shape in shapes:
            n = torch.Size(shape).numel()
            v = flat[off:off + n].view(shape)
            off += n
            if name in norms:
                v.mul_(0.1)
                if name.endswith("weight"):
                    v.add_(1.0)
            elif name.endswith("bias"):
                v.mul_(0.05)
            else:
                v.mul_(v[0].numel() ** -0.5)
            out[name] = v
    return out
