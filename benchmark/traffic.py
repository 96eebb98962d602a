"""The one generator of every traffic mix: a request's inputs from the run's
seed, the request's index and the mix's parameters (``traffic/<name>.json``).

A request is one batch of ``batch`` images.  Each is made on the device by
the generator seeded for (seed, request, part), so it is the same whatever
order requests are made in, and the judge can make it again after the
window:

* ``image``: the ground truth, uniform noise at ``coarse`` x ``coarse``
  upscaled bicubically to ``image_size``, plus N(0, ``detail``^2), clipped
  to [0, 1];
* ``psf``: ``gaussian`` (``size`` x ``size``, std ``std_base`` |2u + 1| for
  u uniform in [0, 1) per image, the public deblurring kernels) or ``table``
  (one PSF for every image, its ``values`` given);
* the observation: deblur, the ground truth blurred circularly by its PSF;
  sr, bicubic downscaling by ``sf`` with antialiasing; inpaint, the ground
  truth under a ``random`` mask that drops ``drop`` of the pixels (all
  channels alike); then N(0, (``noise_level_img``/255)^2) noise;
* the noise draws of the trajectory, ``KeyedNoise``: each draw seeded by
  (seed, request, step, repeat, name), handed to the program as ``noise=``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.diffpir import psf_to_otf
from benchmark.weights import key_seed

__all__ = ["KeyedNoise", "make_request"]


class KeyedNoise:
    """``noise(i, u, which, shape)``: the standard normal draw of request
    ``request``'s step ``i``, repeat ``u`` and name ``which``."""

    def __init__(self, seed: int, request: int, device):
        self.seed, self.request = seed, request
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device)

    def __call__(self, i: int, u: int, which: str, shape) -> torch.Tensor:
        self.gen.manual_seed(key_seed(self.seed, self.request, i, u, which))
        return torch.randn(tuple(shape), generator=self.gen, device=self.device)


def _gen(seed: int, request: int, part: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(key_seed(seed, request, part))


def _psf(traffic: dict, b: int, g: torch.Generator, device) -> torch.Tensor:
    spec = traffic["psf"]
    if spec["kind"] == "table":
        k = torch.tensor(spec["values"], dtype=torch.float32, device=device)
        return k.expand(b, *k.shape).contiguous()
    if spec["kind"] != "gaussian":
        raise ValueError(f"unknown psf kind {spec['kind']!r}")
    size = spec["size"]
    std = spec["std_base"] * (2.0 * torch.rand((b, 1, 1), generator=g, device=device) + 1.0)
    ax = torch.arange(size, dtype=torch.float32, device=device) - size // 2
    r2 = ax[:, None] ** 2 + ax[None, :] ** 2
    k = torch.exp(-r2[None] / (2.0 * std ** 2))
    return k / k.sum(dim=(1, 2), keepdim=True)


def make_request(traffic: dict, seed: int, request: int, device) -> dict:
    """The inputs of one request: ``y`` (B, h, w, C) float32 in about [0, 1],
    ``mask`` (B, H, W, C) float32 in {0, 1} (ones outside inpainting),
    ``kernel`` (B, kh, kw) float32 (one 1x1 PSF for inpainting) and
    ``noise``, a ``KeyedNoise``."""
    device = torch.device(device)
    b, size, c = traffic["batch"], traffic["image_size"], 3
    g = _gen(seed, request, "image", device)
    spec = traffic["image"]
    coarse = torch.rand((b, c, spec["coarse"], spec["coarse"]), generator=g, device=device)
    x = F.interpolate(coarse, size=(size, size), mode="bicubic", align_corners=False)
    x = x + spec["detail"] * torch.randn((b, c, size, size), generator=g, device=device)
    x = x.clamp(0.0, 1.0)
    task = traffic["task"]
    mask = torch.ones((b, size, size, c), device=device)
    kernel = torch.ones((b, 1, 1), device=device)
    if task == "deblur":
        kernel = _psf(traffic, b, g, device)
        otf = psf_to_otf(kernel, (size, size))[:, None]
        y = torch.fft.ifft2(torch.fft.fft2(x.double()) * otf).real.float()
    elif task == "sr":
        kernel = _psf(traffic, b, g, device)
        y = F.interpolate(x, scale_factor=1.0 / traffic["sf"], mode="bicubic",
                          align_corners=False, antialias=True)
    elif task == "inpaint":
        spec = traffic["mask"]
        if spec["kind"] != "random":
            raise ValueError(f"unknown mask kind {spec['kind']!r}")
        n = size * size
        order = torch.rand((b, n), generator=g, device=device).argsort(dim=1)
        m = torch.ones((b, n), device=device)
        m.scatter_(1, order[:, :int(n * spec["drop"])], 0.0)
        mask = m.reshape(b, size, size, 1).expand(b, size, size, c).contiguous()
        y = x * mask.permute(0, 3, 1, 2)
    else:
        raise ValueError(f"unknown task {task!r}")
    y = y.permute(0, 2, 3, 1)
    sigma = traffic["noise_level_img"] / 255.0
    if sigma:
        y = y + sigma * torch.randn(y.shape, generator=g, device=device)
    return {"y": y.contiguous(), "mask": mask, "kernel": kernel,
            "noise": KeyedNoise(seed, request, device)}
