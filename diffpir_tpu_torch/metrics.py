"""Quality metrics: PSNR-Y, LPIPS from local weights, and FID's names.

Port of ``diffpir_tpu/metrics.py``.  PSNR, SSIM and luma live in
``utils/image.py``; this module adds LPIPS(vgg), which the reference computes
with the ``lpips`` package (``main_ddpir.py:543-544``), and re-exports the
FID names of ``inception.py`` lazily.  ``make_lpips`` keeps the JAX package's
two routes: with a weights file it builds LPIPS from it on the device
(``lpips_from_weights``); without one it imports the ``lpips`` package
lazily and returns None when that, or the backbone it downloads, is
unavailable, so callers skip the metric.

``lpips_from_weights`` runs VGG16's convolutions as ``F.conv2d`` on NHWC
activations (the NCHW view of channels_last memory, as the UNet's), in fp32
with TF32 off on the card.  It returns ``compute(a, b) -> float``, the mean
over the batch, on (B, H, W, 3) numpy arrays in [-1, 1].
"""

from __future__ import annotations

import logging
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from diffpir_tpu_torch import resolve_device
from diffpir_tpu_torch.utils.image import psnr, psnr_batch, rgb_to_y_batch, ssim

__all__ = ["psnr", "psnr_batch", "ssim", "rgb_to_y_batch", "psnr_y_batch",
           "make_lpips", "lpips_from_weights", "fid_from_weights",
           "frechet_distance", "FidScorer"]

log = logging.getLogger(__name__)


def __getattr__(name):
    # FID lives in inception.py; re-exported here so that this module stays
    # the one import point of the metrics
    if name in ("fid_from_weights", "frechet_distance", "FidScorer",
                "inception_pool3_from_weights", "feature_stats"):
        import diffpir_tpu_torch.inception as _inc

        return getattr(_inc, name)
    raise AttributeError(name)


def psnr_y_batch(a: np.ndarray, b: np.ndarray) -> float:
    """PSNR on the BT.601 luma channel, inputs (B,H,W,3) in [-1,1]."""
    return psnr_batch(rgb_to_y_batch(a), rgb_to_y_batch(b))


def make_lpips(net: str = "vgg", weights_path: Optional[str] = None,
               device: torch.device | str | None = None) -> Optional[Callable]:
    """``lpips(a, b) -> float`` on (B,H,W,3) [-1,1] arrays, or None.

    With ``weights_path``, LPIPS(vgg) from that file on ``device`` (a
    malformed file raises).  Without it, the ``lpips`` package on the CPU
    when it imports and its constructor finds the backbone weights (it
    downloads them otherwise), else None.
    """
    if weights_path is not None:
        return lpips_from_weights(weights_path, device)
    try:
        import lpips  # type: ignore

        loss_fn = lpips.LPIPS(net=net)
    except Exception:
        log.info("lpips unavailable (package or weights) — LPIPS disabled")
        return None

    def compute(a: np.ndarray, b: np.ndarray) -> float:
        with torch.no_grad():
            ta = torch.from_numpy(np.transpose(a, (0, 3, 1, 2)).astype(np.float32))
            tb = torch.from_numpy(np.transpose(b, (0, 3, 1, 2)).astype(np.float32))
            return float(loss_fn(ta, tb).mean())

    return compute


# VGG16 ``features`` conv layer indices (torchvision state dict naming) and
# the stages between 2x2 max pools; LPIPS(vgg) taps the last ReLU of each
# stage (relu1_2, relu2_2, relu3_3, relu4_3, relu5_3)
_VGG16_CONVS = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)
_VGG16_STAGES = ((0, 2), (5, 7), (10, 12, 14), (17, 19, 21), (24, 26, 28))

# lpips.ScalingLayer's constants ([-1, 1] input -> ImageNet-like whitening)
_LPIPS_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_LPIPS_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


def full_fp32(device: torch.device) -> None:
    """On the card, fp32 convolutions and matmuls in full fp32 (cuDNN and
    cuBLAS would run them in TF32), as the JAX package's
    ``Precision.HIGHEST``."""
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False


def nhwc_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride=1,
              padding=0) -> torch.Tensor:
    """``F.conv2d`` on an NHWC tensor (its NCHW view), NHWC out."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w, b, stride, padding)
    return y.permute(0, 2, 3, 1)


def lpips_from_weights(weights_path: str,
                       device: torch.device | str | None = None) -> Callable:
    """LPIPS(vgg) from a local weights file, on ``device`` (by default the
    current CUDA card; the CPU only when asked for).

    The file (``.npz`` or a torch ``.pt`` state dict; keys may be merged from
    the two upstream files) holds ``features.{i}.weight`` / ``.bias`` for the
    13 VGG16 conv layers (torchvision naming, OIHW) and
    ``lin{k}.model.1.weight`` for k in 0..4 (the ``lpips`` package's heads,
    (1, C_k, 1, 1)); ``scaling_layer.shift`` / ``.scale`` are optional.  The
    graph: whitening, VGG16 with 2x2 max pools between stages, each tapped
    activation unit-normalised over channels (eps 1e-10), the squared
    difference weighed by ``lin``, its spatial mean, the sum over stages.
    """
    device = resolve_device(cpu=False) if device is None else torch.device(device)
    flat = _load_weight_file(weights_path)

    def on_device(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.array(a, np.float32)).to(device)

    convs = {}
    for i in _VGG16_CONVS:
        try:
            w, b = flat[f"features.{i}.weight"], flat[f"features.{i}.bias"]
        except KeyError as e:
            raise ValueError(
                f"{weights_path}: missing VGG16 key {e} (expected torchvision "
                f"features.* naming; see lpips_from_weights docstring)") from e
        if w.ndim != 4 or w.shape[2:] != (3, 3):
            raise ValueError(f"{weights_path}: features.{i}.weight has shape "
                             f"{w.shape}, expected (O,I,3,3)")
        convs[i] = (on_device(w).contiguous(memory_format=torch.channels_last),
                    on_device(b.reshape(-1)))
    lins = []
    for k in range(5):
        key = f"lin{k}.model.1.weight"
        if key not in flat:
            raise ValueError(f"{weights_path}: missing LPIPS head {key!r}")
        lins.append(on_device(flat[key].reshape(-1)))
    shift = on_device(flat.get("scaling_layer.shift", _LPIPS_SHIFT).reshape(3))
    scale = on_device(flat.get("scaling_layer.scale", _LPIPS_SCALE).reshape(3))
    full_fp32(device)

    def features(x: torch.Tensor) -> list[torch.Tensor]:
        taps = []
        for s, stage in enumerate(_VGG16_STAGES):
            if s:  # 2x2 max pool, stride 2, between stages
                x = F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
            for i in stage:
                x = torch.relu(nhwc_conv(x, *convs[i], padding=1))
            taps.append(x)
        return taps

    def per_image(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        total = 0.0
        for ta, tb, lin in zip(features((a - shift) / scale),
                               features((b - shift) / scale), lins):
            na = ta * torch.rsqrt((ta * ta).sum(-1, keepdim=True) + 1e-10)
            nb = tb * torch.rsqrt((tb * tb).sum(-1, keepdim=True) + 1e-10)
            total = total + ((na - nb) ** 2 * lin).sum(-1).mean(dim=(1, 2))
        return total  # (B,)

    def compute(a: np.ndarray, b: np.ndarray) -> float:
        with torch.no_grad():
            return float(per_image(on_device(a), on_device(b)).mean())

    return compute


def _load_weight_file(path: str) -> dict:
    """npz or torch ``.pt`` state dict -> {key: fp32 np.ndarray}."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: np.asarray(z[k], np.float32) for k in z.files}
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return {k: np.asarray(v.detach().float().numpy(), np.float32)
            for k, v in sd.items()}
