"""InceptionV3 pool3 features and the Fréchet distance (FID) from local weights.

Port of ``diffpir_tpu/inception.py``.  The reference's tables report FID
(``README.md:121``) but its code never computes it; the convention is
pytorch-fid's: the pool3 features (2048-d) of the TF-ported
``pt_inception-2015-12-05`` InceptionV3.  The network is built from weights
the caller provides on disk (``.pt`` state dict or ``.npz`` with torchvision
``inception_v3`` key naming, which the pytorch-fid checkpoint shares); no
torchvision and no network.

As in the JAX package (pytorch-fid's ``FIDInception*`` blocks):
  * every conv is BasicConv2d = conv (no bias) + BatchNorm (eps 1e-3) + ReLU,
    the BatchNorm folded into the conv's weight and bias at load time;
  * the 3x3 stride-1 average pools inside blocks use count_include_pad=False;
  * Mixed_7c's pool branch takes a max pool;
  * the input is resized to 299x299 bilinearly as ``jax.image.resize`` does
    (half-pixel centres, a triangle kernel widened by the factor when it
    shrinks, weights renormalised at the border:
    ``ops.resize.bilinear_resize``), then mapped from [0, 1] to [-1, 1].

Convolutions are ``F.conv2d`` on NHWC activations (channels_last memory), in
fp32 with TF32 off on the card.  The Fréchet statistics are float64 numpy
on the host through symmetric eigendecompositions, as the JAX package's.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from diffpir_tpu_torch import resolve_device
from diffpir_tpu_torch.metrics import _load_weight_file, full_fp32, nhwc_conv
from diffpir_tpu_torch.ops.resize import bilinear_resize

__all__ = ["inception_pool3_from_weights", "frechet_distance",
           "feature_stats", "fid_from_weights", "FidScorer",
           "expected_conv_shapes", "N_FEATURES"]

_EPS_BN = 1e-3

# ---------------------------------------------------------------------------
# architecture tables (torchvision inception_v3 state_dict naming)
# ---------------------------------------------------------------------------
# stem: (name, cin, cout, kh, kw, stride, pad_h, pad_w); "M" = maxpool 3x3/2
_STEM = (
    ("Conv2d_1a_3x3", 3, 32, 3, 3, 2, 0, 0),
    ("Conv2d_2a_3x3", 32, 32, 3, 3, 1, 0, 0),
    ("Conv2d_2b_3x3", 32, 64, 3, 3, 1, 1, 1),
    "M",
    ("Conv2d_3b_1x1", 64, 80, 1, 1, 1, 0, 0),
    ("Conv2d_4a_3x3", 80, 192, 3, 3, 1, 0, 0),
    "M",
)

# per-conv shape plan inside each block type: branch key ->
#   list of (suffix, cout, kh, kw, stride, pad_h, pad_w); cin chains.
def _block_convs(kind: str, cin: int, arg: int):
    if kind == "A":  # InceptionA(pool_features=arg) -> 224 + arg channels
        return {
            "branch1x1": [("branch1x1", 64, 1, 1, 1, 0, 0)],
            "branch5x5": [("branch5x5_1", 48, 1, 1, 1, 0, 0),
                          ("branch5x5_2", 64, 5, 5, 1, 2, 2)],
            "branch3x3dbl": [("branch3x3dbl_1", 64, 1, 1, 1, 0, 0),
                             ("branch3x3dbl_2", 96, 3, 3, 1, 1, 1),
                             ("branch3x3dbl_3", 96, 3, 3, 1, 1, 1)],
            "branch_pool": [("branch_pool", arg, 1, 1, 1, 0, 0)],
        }
    if kind == "B":  # InceptionB: stride-2 reduction -> 480 + cin channels
        return {
            "branch3x3": [("branch3x3", 384, 3, 3, 2, 0, 0)],
            "branch3x3dbl": [("branch3x3dbl_1", 64, 1, 1, 1, 0, 0),
                             ("branch3x3dbl_2", 96, 3, 3, 1, 1, 1),
                             ("branch3x3dbl_3", 96, 3, 3, 2, 0, 0)],
        }
    if kind == "C":  # InceptionC(channels_7x7=arg) -> 768 channels
        c7 = arg
        return {
            "branch1x1": [("branch1x1", 192, 1, 1, 1, 0, 0)],
            "branch7x7": [("branch7x7_1", c7, 1, 1, 1, 0, 0),
                          ("branch7x7_2", c7, 1, 7, 1, 0, 3),
                          ("branch7x7_3", 192, 7, 1, 1, 3, 0)],
            "branch7x7dbl": [("branch7x7dbl_1", c7, 1, 1, 1, 0, 0),
                             ("branch7x7dbl_2", c7, 7, 1, 1, 3, 0),
                             ("branch7x7dbl_3", c7, 1, 7, 1, 0, 3),
                             ("branch7x7dbl_4", c7, 7, 1, 1, 3, 0),
                             ("branch7x7dbl_5", 192, 1, 7, 1, 0, 3)],
            "branch_pool": [("branch_pool", 192, 1, 1, 1, 0, 0)],
        }
    if kind == "D":  # InceptionD: stride-2 reduction -> 512 + cin channels
        return {
            "branch3x3": [("branch3x3_1", 192, 1, 1, 1, 0, 0),
                          ("branch3x3_2", 320, 3, 3, 2, 0, 0)],
            "branch7x7x3": [("branch7x7x3_1", 192, 1, 1, 1, 0, 0),
                            ("branch7x7x3_2", 192, 1, 7, 1, 0, 3),
                            ("branch7x7x3_3", 192, 7, 1, 1, 3, 0),
                            ("branch7x7x3_4", 192, 3, 3, 2, 0, 0)],
        }
    if kind == "E":  # InceptionE -> 2048 channels (split 3x3 branches)
        return {
            "branch1x1": [("branch1x1", 320, 1, 1, 1, 0, 0)],
            "branch3x3": [("branch3x3_1", 384, 1, 1, 1, 0, 0)],
            "branch3x3a": [("branch3x3_2a", 384, 1, 3, 1, 0, 1)],
            "branch3x3b": [("branch3x3_2b", 384, 3, 1, 1, 1, 0)],
            "branch3x3dbl": [("branch3x3dbl_1", 448, 1, 1, 1, 0, 0),
                             ("branch3x3dbl_2", 384, 3, 3, 1, 1, 1)],
            "branch3x3dbla": [("branch3x3dbl_3a", 384, 1, 3, 1, 0, 1)],
            "branch3x3dblb": [("branch3x3dbl_3b", 384, 3, 1, 1, 1, 0)],
            "branch_pool": [("branch_pool", 192, 1, 1, 1, 0, 0)],
        }
    raise ValueError(kind)


# (block name, kind, cin, arg)
_BLOCKS = (
    ("Mixed_5b", "A", 192, 32),
    ("Mixed_5c", "A", 256, 64),
    ("Mixed_5d", "A", 288, 64),
    ("Mixed_6a", "B", 288, 0),
    ("Mixed_6b", "C", 768, 128),
    ("Mixed_6c", "C", 768, 160),
    ("Mixed_6d", "C", 768, 160),
    ("Mixed_6e", "C", 768, 192),
    ("Mixed_7a", "D", 768, 0),
    ("Mixed_7b", "E", 1280, 0),
    ("Mixed_7c", "E", 2048, 0),
)

N_FEATURES = 2048

# InceptionE's split 3x3 branches consume their PARENT conv's 384 channels,
# not the block input (the a/b legs fork after branch3x3_1 / branch3x3dbl_2)
_E_FORK_CIN = {"branch3x3a": 384, "branch3x3b": 384,
               "branch3x3dbla": 384, "branch3x3dblb": 384}


def expected_conv_shapes() -> dict:
    """{state_dict conv prefix: (cout, cin, kh, kw)} for the whole network.

    Shared by the loader (validation) and the tests (random-weight synthesis).
    """
    shapes = {}
    for e in _STEM:
        if e == "M":
            continue
        name, cin, cout, kh, kw, *_ = e
        shapes[name] = (cout, cin, kh, kw)
    for bname, kind, cin, arg in _BLOCKS:
        for key, convs in _block_convs(kind, cin, arg).items():
            c = _E_FORK_CIN.get(key, cin) if kind == "E" else cin
            for suffix, cout, kh, kw, *_ in convs:
                shapes[f"{bname}.{suffix}"] = (cout, c, kh, kw)
                c = cout
    return shapes


def _fold_bn(flat: dict, prefix: str, want_shape) -> tuple:
    """conv weight + BatchNorm(eps=1e-3) -> fused (OIHW weight, (C,) bias),
    fp32 numpy."""
    try:
        w = flat[f"{prefix}.conv.weight"]
        gamma = flat[f"{prefix}.bn.weight"]
        beta = flat[f"{prefix}.bn.bias"]
        mean = flat[f"{prefix}.bn.running_mean"]
        var = flat[f"{prefix}.bn.running_var"]
    except KeyError as e:
        raise ValueError(
            f"FID weights: missing key {e} (expected torchvision "
            f"inception_v3 state_dict naming)") from e
    if tuple(w.shape) != tuple(want_shape):
        raise ValueError(f"FID weights: {prefix}.conv.weight has shape "
                         f"{w.shape}, expected {want_shape}")
    s = gamma / np.sqrt(var + _EPS_BN)
    w = w * s[:, None, None, None]          # scale each output channel
    b = beta - mean * s
    return (np.ascontiguousarray(w, dtype=np.float32),
            np.ascontiguousarray(b, dtype=np.float32).reshape(-1))


def inception_pool3_from_weights(weights_path: str, resize_input: bool = True,
                                 device: torch.device | str | None = None) -> Callable:
    """The pool3 feature extractor on ``device`` (by default the current CUDA
    card; the CPU only when asked for): ``f(x01) -> (B, 2048)`` float64
    numpy, ``x01`` (B, H, W, 3) in [0, 1] (any H, W when ``resize_input``).
    fp32 throughout (FID's statistics are sensitive to the covariance)."""
    device = resolve_device(cpu=False) if device is None else torch.device(device)
    flat = _load_weight_file(weights_path)
    fused = {}
    for name, shp in expected_conv_shapes().items():
        w, b = _fold_bn(flat, name, shp)
        fused[name] = (torch.from_numpy(w).to(device).contiguous(
            memory_format=torch.channels_last), torch.from_numpy(b).to(device))
    full_fp32(device)

    def conv(x, name, stride, ph, pw):
        return torch.relu(nhwc_conv(x, *fused[name], stride=stride, padding=(ph, pw)))

    def pool(fn, x, *args, **kw):
        return fn(x.permute(0, 3, 1, 2), *args, **kw).permute(0, 2, 3, 1)

    def maxpool3x3s2(x):
        return pool(F.max_pool2d, x, 3, 2)

    def avgpool3x3s1(x):  # count_include_pad=False (FIDInception A, C, E)
        return pool(F.avg_pool2d, x, 3, 1, 1, count_include_pad=False)

    def maxpool3x3s1(x):  # FIDInceptionE_2 (Mixed_7c) pool branch
        return pool(F.max_pool2d, x, 3, 1, 1)

    def run_chain(x, bname, convs):
        for suffix, _co, _kh, _kw, stride, ph, pw in convs:
            x = conv(x, f"{bname}.{suffix}", stride, ph, pw)
        return x

    def block(x, bname, kind, cin, arg):
        c = _block_convs(kind, cin, arg)
        if kind == "A":
            outs = [run_chain(x, bname, c["branch1x1"]),
                    run_chain(x, bname, c["branch5x5"]),
                    run_chain(x, bname, c["branch3x3dbl"]),
                    run_chain(avgpool3x3s1(x), bname, c["branch_pool"])]
        elif kind == "B":
            outs = [run_chain(x, bname, c["branch3x3"]),
                    run_chain(x, bname, c["branch3x3dbl"]),
                    maxpool3x3s2(x)]
        elif kind == "C":
            outs = [run_chain(x, bname, c["branch1x1"]),
                    run_chain(x, bname, c["branch7x7"]),
                    run_chain(x, bname, c["branch7x7dbl"]),
                    run_chain(avgpool3x3s1(x), bname, c["branch_pool"])]
        elif kind == "D":
            outs = [run_chain(x, bname, c["branch3x3"]),
                    run_chain(x, bname, c["branch7x7x3"]),
                    maxpool3x3s2(x)]
        else:  # E
            b3 = run_chain(x, bname, c["branch3x3"])
            b3 = torch.cat([run_chain(b3, bname, c["branch3x3a"]),
                            run_chain(b3, bname, c["branch3x3b"])], -1)
            bd = run_chain(x, bname, c["branch3x3dbl"])
            bd = torch.cat([run_chain(bd, bname, c["branch3x3dbla"]),
                            run_chain(bd, bname, c["branch3x3dblb"])], -1)
            pool_x = maxpool3x3s1(x) if bname == "Mixed_7c" else avgpool3x3s1(x)
            outs = [run_chain(x, bname, c["branch1x1"]), b3, bd,
                    run_chain(pool_x, bname, c["branch_pool"])]
        return torch.cat(outs, dim=-1)

    def features(x: torch.Tensor) -> torch.Tensor:
        if resize_input:
            x = bilinear_resize(x, (299, 299))
        x = x * 2.0 - 1.0
        for e in _STEM:
            if e == "M":
                x = maxpool3x3s2(x)
            else:
                name, _ci, _co, _kh, _kw, stride, ph, pw = e
                x = conv(x, name, stride, ph, pw)
        for bname, kind, cin, arg in _BLOCKS:
            x = block(x, bname, kind, cin, arg)
        return x.mean(dim=(1, 2))  # global average pool -> (B, 2048)

    def compute(x01: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.array(x01, np.float32)).to(device)
        with torch.no_grad():
            return features(x).cpu().numpy().astype(np.float64)

    return compute


# ---------------------------------------------------------------------------
# Fréchet statistics
# ---------------------------------------------------------------------------

def feature_stats(feats: np.ndarray) -> tuple:
    """(mu, sigma) of an (N, D) feature matrix in float64."""
    f = np.asarray(feats, np.float64)
    if f.ndim != 2 or f.shape[0] < 2:
        raise ValueError(f"need (N>=2, D) features, got {f.shape}")
    return f.mean(axis=0), np.cov(f, rowvar=False)


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """||mu1-mu2||^2 + tr(S1 + S2 - 2 sqrtm(S1 S2)), PSD-safe.

    tr sqrtm(S1 S2) = sum sqrt eig(S1^1/2 S2 S1^1/2): symmetric
    eigendecompositions only (pytorch-fid reaches the same value through
    ``scipy.linalg.sqrtm`` on the non-symmetric product, then has to patch up
    imaginary leakage; the congruent form never leaves the reals).
    """
    mu1, mu2 = np.asarray(mu1, np.float64), np.asarray(mu2, np.float64)
    s1 = np.atleast_2d(np.asarray(sigma1, np.float64))
    s2 = np.atleast_2d(np.asarray(sigma2, np.float64))
    diff = mu1 - mu2

    # S1^1/2 via symmetric eigendecomposition (clip tiny negatives)
    w, v = np.linalg.eigh(s1)
    root1 = (v * np.sqrt(np.clip(w, 0.0, None))) @ v.T
    m = root1 @ s2 @ root1
    ev = np.linalg.eigvalsh((m + m.T) / 2.0)
    # eps guard mirrors pytorch-fid's singular-product fallback
    tr_sqrt = float(np.sum(np.sqrt(np.clip(ev, eps * eps, None))))
    return float(diff @ diff + np.trace(s1) + np.trace(s2) - 2.0 * tr_sqrt)


class FidScorer:
    """Streaming FID between two image sets (restored against ground truth).

    ``add(a_batch, b_batch)`` adds the pool3 features of each batch
    ((B,H,W,3) float in [0,1]); ``score()`` is the Fréchet distance of the
    sets so far.  ``Runner.evaluate`` uses it, so FID costs one more forward
    per batch instead of a second pass over saved images.
    """

    def __init__(self, weights_path: str, resize_input: bool = True,
                 device: torch.device | str | None = None):
        self.features = inception_pool3_from_weights(weights_path, resize_input,
                                                     device)
        self._a, self._b = [], []

    def add(self, a: np.ndarray, b: Optional[np.ndarray] = None) -> None:
        self._a.append(self.features(a))
        if b is not None:
            self._b.append(self.features(b))

    def score(self) -> float:
        mu1, s1 = feature_stats(np.concatenate(self._a, axis=0))
        mu2, s2 = feature_stats(np.concatenate(self._b, axis=0))
        return frechet_distance(mu1, s1, mu2, s2)


def fid_from_weights(weights_path: str,
                     device: torch.device | str | None = None) -> Callable:
    """``fid(a_set, b_set) -> float`` on (N,H,W,3) [0,1] arrays: the one-shot
    form of ``FidScorer``, features taken ``batch`` images at a time."""
    feats = inception_pool3_from_weights(weights_path, device=device)

    def compute(a: np.ndarray, b: np.ndarray, batch: int = 16) -> float:
        def all_feats(x):
            x = np.asarray(x, np.float32)
            return np.concatenate([feats(x[i:i + batch])
                                   for i in range(0, len(x), batch)], axis=0)

        mu1, s1 = feature_stats(all_feats(a))
        mu2, s2 = feature_stats(all_feats(b))
        return frechet_distance(mu1, s1, mu2, s2)

    return compute
