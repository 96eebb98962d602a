"""Typed configuration tree with YAML loading and CLI overrides.

Copy of ``diffpir_tpu/config.py`` for the PyTorch port: the same
``TaskConfig`` fields, defaults and ``finalize`` rules, so that every file in
``configs/`` loads to the same values in both packages.  The port reads YAML
with a small standard-library reader (``read_flat_yaml``) instead of PyYAML:
every config file of the repository is a flat ``key: value`` mapping.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Any, Optional, Sequence

__all__ = ["TaskConfig", "load_config", "read_flat_yaml", "parse_overrides"]

_VALID_TASKS = ("sr", "deblur", "inpaint")
_VALID_MODES = ("DiffPIR", "repaint", "vanilla", "DPS_y0", "DPS_yt")


@dataclasses.dataclass
class TaskConfig:
    # core task / run
    task: str = "inpaint"
    seed: int = 42
    model_name: str = "diffusion_ffhq_10m"
    testset_name: str = "demo_test"
    n_channels: int = 3
    cwd: str = ""
    batch_size: int = 16

    # noise & schedule
    noise_level_img: float = 0.0       # in /255 units in YAML; normalized on load
    noise_level_model: Optional[float] = None
    num_train_timesteps: int = 1000
    beta_start: float = 0.0001
    beta_end: float = 0.02
    noise_init_img: Any = "max"        # 'max' or a /255 noise level for t_start
    skip_noise_model_t: bool = False

    # sampler
    iter_num: int = 20                 # NFE
    iter_num_U: int = 1
    lambda_: float = 1.0
    zeta: float = 1.0
    eta: float = 0.0
    guidance_scale: float = 1.0
    sub_1_analytic: bool = True
    ddim_sample: bool = False
    model_output_type: str = "pred_xstart"
    generate_mode: str = "DiffPIR"
    skip_type: str = "quad"
    log_process: bool = False
    test_mode: int = 0                 # denoiser evaluation mode
                                       # (utils/utils_model.py:16-45):
                                       # 0 direct, 1 pad-to-modulo, 2 recursive
                                       # split (large images), 3 x8 dihedral
                                       # ensemble, 4 split + x8

    # io / eval
    save_L: bool = True
    save_E: bool = True
    save_LEH: bool = False             # side-by-side L|E|H montage (sisr driver)
    calc_LPIPS: bool = False
    lpips_weights: Optional[str] = None  # local VGG16+lin weights file for
                                       # LPIPS in no-egress deployments
                                       # (metrics.lpips_from_weights)
    calc_FID: bool = False             # FID(restored, ground truth) over the
                                       # whole eval set — the reference's
                                       # tables report FID (README.md:121) but
                                       # its code never computes it
    fid_weights: Optional[str] = None  # local InceptionV3 weights file
                                       # (metrics.fid_from_weights; required
                                       # when calc_FID)
    calc_SSIM: bool = True             # log SSIM alongside PSNR (the reference
                                       # implements it, utils_image.py:616-661,
                                       # but its drivers never call it)
    psnr_y_mode: str = "reference"     # 'reference': zero-padded-CbCr PSNR-Y
                                       # (bug-parity with utils_image.py:482-484,
                                       # = true Y-PSNR + 10*log10(3));
                                       # 'true': honest Y-channel PSNR (what the
                                       # standalone sisr driver computes,
                                       # main_ddpir_sisr.py:458-462)

    # sr-only
    sf: int = 1
    sr_mode: str = "blur"              # blur | cubic | classical
    inIter: int = 1
    gamma: float = 0.01
    classical_kernel_index: int = 0    # PSF index into kernels_12 (classical mode)

    # deblur-only
    use_DIY_kernel: bool = True
    blur_mode: str = "Gaussian"        # Gaussian | motion
    kernel_size: int = 61
    kernel_std: float = 3.0
    ty_init: bool = True               # init x from noisy y at t_y with the
                                       # effective-alpha formula, as the
                                       # reference's standalone deblur driver
                                       # does (main_ddpir_deblur.py:227-231);
                                       # off = unified-driver behavior
                                       # (diffuse y from scratch)

    # inpaint-only
    mask_name: str = ""
    load_mask: bool = False
    mask_type: str = "random"          # box | random | both | extreme
    mask_len_range: Sequence[int] = (128, 129)
    mask_prob_range: Sequence[float] = (0.5, 0.5)
    save_progressive_mask: bool = False

    # JAX-package extensions (not in the reference surface).  The port reads
    # the same keys; it ignores use_pallas (its CUDA kernels run whenever a
    # tensor is on the card) and does not implement mesh_shape/mesh_axes yet.
    recover_known: bool = False        # overwrite observed pixels in the output
                                       # (the reference's recovery at
                                       # main_ddpir.py:475 is dead code: x_0 is
                                       # computed before it, so faithful default
                                       # is off; turning it on improves PSNR)
    dtype: str = "bfloat16"            # UNet compute dtype; prox always runs fp32
    use_pallas: bool = False           # fused Pallas kernels for attention/groupnorm
    mesh_shape: Optional[Sequence[int]] = None  # device mesh: None/1-D = data-
                                       # parallel over all/N devices; 2-D
                                       # [D, M] = dp x Megatron-style tensor
                                       # parallel (parallel/tp.py)
    mesh_axes: Optional[Sequence[str]] = None   # names for mesh_shape's axes,
                                       # from {data, model, space}; defaults
                                       # preserve the legacy meanings above.
                                       # "space" shards ACTIVATIONS on image
                                       # height (spatial parallelism): params
                                       # replicated, GSPMD inserts conv halo
                                       # exchanges — exact (no tiling seams)
                                       # high-res restore across chips

    # ---- derived (filled by finalize) ----
    sigma: float = dataclasses.field(default=0.001, init=False)
    result_name: str = dataclasses.field(default="", init=False)
    model_zoo: str = dataclasses.field(default="", init=False)
    testsets: str = dataclasses.field(default="", init=False)
    results: str = dataclasses.field(default="", init=False)
    model_path: str = dataclasses.field(default="", init=False)
    L_path: str = dataclasses.field(default="", init=False)
    E_path: str = dataclasses.field(default="", init=False)

    def finalize(self) -> "TaskConfig":
        """Normalize units and derive paths (reference ``main_ddpir.py:135-159``)."""
        if self.task not in _VALID_TASKS:
            raise ValueError(f"task must be one of {_VALID_TASKS}, got {self.task!r}")
        if self.generate_mode not in _VALID_MODES:
            raise ValueError(f"generate_mode must be one of {_VALID_MODES}")
        if self.psnr_y_mode not in ("reference", "true"):
            raise ValueError("psnr_y_mode must be 'reference' or 'true'")
        if self.test_mode not in (0, 1, 2, 3, 4):
            raise ValueError("test_mode must be in 0..4")
        if self.mesh_axes is not None:
            axes = tuple(self.mesh_axes)
            if not set(axes) <= {"data", "model", "space"}:
                raise ValueError("mesh_axes entries must be from "
                                 f"{{data, model, space}}, got {axes}")
            if len(set(axes)) != len(axes):
                raise ValueError(f"mesh_axes must be unique, got {axes}")
            n_dims = 1 if self.mesh_shape is None else len(self.mesh_shape)
            if len(axes) != n_dims:
                raise ValueError(
                    f"mesh_axes {axes} must match mesh_shape "
                    f"{self.mesh_shape} ({n_dims} dims)")
        if self.model_output_type not in ("pred_xstart", "pred_x_prev"):
            # the reference drivers support exactly these two
            # (main_ddpir.py:137); a typo must not silently select the
            # pred_xstart pipeline with xprev-weighted rho
            raise ValueError("model_output_type must be 'pred_xstart' or "
                             f"'pred_x_prev', got {self.model_output_type!r}")
        # YAML carries /255 units (reference main_ddpir.py:138 divides unconditionally)
        self.noise_level_img = float(self.noise_level_img) / 255.0
        # the reference clobbers this with noise_level_img unconditionally
        # (main_ddpir.py:140; its YAMLs carry a sentinel string) — we keep
        # that default but honor an explicit numeric override (/255 units)
        self.noise_level_model = (
            self.noise_level_img if self.noise_level_model is None
            else float(self.noise_level_model) / 255.0)
        self.sigma = max(0.001, self.noise_level_img)
        if self.task == "deblur":
            # bug-parity: the reference overrides any configured kernel_std
            # for deblur (main_ddpir.py:151)
            self.kernel_std = 3.0 if self.blur_mode == "Gaussian" else 0.5
        if self.task == "inpaint" and self.generate_mode not in ("DiffPIR", "repaint", "vanilla"):
            raise ValueError("inpaint supports DiffPIR/repaint/vanilla generate modes")

        self.model_zoo = os.path.join(self.cwd, "model_zoo")
        self.testsets = os.path.join(self.cwd, "testsets")
        self.results = os.path.join(self.cwd, "results")
        name = (
            f"{self.testset_name}_{self.task}_{self.generate_mode}_{self.model_name}"
            f"_sigma{self.noise_level_img}_NFE{self.iter_num}_eta{self.eta}"
            f"_zeta{self.zeta}_lambda{self.lambda_}"
        )
        if self.task == "sr":
            name += f"_{self.sr_mode}{self.sf}"
        elif self.task == "deblur":
            name += f"_blurmode_{self.blur_mode}"
        elif self.task == "inpaint":
            name += f"_mask_type_{self.mask_type}"
        self.result_name = name
        self.model_path = os.path.join(self.model_zoo, self.model_name + ".pt")
        self.L_path = os.path.join(self.testsets, self.testset_name)
        self.E_path = os.path.join(self.results, self.result_name)
        return self

    @property
    def t_start_sigma(self) -> Optional[float]:
        """Start noise sigma, or None for 'max' (t_start = T-1, ``main_ddpir.py:197-200``)."""
        if self.noise_init_img == "max":
            return None
        return 2.0 * float(self.noise_init_img) / 255.0


# YAML 1.1 plain-scalar resolution, as PyYAML's SafeLoader applies it
_NULL = {"", "~", "null", "Null", "NULL"}
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_FALSE = {"no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"}
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?$"
                    r"|[-+]?\.[0-9_]+(?:[eE][-+][0-9]+)?$")
_SPECIAL_FLOAT = {".inf": float("inf"), ".Inf": float("inf"),
                  ".INF": float("inf"), "+.inf": float("inf"),
                  "+.Inf": float("inf"), "+.INF": float("inf"),
                  "-.inf": float("-inf"), "-.Inf": float("-inf"),
                  "-.INF": float("-inf"), ".nan": float("nan"),
                  ".NaN": float("nan"), ".NAN": float("nan")}
# plain scalars this reader does not resolve (octal, hex, binary,
# sexagesimal, timestamps) and characters that start YAML it does not parse
_UNSUPPORTED = re.compile(r"[-+]?0[0-9bxo]|[-+]?[0-9][0-9_]*:[0-5]?[0-9]"
                          r"|[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}")
_KEY = re.compile(r"[A-Za-z_][A-Za-z0-9_]*$")


def _strip_comment(line: str) -> str:
    """Drop a ``#`` comment that starts the line or follows whitespace,
    outside quotes."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _scalar(tok: str, where: str) -> Any:
    tok = tok.strip()
    if len(tok) >= 2 and tok[0] == tok[-1] == "'":
        inner = tok[1:-1]
        if "'" in inner.replace("''", ""):
            raise ValueError(f"{where}: malformed quoted string {tok!r}")
        return inner.replace("''", "'")
    if len(tok) >= 2 and tok[0] == tok[-1] == '"':
        inner = tok[1:-1]
        if "\\" in inner or '"' in inner:
            raise ValueError(f"{where}: escapes in double-quoted strings are "
                             f"not supported: {tok!r}")
        return inner
    if tok and (tok[0] in "'\"[]{}&*!|>%@`," or tok.startswith("- ")):
        raise ValueError(f"{where}: unsupported YAML value {tok!r}")
    if tok in _NULL:
        return None
    if tok in _TRUE:
        return True
    if tok in _FALSE:
        return False
    if tok in _SPECIAL_FLOAT:
        return _SPECIAL_FLOAT[tok]
    if _INT.match(tok):
        return int(tok.replace("_", ""))
    if _FLOAT.match(tok):
        return float(tok.replace("_", ""))
    if _UNSUPPORTED.match(tok):
        raise ValueError(f"{where}: unsupported YAML scalar {tok!r}")
    return tok


def read_flat_yaml(text: str) -> dict:
    """Parse a flat ``key: value`` YAML mapping with the standard library.

    Accepts plain scalars (null, bool, int, float and strings resolved as
    PyYAML's ``safe_load`` resolves them), single- and double-quoted strings
    without escapes, inline ``[a, b]`` lists of such scalars, blank lines and
    ``#`` comments.  Anything else (nesting, block lists, flow mappings,
    anchors, multi-line scalars, several documents) raises ``ValueError``.
    """
    out: dict = {}
    for n, raw in enumerate(text.splitlines(), 1):
        where = f"line {n}"
        line = _strip_comment(raw).rstrip()
        if not line.strip():
            continue
        if line[0] in " \t":
            raise ValueError(f"{where}: nested YAML is not supported: {raw!r}")
        if line in ("---", "...") or line.startswith("- "):
            raise ValueError(f"{where}: unsupported YAML: {raw!r}")
        key, sep, value = line.partition(":")
        if not sep or not _KEY.match(key) or (value and value[0] not in " \t"):
            raise ValueError(f"{where}: expected 'key: value', got {raw!r}")
        if key in out:
            raise ValueError(f"{where}: duplicate key {key!r}")
        value = value.strip()
        if value.startswith("["):
            if not value.endswith("]"):
                raise ValueError(f"{where}: unterminated list {value!r}")
            inner = value[1:-1].strip()
            out[key] = ([] if not inner else
                        [_scalar(tok, where) for tok in inner.split(",")])
        else:
            out[key] = _scalar(value, where)
    return out


def load_config(path: str | None = None, overrides: dict | None = None) -> TaskConfig:
    """Load a reference-format YAML config and apply dict overrides.

    Unknown YAML keys are rejected to catch typos.
    """
    data: dict = {}
    if path is not None:
        with open(path) as f:
            data = read_flat_yaml(f.read())
    # reference YAMLs carry the literal string 'noise_level_img' here; drop
    # only that sentinel — an explicit numeric value is a real override
    if data.get("noise_level_model") == "noise_level_img":
        data.pop("noise_level_model")
    if overrides:
        data.update(overrides)
    field_names = {f.name for f in dataclasses.fields(TaskConfig) if f.init}
    unknown = set(data) - field_names
    if unknown:
        raise ValueError(f"unknown config keys: {sorted(unknown)}")
    return TaskConfig(**data).finalize()


def parse_overrides(pairs: list[str]) -> dict:
    """``--set KEY=VALUE`` arguments -> overrides; a VALUE is parsed as JSON
    when it can be, else kept as a string."""
    overrides = {}
    for kv in pairs:
        k, _, v = kv.partition("=")
        try:
            v = json.loads(v)
        except json.JSONDecodeError:
            pass
        overrides[k] = v
    return overrides
