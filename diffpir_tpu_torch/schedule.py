"""Diffusion noise schedules, timestep respacing, and per-trajectory plans.

Numpy-only copy of ``diffpir_tpu/schedule.py`` for the PyTorch port.  The
whole schedule is one immutable host-side object (float64 numpy), and every
quantity the sampling loop needs is precomputed into dense per-step tables
(`TrajectoryPlan`), so the per-step loop reads Python scalars and never
synchronises with the device.  The tables must equal the JAX package's
``build_plan`` exactly (``tests/test_torch_schedule.py``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np

__all__ = [
    "NoiseSchedule",
    "TrajectoryPlan",
    "space_timesteps",
    "find_nearest",
    "make_seq",
    "build_plan",
    "make_progress_slots",
]


def make_progress_slots(n_steps: int, max_snapshots: int = 10) -> np.ndarray:
    """Step -> snapshot-slot map (or -1), the reference's ``progress_seq``
    policy: every len//10-th step plus the final one (``main_ddpir.py:336-338``)."""
    stride = max(n_steps // max_snapshots, 1)
    slots = np.full((n_steps,), -1, np.int32)
    slot = 0
    for i in range(0, n_steps, stride):
        slots[i] = slot
        slot += 1
    if slots[n_steps - 1] < 0:
        slots[n_steps - 1] = slot
    return slots


def find_nearest(table: np.ndarray, value: float) -> int:
    """Index of the table entry nearest to `value` (ties -> lowest index).

    Semantics match reference ``utils/utils_model.py:202-205`` (np.argmin of the
    absolute difference), which decides which timesteps the denoiser sees.
    """
    table = np.asarray(table)
    return int(np.abs(table - value).argmin())


@dataclasses.dataclass(frozen=True)
class NoiseSchedule:
    """All derived quantities of a discrete-time Gaussian diffusion.

    Everything is float64 numpy on host (reference uses float64 inside
    ``GaussianDiffusion`` for accuracy, ``gaussian_diffusion.py:133``); cast at the
    point of device upload.  Indexing convention: index ``t`` is the forward
    diffusion timestep, ``0 <= t < num_timesteps``.
    """

    betas: np.ndarray  # (T,)

    def __post_init__(self):
        betas = np.asarray(self.betas, dtype=np.float64)
        if betas.ndim != 1 or not ((betas > 0).all() and (betas <= 1).all()):
            raise ValueError("betas must be 1-D in (0, 1]")
        object.__setattr__(self, "betas", betas)

    # ---- constructors -------------------------------------------------------

    @staticmethod
    def linear(beta_start: float, beta_end: float, num_timesteps: int) -> "NoiseSchedule":
        """Plain linear schedule (the entry-script variant, ``main_ddpir.py:184``)."""
        return NoiseSchedule(np.linspace(beta_start, beta_end, num_timesteps, dtype=np.float64))

    @staticmethod
    def named(name: str, num_timesteps: int) -> "NoiseSchedule":
        """Named schedules of reference ``gaussian_diffusion.py:18-62``."""
        if name == "linear":
            scale = 1000.0 / num_timesteps
            return NoiseSchedule.linear(scale * 0.0001, scale * 0.02, num_timesteps)
        if name == "cosine":
            def alpha_bar(t):
                return math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2

            betas = [
                min(1 - alpha_bar((i + 1) / num_timesteps) / alpha_bar(i / num_timesteps), 0.999)
                for i in range(num_timesteps)
            ]
            return NoiseSchedule(np.array(betas))
        raise ValueError(f"unknown beta schedule: {name}")

    # ---- derived tables (all cached lazily via properties on frozen data) ---

    @property
    def num_timesteps(self) -> int:
        return int(self.betas.shape[0])

    @property
    def alphas(self) -> np.ndarray:
        return 1.0 - self.betas

    @property
    def alphas_cumprod(self) -> np.ndarray:
        return np.cumprod(self.alphas, axis=0)

    @property
    def alphas_cumprod_prev(self) -> np.ndarray:
        return np.append(1.0, self.alphas_cumprod[:-1])

    @property
    def alphas_cumprod_next(self) -> np.ndarray:
        return np.append(self.alphas_cumprod[1:], 0.0)

    @property
    def sqrt_alphas_cumprod(self) -> np.ndarray:
        return np.sqrt(self.alphas_cumprod)

    @property
    def sqrt_one_minus_alphas_cumprod(self) -> np.ndarray:
        return np.sqrt(1.0 - self.alphas_cumprod)

    @property
    def log_one_minus_alphas_cumprod(self) -> np.ndarray:
        return np.log(1.0 - self.alphas_cumprod)

    @property
    def sqrt_recip_alphas_cumprod(self) -> np.ndarray:
        return np.sqrt(1.0 / self.alphas_cumprod)

    @property
    def sqrt_recipm1_alphas_cumprod(self) -> np.ndarray:
        return np.sqrt(1.0 / self.alphas_cumprod - 1.0)

    @property
    def reduced_alpha_cumprod(self) -> np.ndarray:
        """Equivalent noise sigma on the image, sqrt(1-acp)/sqrt(acp).

        This is the sigma<->t dictionary of the reference entry scripts
        (``main_ddpir.py:190``); monotonically increasing in t.
        """
        return self.sqrt_one_minus_alphas_cumprod / self.sqrt_alphas_cumprod

    # posterior q(x_{t-1} | x_t, x_0)  (gaussian_diffusion.py:153-169)
    @property
    def posterior_variance(self) -> np.ndarray:
        return self.betas * (1.0 - self.alphas_cumprod_prev) / (1.0 - self.alphas_cumprod)

    @property
    def posterior_log_variance_clipped(self) -> np.ndarray:
        pv = self.posterior_variance
        return np.log(np.append(pv[1], pv[1:]))

    @property
    def posterior_mean_coef1(self) -> np.ndarray:
        return self.betas * np.sqrt(self.alphas_cumprod_prev) / (1.0 - self.alphas_cumprod)

    @property
    def posterior_mean_coef2(self) -> np.ndarray:
        return (1.0 - self.alphas_cumprod_prev) * np.sqrt(self.alphas) / (1.0 - self.alphas_cumprod)

    # ---- lookups ------------------------------------------------------------

    def sigma_to_t(self, sigma: float) -> int:
        """Timestep whose equivalent image-noise sigma is nearest to `sigma`.

        The lookup table is cast to float32 to reproduce the reference's
        float32 entry-script table (``main_ddpir.py:184-190``) argmin ties.
        """
        return find_nearest(self.reduced_alpha_cumprod.astype(np.float32), sigma)

    # ---- respacing ----------------------------------------------------------

    def respaced(self, use_timesteps: Sequence[int]) -> tuple["NoiseSchedule", np.ndarray]:
        """Rebuild betas over a kept subset of timesteps.

        Returns (new schedule over len(use_timesteps) steps, timestep_map) with
        the semantics of reference ``respace.py:63-86``: new_beta_i =
        1 - acp[kept_i]/acp[kept_{i-1}].
        """
        keep = set(int(t) for t in use_timesteps)
        acp = self.alphas_cumprod
        last = 1.0
        new_betas, tmap = [], []
        for t in range(self.num_timesteps):
            if t in keep:
                new_betas.append(1.0 - acp[t] / last)
                last = acp[t]
                tmap.append(t)
        return NoiseSchedule(np.array(new_betas)), np.array(tmap, dtype=np.int32)


def space_timesteps(num_timesteps: int, section_counts) -> set:
    """Uniform-per-section respacing incl. "ddimN" strings.

    Behavioral parity with reference ``respace.py:7-60``.
    """
    if isinstance(section_counts, str):
        if section_counts.startswith("ddim"):
            desired = int(section_counts[len("ddim"):])
            for stride in range(1, num_timesteps):
                if len(range(0, num_timesteps, stride)) == desired:
                    return set(range(0, num_timesteps, stride))
            raise ValueError(f"cannot create exactly {desired} steps with an integer stride")
        section_counts = [int(x) for x in section_counts.split(",")]
    size_per = num_timesteps // len(section_counts)
    extra = num_timesteps % len(section_counts)
    start, steps = 0, []
    for i, count in enumerate(section_counts):
        size = size_per + (1 if i < extra else 0)
        if size < count:
            raise ValueError(f"cannot divide section of {size} steps into {count}")
        stride = 1 if count <= 1 else (size - 1) / (count - 1)
        cur = 0.0
        for _ in range(count):
            steps.append(start + round(cur))
            cur += stride
        start += size
    return set(steps)


def make_seq(num_train_timesteps: int, iter_num: int, skip_type: str = "quad") -> list[int]:
    """NFE sub-sequence of base timestep *ranks* (ascending).

    Parity with reference ``main_ddpir.py:326-335``: element ``s`` of the result
    corresponds to base timestep ``T-1-s`` (the loop walks s ascending, i.e. t
    descending from t_start).
    """
    if skip_type == "uniform":
        skip = num_train_timesteps // iter_num
        seq = [i * skip for i in range(iter_num)]
        if skip > 1:
            seq.append(num_train_timesteps - 1)
    elif skip_type == "quad":
        seq = np.sqrt(np.linspace(0, num_train_timesteps**2, iter_num))
        seq = [int(s) for s in list(seq)]
        seq[-1] = seq[-1] - 1
    else:
        raise ValueError(f"unknown skip_type: {skip_type}")
    return seq


@dataclasses.dataclass(frozen=True)
class TrajectoryPlan:
    """Dense per-step tables for one DiffPIR trajectory (host-precomputed).

    Shapes are all (n_steps,) float32/int32/bool numpy; the sampling loop
    reads one row per step.  Built from the same formulas the reference evaluates
    per step on host (``main_ddpir.py:274-286, 341-356, 448-456``).
    """

    t: np.ndarray              # int32, base timestep t_i of each step (descending)
    t_prev: np.ndarray         # int32, t_{i-1} of the renoise target (last entry unused)
    sqrt_acp_t: np.ndarray     # sqrt(alphas_cumprod[t_i])
    sqrt_1m_acp_t: np.ndarray  # sqrt(1 - alphas_cumprod[t_i])
    sqrt_acp_prev: np.ndarray
    sqrt_1m_acp_prev: np.ndarray
    rho: np.ndarray            # prox weight rho_t = lambda*sigma_y^2/sigma_bar_t^2
    eta_sigma: np.ndarray      # eta * sqrt_1m_acp_prev/sqrt_1m_acp_t * sqrt(beta_t)
    renoise: np.ndarray        # bool, whether the DDIM-like renoise applies (False on last step)
    prox: np.ndarray           # bool, whether the data prox applies (False on last step / low-noise skip)
    sigma: np.ndarray          # equivalent image noise sigma at t_i (for logging/DPS)

    @property
    def n_steps(self) -> int:
        return int(self.t.shape[0])


def build_plan(
    schedule: NoiseSchedule,
    *,
    iter_num: int,
    skip_type: str = "quad",
    lambda_: float = 1.0,
    eta: float = 0.0,
    sigma_y: float = 0.05,
    t_start: int | None = None,
    noise_model_t: int = 0,
    rho_mode: str = "xstart",
) -> TrajectoryPlan:
    """Precompute the whole trajectory's scalar tables.

    Mirrors the per-step host math of reference ``main_ddpir.py``:
      * rho_t = lambda * sigma_y^2 / sigma_bar_t^2, sigma_bar_t = sqrt(1-acp_t)/sqrt(acp_t)
        (``main_ddpir.py:274-286``; sigma_y floored at 1e-3 as in ``:141``)
      * seq -> t_i = T-1-seq[i] (exact-match find_nearest, ``:341-344``)
      * steps with t_i > t_start are dropped (``:346-347``)
      * eta_sigma of the renoise step (``:454``)
      * prox disabled when the model noise floor is reached (``:391``) and on the
        final step (``:384``); renoise disabled on the final step (``:448``).
    """
    T = schedule.num_timesteps
    if t_start is None:
        t_start = T - 1
    sigma_y = max(1e-3, float(sigma_y))

    seq = make_seq(T, iter_num, skip_type)
    ts = [T - 1 - s for s in seq]
    keep = [(j, t_i) for j, t_i in enumerate(ts) if t_i <= t_start]

    acp = schedule.alphas_cumprod
    betas = schedule.betas
    reduced = schedule.reduced_alpha_cumprod

    rows = []
    for j, t_i in keep:
        is_last = seq[j] == seq[-1]
        t_im1 = T - 1 - seq[j + 1] if not is_last else t_i
        sqrt_acp_t = math.sqrt(acp[t_i])
        sqrt_1m_acp_t = math.sqrt(1.0 - acp[t_i])
        sqrt_acp_prev = math.sqrt(acp[t_im1])
        sqrt_1m_acp_prev = math.sqrt(1.0 - acp[t_im1])
        sigma_bar = reduced[t_i]
        if rho_mode == "xprev":
            # non-(DiffPIR & pred_xstart) branch: sigma_k = sqrt(beta_t/alpha_t)
            # (main_ddpir.py:282-283)
            sigma_k2 = betas[t_i] / (1.0 - betas[t_i])
        else:
            sigma_k2 = sigma_bar**2
        rho = lambda_ * (sigma_y**2) / sigma_k2
        eta_sigma = eta * sqrt_1m_acp_prev / sqrt_1m_acp_t * math.sqrt(betas[t_i])
        # loop index j tracks the reference's `i < T - noise_model_t` gate
        # (main_ddpir.py:391).  Note the comparison is loop-index vs
        # T-noise_model_t, so with iter_num <= ~880 it never fires for any
        # realistic noise level; the reference's pred_x_prev fallback behind it
        # (main_ddpir.py:407-413) is therefore effectively dead code, and this
        # plan models the gate as a prox-skip only.
        prox = (not is_last) and (j < T - noise_model_t)
        rows.append(
            (t_i, t_im1, sqrt_acp_t, sqrt_1m_acp_t, sqrt_acp_prev, sqrt_1m_acp_prev,
             rho, eta_sigma, not is_last, prox, sigma_bar)
        )

    cols = list(zip(*rows))
    f32 = lambda c: np.asarray(c, dtype=np.float32)
    return TrajectoryPlan(
        t=np.asarray(cols[0], dtype=np.int32),
        t_prev=np.asarray(cols[1], dtype=np.int32),
        sqrt_acp_t=f32(cols[2]),
        sqrt_1m_acp_t=f32(cols[3]),
        sqrt_acp_prev=f32(cols[4]),
        sqrt_1m_acp_prev=f32(cols[5]),
        rho=f32(cols[6]),
        eta_sigma=f32(cols[7]),
        renoise=np.asarray(cols[8], dtype=bool),
        prox=np.asarray(cols[9], dtype=bool),
        sigma=f32(cols[10]),
    )
