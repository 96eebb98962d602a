"""Timestep importance samplers for diffusion training.

Port of ``diffpir_tpu/train/samplers.py`` (reference
``guided_diffusion/resample.py``):

  * ``uniform_sample`` == ``UniformSampler`` (``resample.py:61-67``);
  * ``LossSecondMomentState`` and its functions == ``LossSecondMomentResampler``
    (``resample.py:124-154``): per timestep the last ``history_len`` losses,
    weights sqrt(E[loss^2]) mixed with ``uniform_prob`` uniform mass.

The state lives on the training device; the update is a pure function of
(state, t, losses) that inserts the batch's losses one by one in batch
order, so a timestep drawn twice in a batch takes both, in that order.
Draws come from a ``torch.Generator``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["uniform_sample", "LossSecondMomentState", "loss_aware_init",
           "loss_aware_sample", "importance_weights", "loss_aware_update"]


def uniform_sample(batch: int, num_timesteps: int, generator: torch.Generator,
                   device=None):
    """(t int64, weights fp32): uniform timesteps, unit importance weights."""
    device = generator.device if device is None else device
    t = torch.randint(0, num_timesteps, (batch,), generator=generator, device=device)
    return t, torch.ones((batch,), dtype=torch.float32, device=device)


class LossSecondMomentState(NamedTuple):
    history: torch.Tensor     # (T, history_len) float32
    counts: torch.Tensor      # (T,) int32


def loss_aware_init(num_timesteps: int, history_len: int = 10,
                    device=None) -> LossSecondMomentState:
    return LossSecondMomentState(
        history=torch.zeros((num_timesteps, history_len), dtype=torch.float32,
                            device=device),
        counts=torch.zeros((num_timesteps,), dtype=torch.int32, device=device))


def _weights(state: LossSecondMomentState, uniform_prob: float = 0.001) -> torch.Tensor:
    T, H = state.history.shape
    warmed = (state.counts == H).all()
    w = torch.sqrt(torch.mean(state.history ** 2, dim=-1))
    w = torch.where(warmed, w, torch.ones_like(w))
    w = w / w.sum()
    return w * (1 - uniform_prob) + uniform_prob / T


def loss_aware_sample(state: LossSecondMomentState, batch: int,
                      generator: torch.Generator, uniform_prob: float = 0.001):
    """(t int64, importance weights 1/(T p[t]))."""
    p = _weights(state, uniform_prob)
    t = torch.multinomial(p, batch, replacement=True, generator=generator)
    return t, 1.0 / (p.shape[0] * p[t])


def importance_weights(state: LossSecondMomentState, t: torch.Tensor,
                       uniform_prob: float = 0.001) -> torch.Tensor:
    """1/(T p[t]) for timesteps ``t`` drawn elsewhere (``loss_aware_sample``'s
    weights for the same ``t``)."""
    p = _weights(state, uniform_prob)
    return 1.0 / (p.shape[0] * p[t.long()])


def loss_aware_update(state: LossSecondMomentState, t: torch.Tensor,
                      losses: torch.Tensor) -> LossSecondMomentState:
    """Insert each (t, loss) of the batch into its timestep's ring history:
    appended while the row fills, then the row shifts left by one."""
    history, counts = state.history.clone(), state.counts.clone()
    H = history.shape[1]
    slots = torch.arange(H, device=history.device)
    for ti, loss in zip(t.long(), losses.float()):
        row, cnt = history[ti], counts[ti]
        full = torch.cat([row[1:], loss[None]])
        grow = torch.where(slots == cnt.clamp_max(H - 1), loss, row)
        history[ti] = torch.where(cnt == H, full, grow)
        counts[ti] = (cnt + 1).clamp_max(H)
    return LossSecondMomentState(history, counts)
