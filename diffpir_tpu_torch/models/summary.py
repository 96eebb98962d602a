"""Model introspection: parameter counts and per-tensor statistics.

Port of ``diffpir_tpu/models/summary.py`` (reference
``utils/utils_model.py:279-346``: ``describe_model``, ``describe_params``).
``params`` is a module or a mapping of parameter name -> tensor or array,
such as a state dict or ``zoo.torch_to_flax``'s flat parameters; names are
listed in sorted order, as the JAX package's pytree flattening lists them.
"""

from __future__ import annotations

from typing import Any, Mapping, Union

import numpy as np
import torch

__all__ = ["count_params", "describe_model", "describe_params"]

Params = Union[torch.nn.Module, Mapping[str, Any]]


def _named(params: Params) -> dict:
    if isinstance(params, torch.nn.Module):
        params = dict(params.named_parameters())
    return {k: params[k] for k in sorted(params)}


def _array(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().double().numpy()
    return np.asarray(v, np.float64)


def count_params(params: Params) -> int:
    return sum(int(np.prod(np.shape(v))) for v in _named(params).values())


def describe_model(params: Params, name: str = "model") -> str:
    return (f"model name: {name}\n"
            f"params number: {count_params(params)}\n"
            f"params tensors: {len(_named(params))}\n")


def describe_params(params: Params) -> str:
    lines = [" | {:^6s} | {:^6s} | {:^6s} | {:^6s} || {:<40s}".format(
        "mean", "min", "max", "std", "param_name")]
    for name, v in _named(params).items():
        a = _array(v)
        lines.append(" | {:>6.3f} | {:>6.3f} | {:>6.3f} | {:>6.3f} || {:s}".format(
            a.mean(), a.min(), a.max(), a.std(), name))
    return "\n".join(lines)
